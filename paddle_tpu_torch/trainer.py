"""Event-driven trainer (counterpart of ``paddle_tpu/trainer.py``):
``Trainer.__init__`` appends the backward and optimizer ops
(``optimizer.minimize``), ``train`` runs the startup program once and
then every batch of the reader through the Executor, firing
``BeginPass``, ``BeginIteration``, ``EndIteration`` and ``EndPass`` into
the handler. Every step runs the Executor's compiled path (a CUDA graph
replayed from the third step on; ``core/executor.py``). With
``pipeline=True`` (default ``FLAGS.pipeline``) a feed thread prepares
the next batch on the card while the step runs and the fetches stay on
the card as :class:`~paddle_tpu_torch.core.executor.AsyncFetch`
handles until a real sync point: the handler reading ``.cost`` or
``.metrics``, the progress line, the end of the pass. Losses are
bit-identical to the synchronous mode; ``check_nan_inf`` forces it.

Checkpoints (``paddle_tpu/trainer.py:109-235``): with ``checkpoint_dir``
the first ``train`` or ``test`` restores the newest state found there
after the startup program (a manifest checkpoint, a retention root of
``ckpt-<step>`` directories, or flat persistables files: the newest
wins), every pass ends with ``save_checkpoint``, and a SIGTERM (or
``request_preempt()`` from another thread or a handler) lets the running
batch finish, writes a synchronous checkpoint within the
``PADDLE_TPU_GRACE_SEC`` budget (a durable ``preempt_truncated`` event
when it cannot fit) and returns; the handler in place before ``train``
is restored. A restore installs through ``scope.set_var``, and the
compiled step copies the new values into its captured tensors before
its next replay. ``test`` averages the fetches over a reader on the
program pruned for test (no backward, no optimizer, ``batch_norm`` on
its running statistics), synchronous or pipelined;
``save_inference_model`` exports the pruned program.

Two loop-level failure policies (``paddle_tpu/trainer.py:318-530``),
both off by default. ``FLAGS.step_timeout_s`` arms the step watchdog
(:class:`~paddle_tpu_torch.resilience.watchdog.StepWatchdog`): armed at
each pass start, so the deadline covers the first batch's feed, warm-up
and capture; pinged at each batch, at the guardrail's sync point and at
the progress line; paused around a rewind and at the pass end. A wedged
step writes a durable ``step_hung`` event and the profiler's timeline
and exits 75. Before it arms the deadline ``train`` pays the process's
one-time costs that are not a step's: on a CUDA device it builds every
kernel library (``kernels/_build.build_all``, a hash check when they
exist), and it makes the process's first ``torch.autograd.grad``
(``ops/generic_grad.warm_up``: torch's lazy symbolic-shape import,
seconds), so neither counts against a step (ROADMAP.md Queue 3 #25). ``FLAGS.loss_skip_budget`` arms the numeric guardrails
(:class:`~paddle_tpu_torch.resilience.guardrails.NumericGuard`): each
batch's loss is materialized (a declared sync point under the
pipeline); a non-finite loss, or one past ``FLAGS.loss_spike_factor``
times the running median, skips the batch (its cost stays out of the
pass metrics), and budget exhaustion rewinds to the newest checkpoint
in ``checkpoint_dir`` once a window (``_guard_rewind``) before giving up
with ``FloatingPointError``. A rewind installs through
``scope.set_var``, after the card has finished the step, and the
compiled step copies the restored values into its captured tensors
before its next replay: no recapture. A pass that ends with a skipped
batch's update possibly still in the parameters records
``checkpoint_skipped_tainted`` and keeps the last clean save, a
preemption included. ``fault_point("trainer.step")`` runs before each
step; ``profiler.timer("pass")`` / ``timer("batch")`` time the loop.

Not ported yet: ``train(elastic=True)`` (the elastic worker needs a
mesh, ``comm`` and the task master: ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np

from . import io as _io
from . import profiler as _prof
from .core import ir
from .core.executor import Executor
from .data_feeder import DataFeeder
from .device import DEFAULT_DEVICE
from .flags import FLAGS
from .pipeline import FeedPipeline, materialize, materialize_scalar
from .resilience.events import record_durable_event, record_event
from .resilience.faults import fault_point
from .resilience.guardrails import NumericGuard
from .resilience.watchdog import StepWatchdog

__all__ = ["BeginIteration", "BeginPass", "EndIteration", "EndPass",
           "Trainer"]


class BeginPass(object):
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(object):
    def __init__(self, pass_id, metrics=None):
        self.pass_id = pass_id
        self.metrics = metrics or {}


class BeginIteration(object):
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(object):
    """``cost`` is the batch's loss as a float; ``metrics["fetches"]``
    the other fetches as numpy arrays. Under the pipeline both hold lazy
    handles until first read (``paddle_tpu/trainer.py:44``): a handler
    that never reads them costs no sync."""

    def __init__(self, pass_id, batch_id, cost, metrics=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self._cost = cost
        self._metrics = metrics or {}

    @property
    def cost(self):
        self._cost = materialize_scalar(self._cost)
        return self._cost

    @cost.setter
    def cost(self, value):
        self._cost = value

    @property
    def metrics(self):
        self._metrics = {k: materialize(v) for k, v in self._metrics.items()}
        return self._metrics

    @metrics.setter
    def metrics(self, value):
        self._metrics = value or {}


class Trainer(object):
    """Drive a built program over a reader with events::

        trainer = Trainer(cost=avg_cost, optimizer=optimizer.Adam(1e-3),
                          feed_list=[x, y], device="cuda",
                          checkpoint_dir="ckpt")
        trainer.train(reader, num_passes=2, event_handler=handler)
        trainer.test(test_reader)
    """

    def __init__(self, cost, optimizer, feed_list, device=DEFAULT_DEVICE,
                 fetch_list=None, main_program=None, startup_program=None,
                 checkpoint_dir=None):
        self.cost = cost
        self.main_program = main_program or ir.default_main_program()
        self.startup_program = startup_program or \
            ir.default_startup_program()
        self.optimizer = optimizer
        with ir.program_guard(self.main_program, self.startup_program):
            optimizer.minimize(cost)
        self.exe = Executor(device)
        self.feeder = DataFeeder(feed_list, device=self.exe.device,
                                 program=self.main_program)
        self.fetch_list = [cost] + list(fetch_list or [])
        self.checkpoint_dir = checkpoint_dir
        self._initialized = False
        # the last pipelined pass's FeedPipeline.stats (None before one)
        self.pipeline_stats = None
        # set by the SIGTERM hook or request_preempt(); train() finishes
        # the running batch, writes a checkpoint and returns
        self.preempted = False
        self._preempt_at = None      # monotonic time of the request
        self._grace_sec = None       # the launcher's drain window
        self._last_ckpt_secs = None  # how long the last save took
        self._test_cache = None

    def _maybe_init(self, load=True):
        """Run the startup program once, then (``load``) restore from
        ``checkpoint_dir``."""
        if self._initialized:
            return
        self.exe.run(self.startup_program)
        if load:
            self._load_checkpoint_state()
        self._initialized = True

    def _load_checkpoint_state(self):
        """Restore from ``checkpoint_dir``: a manifest checkpoint, the
        newest complete entry of a retention root, or the flat
        persistables files, whichever is newest. True when anything was
        loaded."""
        d = self.checkpoint_dir
        if not (d and os.path.isdir(d) and os.listdir(d)):
            return False
        from . import checkpoint as _ckpt
        if _ckpt._is_complete(d):
            # the manifest layout: save_checkpoint(sharded= or async_=)
            _ckpt.load_checkpoint(d, self.main_program,
                                  device=self.exe.device)
            return True
        newest = _ckpt.latest_checkpoint(d)
        files = [os.path.join(d, f) for f in os.listdir(d)
                 if os.path.isfile(os.path.join(d, f))]
        if newest is not None and (
                not files or os.path.getmtime(newest)
                >= max(os.path.getmtime(f) for f in files)):
            # a retention root, unless this trainer's own flat saves (a
            # pass end, a preemption) are newer than its newest entry
            _ckpt.load_latest(d, self.main_program, device=self.exe.device)
        else:
            _io.load_persistables(self.exe, d, main_program=self.main_program)
        return True

    def _install_preemption_hook(self):
        """SIGTERM sets the preempted flag, which the loop turns into a
        final checkpoint. Only the main thread may own a signal handler;
        elsewhere this installs nothing (``request_preempt()`` is the
        way there). Returns (installed, previous handler)."""
        grace = os.environ.get("PADDLE_TPU_GRACE_SEC")
        if grace:
            try:
                self._grace_sec = float(grace)
            except ValueError:
                self._grace_sec = None
        if threading.current_thread() is not threading.main_thread():
            return False, None

        def on_sigterm(signum, frame):
            self.request_preempt()

        try:
            return True, signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # an embedded interpreter
            return False, None

    def request_preempt(self):
        """Preempt the running ``train``: the SIGTERM hook's path, for a
        caller off the main thread or in an event handler."""
        self.preempted = True
        self._preempt_at = time.monotonic()

    def _preempt_checkpoint(self, pass_id, batch_id):
        """The drain's checkpoint, budgeted against the grace window:
        when the time left cannot fit the save (judged by the last
        save's duration) a durable ``preempt_truncated`` event lands
        first, and the save is still made (a kill mid-write leaves the
        previous checkpoint whole); a save that overran the window
        records the same event after it."""
        t0 = time.monotonic()
        remaining = None
        if self._grace_sec is not None and self._preempt_at is not None:
            remaining = self._grace_sec - (t0 - self._preempt_at)
        est = self._last_ckpt_secs
        truncated = remaining is not None and (
            remaining <= 0 or (est is not None and est * 1.2 > remaining))
        if truncated:
            _prof.update_trainer_counters(preempts_truncated=1)
            record_durable_event(
                "preempt_truncated", site="trainer.train", phase="pre",
                remaining_sec=round(remaining, 3), last_save_sec=est,
                pass_id=pass_id, batch_id=batch_id)
        self.save_checkpoint()
        took = time.monotonic() - t0
        if not truncated and remaining is not None and took > remaining:
            _prof.update_trainer_counters(preempts_truncated=1)
            record_durable_event(
                "preempt_truncated", site="trainer.train", phase="post",
                overran_sec=round(took - remaining, 3), pass_id=pass_id,
                batch_id=batch_id)
        record_event("preempt_checkpoint", site="trainer.train",
                     dirname=self.checkpoint_dir, pass_id=pass_id,
                     batch_id=batch_id)

    def _guard_rewind(self):
        """The numeric guardrail's rewind (``paddle_tpu/trainer.py:237``):
        reload the newest state from ``checkpoint_dir``; True when a
        restore happened. The guard has just materialized the step's
        loss; on the card the load also waits for the stream, so the
        restored tensors replace the state only after every launched
        step, and the next replay copies them in first."""
        if not self.checkpoint_dir:
            return False
        if self.exe.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.exe.device)
        return self._load_checkpoint_state()

    def train(self, reader, num_passes=1, event_handler=None, pipeline=None,
              pipeline_depth=None):
        """``num_passes`` passes over ``reader`` (a batched reader). Every
        ``FLAGS.log_period`` batches a progress line is printed.
        ``pipeline`` / ``pipeline_depth`` (defaults ``FLAGS.pipeline`` /
        ``FLAGS.pipeline_depth``) run the feed pipeline (module
        docstring). With ``checkpoint_dir`` each pass ends with a
        checkpoint and a preemption ends the run after its batch with
        one. ``FLAGS.step_timeout_s`` arms the step watchdog and
        ``FLAGS.loss_skip_budget`` the numeric guardrails (module
        docstring)."""
        self._maybe_init()
        handler = event_handler or (lambda e: None)
        log_period = FLAGS.log_period
        use_pipe = FLAGS.pipeline if pipeline is None else bool(pipeline)
        depth = int(pipeline_depth if pipeline_depth is not None
                    else FLAGS.pipeline_depth)
        if use_pipe and (depth < 1 or self.exe.check_nan_inf):
            # the NaN/Inf scan needs the synchronous per-op path
            use_pipe = False
        watchdog = None
        if FLAGS.step_timeout_s > 0:
            # a step's deadline counts neither an nvcc build nor the
            # process's first autograd import (Queue 3 #25)
            if self.exe.device.type == "cuda":
                from .kernels import _build
                _build.build_all()
            from .ops import generic_grad
            generic_grad.warm_up()
            watchdog = StepWatchdog(FLAGS.step_timeout_s)
        guard = None
        if FLAGS.loss_skip_budget > 0:

            def rewind_fn():
                # a checkpoint restore is recovery, not a step: the step
                # deadline pauses around it as around a save
                if watchdog is not None:
                    watchdog.disarm()
                try:
                    return self._guard_rewind()
                finally:
                    if watchdog is not None:
                        watchdog.arm("guard-rewind")

            guard = NumericGuard(FLAGS.loss_skip_budget,
                                 spike_factor=FLAGS.loss_spike_factor,
                                 rewind_fn=rewind_fn)
        # a fresh train() starts unpreempted
        self.preempted = False
        self._preempt_at = None
        hook_installed, old_sigterm = False, None
        if self.checkpoint_dir:
            hook_installed, old_sigterm = self._install_preemption_hook()
        try:
            for pass_id in range(num_passes):
                handler(BeginPass(pass_id))
                if watchdog is not None:
                    # the deadline covers the first batch's feed, warm-up
                    # and capture: a reader wedged before its first batch
                    # is a hang too
                    watchdog.arm("pass%d/start" % pass_id)
                with _prof.timer("pass"):
                    costs, batch_id = self._train_pass(
                        reader, pass_id, handler, log_period, use_pipe,
                        depth, watchdog, guard)
                # the pass's end is a sync point, and it comes before every
                # checkpoint: a pipelined pass's fetches are resolved here
                costs = [materialize_scalar(c) for c in costs]
                if watchdog is not None:
                    watchdog.disarm()
                # a skipped batch's update may still sit in the parameters
                # until a rewind or an accepted batch clears it: saving
                # that state would make the poison the newest resume point
                tainted = guard is not None and guard.tainted
                if tainted and self.checkpoint_dir:
                    record_durable_event(
                        "checkpoint_skipped_tainted", site="trainer.guard",
                        pass_id=pass_id, batch_id=batch_id,
                        preempted=self.preempted)
                if self.preempted:
                    if self.checkpoint_dir and not tainted:
                        self._preempt_checkpoint(pass_id, batch_id)
                    return
                if self.checkpoint_dir and not tainted:
                    self.save_checkpoint()
                handler(EndPass(pass_id, {"avg_cost": float(np.mean(costs))
                                          if costs else float("nan")}))
        finally:
            if watchdog is not None:
                watchdog.close()
            if hook_installed:
                signal.signal(signal.SIGTERM, old_sigterm)

    def _train_pass(self, reader, pass_id, handler, log_period, use_pipe,
                    depth, watchdog, guard):
        """One pass over ``reader``, stopping after the batch in which a
        preemption came: (the accepted costs, lazy under the pipeline
        unless the guard read them, and the last batch id)."""
        costs, batch_id, pipe = [], -1, None
        try:
            if use_pipe:
                pipe = batches = FeedPipeline(reader, self.feeder, self.exe,
                                              depth=depth)
            else:
                batches = reader()
            for batch_id, data in enumerate(batches):
                handler(BeginIteration(pass_id, batch_id))
                if watchdog is not None:
                    watchdog.ping("pass%d/batch%d" % (pass_id, batch_id))
                # a delay here is a wedged step (the watchdog's quarry), a
                # raise a step failure that leaves train()
                fault_point("trainer.step")
                with _prof.timer("batch"):
                    if use_pipe:
                        # data is a feed dict on the device already
                        outs = self.exe.run(self.main_program, feed=data,
                                            fetch_list=self.fetch_list,
                                            sync=False)
                        cost = outs[0]
                    else:
                        outs = self.exe.run(self.main_program,
                                            feed=self.feeder.feed(data),
                                            fetch_list=self.fetch_list)
                        cost = float(np.asarray(outs[0]).reshape(-1)[0])
                skipped = False
                if guard is not None:
                    # the guardrail's sync point: a wedged card surfaces
                    # here under the pipeline, inside the armed deadline
                    cost = materialize_scalar(cost)
                    skipped = guard.check(cost, pass_id=pass_id,
                                          batch_id=batch_id) != "ok"
                    if watchdog is not None:
                        watchdog.ping("pass%d/batch%d/guarded"
                                      % (pass_id, batch_id))
                if not skipped:
                    costs.append(cost)
                if log_period and (batch_id + 1) % log_period == 0:
                    window = [materialize_scalar(c)
                              for c in costs[-log_period:]]
                    if window:
                        print("pass %d batch %d: cost=%.6f (avg %.6f)"
                              % (pass_id, batch_id, window[-1],
                                 float(np.mean(window))))
                    if watchdog is not None:
                        watchdog.ping("pass%d/batch%d/log"
                                      % (pass_id, batch_id))
                handler(EndIteration(pass_id, batch_id, cost,
                                     {"fetches": outs[1:]}))
                if self.preempted:
                    break
        finally:
            if pipe is not None:
                pipe.close()
                self._merge_pipeline_stats(pipe)
        return costs, batch_id

    def _merge_pipeline_stats(self, pipe):
        """Fold one pass's feed-pipeline counters into Executor.stats and
        the profiler's pipeline section, and keep the pass's own
        (``pipeline_stats``: ``slot_reuse``, ``max_in_flight``,
        ``fallback_sync``, ...)."""
        self.pipeline_stats = dict(pipe.stats)
        st, es = pipe.stats, self.exe.stats
        es["feed_wait_ms"] += st["feed_wait_ms"]
        es["dispatch_depth"] = max(es["dispatch_depth"],
                                   st["max_in_flight"])
        _prof.update_pipeline_counters(
            feed_wait_ms=st["feed_wait_ms"],
            dispatch_depth=st["max_in_flight"],
            pipeline_batches=st["batches"],
            slot_reuse=st["slot_reuse"],
            fallback_sync=1 if st["fallback_sync"] else 0)

    def _test_program(self, fetches):
        """The main program pruned for test to ``fetches`` (no backward
        or optimizer op, so a test run updates nothing), cached per
        fetch list."""
        names = tuple(f.name if isinstance(f, ir.Variable) else f
                      for f in fetches)
        if self._test_cache is None or self._test_cache[0] != names:
            pruned = self.main_program.prune(
                feeds=list(self.feeder.feed_names), fetches=names)
            self._test_cache = (names, pruned)
        return self._test_cache[1]

    def test(self, reader, fetch_list=None, program=None, pipeline=None,
             pipeline_depth=None):
        """The mean of each fetch (default: the cost and ``fetch_list``
        of the constructor) over the batches of ``reader``, run on the
        test program. ``pipeline`` (default ``FLAGS.pipeline``) feeds
        through the feed pipeline and reads batch k's fetches while batch
        k + 1 runs; the result is bit-identical to the synchronous loop,
        which ``check_nan_inf`` forces."""
        self._maybe_init()
        fetches = fetch_list or self.fetch_list
        program = program or self._test_program(fetches)
        use_pipe = FLAGS.pipeline if pipeline is None else bool(pipeline)
        depth = int(pipeline_depth if pipeline_depth is not None
                    else FLAGS.pipeline_depth)
        if use_pipe and (depth < 1 or self.exe.check_nan_inf):
            use_pipe = False
        state = {"acc": None, "n": 0}

        def fold(outs):
            # a running sum: a long eval buffers no fetches
            vals = [materialize_scalar(o) for o in outs]
            state["acc"] = (vals if state["acc"] is None
                            else [a + v for a, v in zip(state["acc"], vals)])
            state["n"] += 1

        pipe = None
        try:
            if use_pipe:
                pipe = FeedPipeline(reader, self.feeder, self.exe,
                                    depth=depth)
                prev = None  # batch k - 1, read while batch k runs
                for data in pipe:
                    outs = self.exe.run(program, feed=data,
                                        fetch_list=fetches, sync=False)
                    if prev is not None:
                        fold(prev)
                    prev = outs
                if prev is not None:
                    fold(prev)
            else:
                for data in reader():
                    fold(self.exe.run(program, feed=self.feeder.feed(data),
                                      fetch_list=fetches))
        finally:
            if pipe is not None:
                pipe.close()
                self._merge_pipeline_stats(pipe)
        return [a / max(state["n"], 1) for a in (state["acc"] or [])]

    def save_checkpoint(self, dirname=None, sharded=False, async_=False,
                        step=None):
        """Save the persistables to ``dirname`` (default
        ``checkpoint_dir``): by default as ``io.save_persistables``
        files; ``sharded`` or ``async_`` through ``checkpoint.py`` (its
        manifest layout, the write on a thread with ``async_``, which
        returns the :class:`~paddle_tpu_torch.checkpoint.AsyncCheckpoint`
        handle)."""
        dirname = dirname or self.checkpoint_dir
        from . import checkpoint as _ckpt
        t0 = time.monotonic()
        try:
            if sharded or async_:
                return _ckpt.save_checkpoint(dirname, self.main_program,
                                             step=step, async_=async_)
            os.makedirs(dirname, exist_ok=True)
            # a manifest left in the directory would shadow this newer
            # save at the next restore, which prefers that layout
            for fn in (_ckpt._COMPLETE, _ckpt._MANIFEST):
                p = os.path.join(dirname, fn)
                if os.path.exists(p):
                    os.remove(p)
            _io.save_persistables(self.exe, dirname,
                                  main_program=self.main_program)
        finally:
            # the preemption's budget; an async save counts its
            # synchronous part, the device-to-host copy
            self._last_ckpt_secs = time.monotonic() - t0

    def save_inference_model(self, dirname, feeded_var_names, target_vars):
        """Export the program pruned to ``feeded_var_names`` and
        ``target_vars`` with the persistables it reads
        (``io.save_inference_model``)."""
        return _io.save_inference_model(dirname, feeded_var_names,
                                        target_vars, self.exe,
                                        main_program=self.main_program)
