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

Not ported yet: checkpoints and resume, preemption, the step watchdog
and numeric guardrails, elastic workers and ``test``.
"""
from __future__ import annotations

import numpy as np

from .core import ir
from .core.executor import Executor
from .data_feeder import DataFeeder
from .device import DEFAULT_DEVICE
from .flags import FLAGS
from .pipeline import FeedPipeline, materialize, materialize_scalar

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
                          feed_list=[x, y], device="cuda")
        trainer.train(reader, num_passes=2, event_handler=handler)
    """

    def __init__(self, cost, optimizer, feed_list, device=DEFAULT_DEVICE,
                 fetch_list=None, main_program=None, startup_program=None):
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
        self._initialized = False
        # the last pipelined pass's FeedPipeline.stats (None before one)
        self.pipeline_stats = None

    def _maybe_init(self):
        """Run the startup program once."""
        if not self._initialized:
            self.exe.run(self.startup_program)
            self._initialized = True

    def train(self, reader, num_passes=1, event_handler=None, pipeline=None,
              pipeline_depth=None):
        """``num_passes`` passes over ``reader`` (a batched reader). Every
        ``FLAGS.log_period`` batches a progress line is printed.
        ``pipeline`` / ``pipeline_depth`` (defaults ``FLAGS.pipeline`` /
        ``FLAGS.pipeline_depth``) run the feed pipeline (module
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
        for pass_id in range(num_passes):
            handler(BeginPass(pass_id))
            costs = []
            pipe = None
            try:
                if use_pipe:
                    pipe = batches = FeedPipeline(reader, self.feeder,
                                                  self.exe, depth=depth)
                else:
                    batches = reader()
                for batch_id, data in enumerate(batches):
                    handler(BeginIteration(pass_id, batch_id))
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
                    costs.append(cost)
                    if log_period and (batch_id + 1) % log_period == 0:
                        window = [materialize_scalar(c)
                                  for c in costs[-log_period:]]
                        print("pass %d batch %d: cost=%.6f (avg %.6f)"
                              % (pass_id, batch_id, window[-1],
                                 float(np.mean(window))))
                    handler(EndIteration(pass_id, batch_id, cost,
                                         {"fetches": outs[1:]}))
            finally:
                if pipe is not None:
                    pipe.close()
                    self._merge_pipeline_stats(pipe)
            # the pass's end is a sync point
            costs = [materialize_scalar(c) for c in costs]
            handler(EndPass(pass_id, {"avg_cost": float(np.mean(costs))
                                      if costs else float("nan")}))

    def _merge_pipeline_stats(self, pipe):
        """Fold one pass's feed-pipeline counters into Executor.stats and
        keep the pass's own (``pipeline_stats``: ``slot_reuse``,
        ``max_in_flight``, ``fallback_sync``, ...)."""
        self.pipeline_stats = dict(pipe.stats)
        st, es = pipe.stats, self.exe.stats
        es["feed_wait_ms"] += st["feed_wait_ms"]
        es["dispatch_depth"] = max(es["dispatch_depth"],
                                   st["max_in_flight"])
