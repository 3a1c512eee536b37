"""The Trainer's failure policies (``paddle_tpu_torch/trainer.py``,
``resilience/watchdog.py``, ``resilience/guardrails.py``) against the JAX
package's (``paddle_tpu/trainer.py:318-530``), on the CPU: the
one-process cases of ``tests/test_trainer_resilience.py``.

- The numeric guardrails: both Trainers build the tiny classifier of
  the JAX test (fc 8 tanh, fc 2 softmax, SGD), start from the JAX
  startup's state (``torch_book.init_from``) and take the same NaN and
  spike batches. They must give the same trail: the kinds, reasons,
  pass and batch ids, ``consecutive`` and ``budget`` of the
  ``batch_skipped`` events, the ``guard_rewind`` count, the
  ``checkpoint_skipped_tainted`` event and the ``FloatingPointError``;
  the profiler's ``batches_skipped`` / ``guard_rewinds`` alike. The
  accepted costs agree within 1e-5 relative (float32 on both sides,
  sums in other orders); a skipped batch's cost stays out of the pass
  metrics.
- A rewind into the compiled step (tiny_lm, Adam): a NaN written into a
  weight through the scope before batch 2 skips batches 2 and 3 and
  rewinds once, with no new step key; the accepted losses after the
  rewind equal, bit for bit, a rerun of those batches from the same
  checkpoint on the same Trainer, synchronous and pipelined, and the
  JAX package's within 1e-5.
- The step watchdog: driven with an injected ``on_hang`` that sets a
  ``threading.Event`` and a ``trainer.step`` delay that waits on that
  event, so no assertion depends on the clock beyond a generous bound;
  the rewind pauses the deadline (checked while it is paused); the
  ``train`` CLI under ``PADDLE_TPU_FLAGS=step_timeout_s`` and a seeded
  hang exits 75 from the monitor thread with its durable ``step_hung``
  line and a timeline artifact.
- The preemption drain's ``preempts_truncated`` counter, the three
  flags' defaults and their ``PADDLE_TPU_FLAGS`` spelling.
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu import profiler as jprof  # noqa: E402
from paddle_tpu import resilience as JR  # noqa: E402
from paddle_tpu import trainer as jtrainer_mod  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu.flags import FLAGS as JFLAGS  # noqa: E402
from paddle_tpu.flags import flags_guard as jflags_guard  # noqa: E402
from paddle_tpu.resilience import faults as jfaults  # noqa: E402
from paddle_tpu.resilience.watchdog import (  # noqa: E402
    StepWatchdog as JStepWatchdog)
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import profiler as tprof  # noqa: E402
from paddle_tpu_torch import resilience as TR  # noqa: E402
from paddle_tpu_torch import trainer as ttrainer_mod  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope, global_scope,  # noqa: E402
                                         scope_guard)
from paddle_tpu_torch.flags import FLAGS as TFLAGS  # noqa: E402
from paddle_tpu_torch.flags import flags_guard as tflags_guard  # noqa: E402
from paddle_tpu_torch.resilience import faults as tfaults  # noqa: E402
from paddle_tpu_torch.resilience.watchdog import (  # noqa: E402
    STEP_HUNG_EXIT, StepWatchdog)

import torch_book as book  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COST_REL_TOL = 1e-5

API = {
    "jax": types.SimpleNamespace(
        R=JR, prof=jprof, faults=jfaults, trainer_mod=jtrainer_mod,
        flags_guard=jflags_guard,
        scope=lambda: jpt.scope_guard(jpt.Scope())),
    "port": types.SimpleNamespace(
        R=TR, prof=tprof, faults=tfaults, trainer_mod=ttrainer_mod,
        flags_guard=tflags_guard, scope=lambda: scope_guard(Scope())),
}
PKGS = tuple(API)


@pytest.fixture(autouse=True)
def _clean_slate():
    for api in API.values():
        api.faults.reset()
        api.R.clear_events()
        api.prof.reset_trainer_counters()
    yield
    for api in API.values():
        api.faults.reset()
        api.R.clear_events()
        api.prof.reset_trainer_counters()


def _build(pkg, checkpoint_dir=None, linear=False, lr=0.1):
    """The JAX test's tiny classifier in ``pkg``, on fresh programs under
    the package's name guard. ``linear`` drops the tanh so that a scaled
    input gives a large but finite loss."""
    if pkg == "jax":
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            x = jlayers.data("x", shape=[4], dtype="float32")
            y = jlayers.data("y", shape=[1], dtype="int64")
            h = x if linear else jlayers.fc(x, size=8, act="tanh")
            pred = jlayers.fc(h, size=2, act="softmax")
            loss = jlayers.mean(jlayers.cross_entropy(pred, y))
            return jpt.Trainer(cost=loss, optimizer=jpt.SGD(learning_rate=lr),
                               feed_list=[x, y], place=jpt.CPUPlace(),
                               main_program=main, startup_program=start,
                               checkpoint_dir=checkpoint_dir)
    main, start = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, start):
        x = tlayers.data("x", shape=[4], dtype="float32")
        y = tlayers.data("y", shape=[1], dtype="int64")
        h = x if linear else tlayers.fc(x, size=8, act="tanh")
        pred = tlayers.fc(h, size=2, act="softmax")
        loss = tlayers.mean(tlayers.cross_entropy(pred, y))
        return ttrainer_mod.Trainer(
            cost=loss, optimizer=topt.SGD(learning_rate=lr),
            feed_list=[x, y], device="cpu", main_program=main,
            startup_program=start, checkpoint_dir=checkpoint_dir)


def _batches(n, nan_at=None, scale_at=None, scale=1e3, seed=0):
    """The JAX test's batches: ``nan_at`` puts a NaN in one input,
    ``scale_at`` makes a confidently wrong batch (a finite spike)."""
    def reader():
        rng = np.random.RandomState(seed)
        for i in range(n):
            bx = rng.rand(8, 4).astype("float32")
            if i == nan_at:
                bx = bx.copy()
                bx[0, 0] = np.nan
            by = (bx.sum(axis=1) > 2).astype("int64").reshape(-1, 1)
            if i == scale_at:
                bx = (bx * scale).astype("float32")
                by = 1 - by
            yield list(zip(bx, by))
    return reader


def _startup_state(linear=False):
    tr = _build("jax", linear=linear)
    return book.jax_startup_state(tr.main_program, tr.startup_program)


def _trail(api):
    """The guard's trail: (kind, reason, pass, batch, consecutive,
    budget) of every skip, (kind, reason, pass, batch, skips) of every
    rewind, and the tainted-checkpoint events."""
    out = []
    for e in api.R.events():
        if e["kind"] == "batch_skipped":
            out.append((e["kind"], e["reason"], e["pass_id"], e["batch_id"],
                        e["consecutive"], e["budget"]))
        elif e["kind"] == "guard_rewind":
            out.append((e["kind"], e["reason"], e["pass_id"], e["batch_id"],
                        e["skips"], e["budget"]))
        elif e["kind"] == "checkpoint_skipped_tainted":
            out.append((e["kind"], e["pass_id"], e["batch_id"],
                        e["preempted"]))
    return out


def _scenario(pkg, tmp_path, state, flags, reader, seed_batches=0,
              pipeline=False, linear=False, lr=0.1, checkpoint=True):
    """Run one guarded ``train`` in ``pkg`` from ``state`` (after
    ``seed_batches`` clean batches that write the rewind target):
    {"trail", "costs" [(batch, cost)] of the EndIteration events,
    "pass_costs" (EndPass avg_cost), "error", "counters"}."""
    api = API[pkg]
    ck = str(tmp_path / pkg) if checkpoint else None
    with api.scope():
        tr = _build(pkg, checkpoint_dir=ck, linear=linear, lr=lr)
        book.init_from(tr, pkg, state)
        if seed_batches:
            tr.train(_batches(seed_batches), num_passes=1)
        api.R.clear_events()
        api.prof.reset_trainer_counters()
        costs, ends, error = [], [], None

        def handler(e):
            if type(e).__name__ == "EndIteration":
                costs.append((e.batch_id, float(e.cost)))
            elif type(e).__name__ == "EndPass":
                ends.append(e.metrics["avg_cost"])

        try:
            with api.flags_guard(**flags):
                tr.train(reader, num_passes=1, event_handler=handler,
                         pipeline=pipeline, pipeline_depth=2)
        except FloatingPointError as e:
            error = e
    return {"trail": _trail(api), "costs": costs, "pass_costs": ends,
            "error": error, "counters": api.prof.trainer_counters()}


def _accepted(run):
    skipped = {t[3] for t in run["trail"] if t[0] == "batch_skipped"}
    return [(b, c) for b, c in run["costs"] if b not in skipped]


def _same_costs(got, want):
    assert [b for b, _ in got] == [b for b, _ in want]
    assert book.loss_rel([c for _, c in got], [c for _, c in want]) \
        <= COST_REL_TOL


def _both(tmp_path, **kw):
    state = _startup_state(linear=kw.get("linear", False))
    return {pkg: _scenario(pkg, tmp_path, state, **kw) for pkg in PKGS}


# -- the numeric guardrails in the Trainer, both packages ---------------------

@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
def test_nan_batch_is_skipped_and_rewound_like_jax(tmp_path, pipeline):
    runs = _both(tmp_path, flags={"loss_skip_budget": 2},
                 reader=_batches(8, nan_at=3), seed_batches=4,
                 pipeline=pipeline)
    port, jax = runs["port"], runs["jax"]
    assert port["trail"] == jax["trail"]
    # the NaN batch poisons the parameters, so the next batch skips too;
    # the exhausted budget rewinds and training recovers
    assert [t[:4] for t in port["trail"]] == [
        ("batch_skipped", "nonfinite", 0, 3),
        ("batch_skipped", "nonfinite", 0, 4),
        ("guard_rewind", "nonfinite", 0, 4)]
    assert port["error"] is None and jax["error"] is None
    _same_costs(_accepted(port), _accepted(jax))
    assert all(np.isfinite(c) for _, c in _accepted(port))
    # a skipped batch's cost stays out of the pass metrics
    acc = [c for _, c in _accepted(port)]
    assert port["pass_costs"] == [pytest.approx(float(np.mean(acc)),
                                                rel=1e-12)]
    assert book.loss_rel(port["pass_costs"], jax["pass_costs"]) \
        <= COST_REL_TOL
    assert port["counters"] == jax["counters"] == {
        "batches_skipped": 2.0, "guard_rewinds": 1.0}


def test_nan_without_a_checkpoint_gives_up_like_jax(tmp_path):
    runs = _both(tmp_path, flags={"loss_skip_budget": 1},
                 reader=_batches(6, nan_at=1), checkpoint=False)
    port, jax = runs["port"], runs["jax"]
    assert isinstance(port["error"], FloatingPointError)
    assert isinstance(jax["error"], FloatingPointError)
    assert str(port["error"]) == str(jax["error"])
    assert port["trail"] == jax["trail"] == [
        ("batch_skipped", "nonfinite", 0, 1, 1, 1)]
    _same_costs(_accepted(port), _accepted(jax))


def test_spike_is_skipped_without_a_rewind_like_jax(tmp_path):
    runs = _both(tmp_path, flags={"loss_skip_budget": 3,
                                  "loss_spike_factor": 10.0},
                 reader=_batches(8, scale_at=5, scale=100.0), linear=True,
                 lr=1e-4)
    port, jax = runs["port"], runs["jax"]
    assert port["trail"] == jax["trail"] == [
        ("batch_skipped", "spike", 0, 5, 1, 3)]
    _same_costs(_accepted(port), _accepted(jax))
    assert port["counters"] == jax["counters"] == {"batches_skipped": 1.0}


def test_guard_is_inert_by_default_like_jax(tmp_path):
    runs = _both(tmp_path, flags={}, reader=_batches(4, nan_at=2),
                 checkpoint=False)
    for run in runs.values():
        assert any(not np.isfinite(c) for _, c in run["costs"])
        assert run["trail"] == [] and run["counters"] == {}
    _same_costs([(b, c) for b, c in runs["port"]["costs"] if b < 2],
                [(b, c) for b, c in runs["jax"]["costs"] if b < 2])


def test_tainted_pass_end_keeps_the_last_clean_checkpoint_like_jax(
        tmp_path):
    state = _startup_state()
    for pkg in PKGS:
        api = API[pkg]
        with api.scope():
            tr = _build(pkg, checkpoint_dir=str(tmp_path / pkg))
            book.init_from(tr, pkg, state)
            tr.train(_batches(3), num_passes=1)       # the clean save
            api.R.clear_events()
            with api.flags_guard(loss_skip_budget=3):
                # NaN on the last batch: one skip within budget, and the
                # pass ends with the poisoned update in the parameters
                tr.train(_batches(4, nan_at=3), num_passes=1)
            assert _trail(api)[-1] == ("checkpoint_skipped_tainted", 0, 3,
                                       False)
            # the saved state is still the clean one
            assert tr._load_checkpoint_state() is True
            costs = []
            tr.train(_batches(3), num_passes=1,
                     event_handler=lambda e: costs.append(e.cost)
                     if type(e).__name__ == "EndIteration" else None)
            assert costs and all(np.isfinite(c) for c in costs)


def test_a_tainted_preemption_keeps_the_last_clean_checkpoint(tmp_path):
    """A preemption on a tainted pass records the event and writes no
    checkpoint, in both packages."""
    state = _startup_state()
    for pkg in PKGS:
        api = API[pkg]
        ck = tmp_path / pkg
        with api.scope():
            tr = _build(pkg, checkpoint_dir=str(ck))
            book.init_from(tr, pkg, state)
            tr.train(_batches(3), num_passes=1)
            mtimes = {f: os.path.getmtime(ck / f) for f in os.listdir(ck)}
            api.R.clear_events()

            def handler(e):
                if type(e).__name__ == "EndIteration" and e.batch_id == 1:
                    tr.request_preempt()

            with api.flags_guard(loss_skip_budget=3):
                tr.train(_batches(4, nan_at=1), num_passes=1,
                         event_handler=handler)
            assert _trail(api)[-1] == ("checkpoint_skipped_tainted", 0, 1,
                                       True)
            assert api.R.events(kind="preempt_checkpoint") == []
            assert {f: os.path.getmtime(ck / f)
                    for f in os.listdir(ck)} == mtimes


def test_preempt_truncated_counts_in_the_profiler_like_jax(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_GRACE_SEC", "0.001")
    state = _startup_state()
    for pkg in PKGS:
        api = API[pkg]
        with api.scope():
            tr = _build(pkg, checkpoint_dir=str(tmp_path / pkg))
            book.init_from(tr, pkg, state)
            tr.train(_batches(2), num_passes=1)
            api.R.clear_events()
            api.prof.reset_trainer_counters()
            tr._last_ckpt_secs = 30.0   # a save this window cannot fit

            def handler(e):
                if type(e).__name__ == "EndIteration" and e.batch_id == 1:
                    tr.request_preempt()

            tr.train(_batches(6), num_passes=1, event_handler=handler)
            trunc = api.R.events(kind="preempt_truncated")
            assert trunc and trunc[0]["phase"] == "pre"
            assert api.R.events(kind="preempt_checkpoint")
            assert api.prof.trainer_counters() == {"preempts_truncated": 1.0}


# -- a rewind into the compiled step ----------------------------------------

LM_BATCHES = 6
NAN_AT = 2


def _lm_rewind(pkg, tmp_path, state, pipeline):
    """tiny_lm (Adam) with a checkpoint: a clean pass of 3 batches that
    saves, then a pass of LM_BATCHES batches under loss_skip_budget=2
    with a NaN written into a weight through the scope before batch
    NAN_AT. Returns (losses by batch, trail, the Trainer's compiled
    step count before and after the rewind pass, the losses of
    batches 4-5 rerun from the checkpoint)."""
    api = API[pkg]
    with api.scope():
        tr, spec = book.make_trainer(pkg, "tiny_lm",
                                     checkpoint_dir=str(tmp_path / pkg))
        book.init_from(tr, pkg, state)
        batches = book.batches("tiny_lm", LM_BATCHES + 3)
        tr.train(book.reader_of(batches[:3]), num_passes=1,
                 pipeline=pipeline)
        weight = sorted(p.name for p in
                        tr.main_program.global_block().all_parameters()
                        if len(p.shape) == 2)[0]
        api.R.clear_events()
        losses = {}
        keys0 = len(tr.exe._cache) if pkg == "port" else None

        def handler(e):
            name = type(e).__name__
            if name == "BeginIteration" and e.batch_id == NAN_AT:
                if pkg == "jax":
                    scope = jpt.global_scope()
                    w = np.array(scope.find_var(weight))
                    w[0, 0] = np.nan
                    scope.set_var(weight, w)
                else:
                    global_scope().find_var(weight)[0, 0] = float("nan")
            elif name == "EndIteration":
                losses[e.batch_id] = float(e.cost)

        # the rewind's target, kept apart: the pass's end saves over it
        shutil.copytree(tr.checkpoint_dir, str(tmp_path / (pkg + "_clean")))
        with api.flags_guard(loss_skip_budget=2):
            tr.train(book.reader_of(batches[3:]), num_passes=1,
                     event_handler=handler, pipeline=pipeline)
        trail = _trail(api)
        keys1 = len(tr.exe._cache) if pkg == "port" else None
        # rerun batches 4-5 of the pass from the same checkpoint
        tr.checkpoint_dir = str(tmp_path / (pkg + "_clean"))
        assert tr._load_checkpoint_state() is True
        rerun = []
        tr.train(book.reader_of(batches[3 + 4:]), num_passes=1,
                 event_handler=lambda e: rerun.append(float(e.cost))
                 if type(e).__name__ == "EndIteration" else None,
                 pipeline=pipeline)
    return losses, trail, (keys0, keys1), rerun


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
def test_rewind_into_the_compiled_step_equals_a_restored_rerun(
        tmp_path, pipeline):
    jmain, jstart, _ = book.build("jax", "tiny_lm")
    state = book.jax_startup_state(jmain, jstart)
    port = _lm_rewind("port", tmp_path, state, pipeline)
    jax = _lm_rewind("jax", tmp_path, state, pipeline)
    losses, trail, (keys0, keys1), rerun = port
    assert [t[:4] for t in trail] == [
        ("batch_skipped", "nonfinite", 0, NAN_AT),
        ("batch_skipped", "nonfinite", 0, NAN_AT + 1),
        ("guard_rewind", "nonfinite", 0, NAN_AT + 1)]
    assert trail == jax[1]
    # the rewind reused the step: no new key, so no new capture
    assert keys1 == keys0
    after = [losses[b] for b in range(NAN_AT + 2, LM_BATCHES)]
    assert all(np.isfinite(after))
    # the Adam moments, beta powers and parameters all came back
    assert after == rerun
    want = [jax[0][b] for b in range(NAN_AT + 2, LM_BATCHES)]
    assert book.loss_rel(after, want) <= COST_REL_TOL
    assert book.loss_rel([losses[b] for b in range(NAN_AT)],
                         [jax[0][b] for b in range(NAN_AT)]) <= COST_REL_TOL


# -- the step watchdog ---------------------------------------------------------

def _hang_lever(monkeypatch, pkg, fired_event):
    """A trainer.step delay that waits on ``fired_event`` (set by the
    injected on_hang) instead of sleeping its whole delay."""
    faults = API[pkg].faults
    monkeypatch.setattr(faults, "time", types.SimpleNamespace(
        sleep=lambda s: fired_event.wait(s)))


def _watchdog_factory(monkeypatch, pkg, fired, fired_event, made=None):
    def factory(timeout_s, **kw):
        def on_hang(info):
            fired.append(info)
            fired_event.set()
        cls = StepWatchdog if pkg == "port" else JStepWatchdog
        wd = cls(timeout_s, on_hang=on_hang, poll_s=0.02)
        if made is not None:
            made.append(wd)
        return wd
    monkeypatch.setattr(API[pkg].trainer_mod, "StepWatchdog", factory)


@pytest.mark.parametrize("pkg", PKGS)
def test_trainer_watchdog_fires_at_the_wedged_step(monkeypatch, pkg):
    """A seeded wedged step inside Trainer.train fires the armed deadline
    once, at that step's label. The delay waits on the firing, so the
    test takes the deadline plus milliseconds, and only a normal step of
    the tiny classifier slower than the 3 s deadline could fail it."""
    api = API[pkg]
    fired, fired_event = [], threading.Event()
    _watchdog_factory(monkeypatch, pkg, fired, fired_event)
    _hang_lever(monkeypatch, pkg, fired_event)
    state = _startup_state()
    with api.scope():
        tr = _build(pkg)
        book.init_from(tr, pkg, state)
        tr.train(_batches(2), num_passes=1)    # warm: trace / capture done
        api.faults.arm("trainer.step", "delay", nth=3, times=1, delay=120.0)
        t0 = time.monotonic()
        with api.flags_guard(step_timeout_s=3.0):
            tr.train(_batches(5), num_passes=1)
        took = time.monotonic() - t0
    assert [f["label"] for f in fired] == ["pass0/batch2"]
    assert fired[0]["timeout_s"] == pytest.approx(3.0)
    assert took < 60.0


def test_watchdog_fires_once_and_reports_its_label():
    fired, ev = [], threading.Event()
    wd = StepWatchdog(0.15, on_hang=lambda i: (fired.append(i), ev.set()),
                      poll_s=0.02)
    try:
        wd.arm("stepA")
        assert ev.wait(30.0)
        assert wd.fired
        assert fired[0]["label"] == "stepA"
        assert fired[0]["timeout_s"] == pytest.approx(0.15)
        # one firing suspends the deadline: no repeat
        time.sleep(0.3)
        assert len(fired) == 1
    finally:
        wd.close()


def test_watchdog_ping_defers_and_disarm_suspends():
    fired = []
    wd = StepWatchdog(2.0, on_hang=fired.append, poll_s=0.02)
    try:
        wd.arm("s0")
        for _ in range(10):          # progress well inside the deadline
            time.sleep(0.05)
            wd.ping("s")
        wd.disarm()
        assert wd._deadline is None
        wd.tick("wait")              # a tick does not resurrect it
        assert wd._deadline is None
        wd.arm("again")
        wd.tick("wait")
        assert wd._label == "wait"
        wd.disarm()
        assert not fired
    finally:
        wd.close()
    assert not wd._thread.is_alive()


def test_watchdog_rejects_zero_timeout_and_keeps_the_exit_code():
    from paddle_tpu.resilience.watchdog import STEP_HUNG_EXIT as JEXIT
    with pytest.raises(ValueError):
        StepWatchdog(0.0)
    assert STEP_HUNG_EXIT == JEXIT == 75


def test_guard_rewind_pauses_the_step_deadline(tmp_path, monkeypatch):
    """A checkpoint restore is recovery, not a hang: the deadline is
    disarmed while it runs (checked in the restore itself), so a restore
    longer than the deadline does not fire it."""
    fired, made = [], []
    _watchdog_factory(monkeypatch, "port", fired, threading.Event(), made)
    state = _startup_state()
    paused = []
    with scope_guard(Scope()):
        tr = _build("port", checkpoint_dir=str(tmp_path))
        book.init_from(tr, "port", state)
        tr.train(_batches(2), num_passes=1)      # the rewind target
        real_load = tr._load_checkpoint_state

        def slow_load():
            paused.append(made[-1]._deadline is None)
            time.sleep(2.5)                      # past the 2 s deadline
            return real_load()

        monkeypatch.setattr(tr, "_load_checkpoint_state", slow_load)
        with tflags_guard(loss_skip_budget=1, step_timeout_s=2.0):
            tr.train(_batches(6, nan_at=2), num_passes=1)
    assert paused == [True]
    assert not fired
    assert len(TR.events(kind="guard_rewind")) == 1


def test_durable_guard_events_are_strict_json(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_STATE", str(tmp_path))
    from paddle_tpu_torch.resilience.guardrails import NumericGuard
    g = NumericGuard(1)
    with pytest.raises(FloatingPointError):
        g.check(float("nan"), pass_id=0, batch_id=4)
    rows = [json.loads(ln) for ln in
            open(os.path.join(str(tmp_path), "events.jsonl"))]
    assert [r["kind"] for r in rows] == ["batch_skipped"]
    assert rows[0]["loss"] == "nan" and rows[0]["batch_id"] == 4


def _cli_train(tmp_path, state_dir, spec, timeout_s):
    env = dict(os.environ, PYTHONPATH=ROOT,
               PADDLE_TPU_FLAGS="step_timeout_s=%g" % timeout_s,
               PADDLE_TPU_ELASTIC_STATE=str(state_dir))
    env.pop("PADDLE_TPU_FAULT_SPEC", None)
    if spec:
        env["PADDLE_TPU_FAULT_SPEC"] = spec
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join(ROOT, "paddle_tpu_torch", "configs", "fit_a_line.py"),
         "--device", "cpu", "--log_period", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_hang_exits_75_with_its_event_and_timeline(tmp_path):
    """The default on_hang, from the monitor thread of a real process:
    exit 75, one durable step_hung line at pass0/batch2, the timeline
    artifact beside it; the same command without the fault exits 0."""
    state = tmp_path / "state"
    state.mkdir()
    out = _cli_train(tmp_path, state, "trainer.step:delay:nth=3,delay=3600",
                     5.0)
    assert out.returncode == STEP_HUNG_EXIT, out.stderr[-3000:]
    assert "step watchdog" in out.stderr
    rows = [json.loads(ln) for ln in open(state / "events.jsonl")]
    hung = [r for r in rows if r["kind"] == "step_hung"]
    assert len(hung) == 1 and hung[0]["label"] == "pass0/batch2"
    assert hung[0]["site"] == "trainer.watchdog"
    art = json.load(open(hung[0]["timeline"]))
    assert os.path.dirname(hung[0]["timeline"]) == str(state)
    assert art["schema"] == "paddle_tpu.timeline.v1"
    assert art["trainer"]["steps_hung"] == 1.0
    clean = tmp_path / "clean"
    clean.mkdir()
    ok = _cli_train(tmp_path, clean, None, 5.0)
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert not os.path.exists(clean / "events.jsonl")


# -- flags ---------------------------------------------------------------------

def test_the_three_flags_have_the_jax_defaults():
    for name in ("step_timeout_s", "loss_skip_budget", "loss_spike_factor"):
        assert getattr(TFLAGS, name) == getattr(JFLAGS, name)
        assert type(getattr(TFLAGS, name)) is type(getattr(JFLAGS, name))


def test_the_flags_are_read_from_paddle_tpu_flags():
    code = ("from paddle_tpu_torch.flags import FLAGS; "
            "print(FLAGS.step_timeout_s, FLAGS.loss_skip_budget, "
            "FLAGS.loss_spike_factor)")
    env = dict(os.environ, PYTHONPATH=ROOT, PADDLE_TPU_FLAGS=(
        "step_timeout_s=2.5,loss_skip_budget=3,loss_spike_factor=10"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["2.5", "3", "10.0"], out.stderr


def test_guard_verdicts_match_jax_on_the_same_losses():
    """NumericGuard alone, fed the same sequences in both packages: the
    same verdicts, counts, baselines and events."""
    from paddle_tpu.resilience.guardrails import NumericGuard as JGuard
    from paddle_tpu_torch.resilience.guardrails import NumericGuard as TGuard
    nan, inf = float("nan"), float("inf")
    cases = [
        (dict(skip_budget=3), [0.5, nan, inf, 0.4]),
        (dict(skip_budget=5, spike_factor=10.0), [1.0, 1.1, 0.9, 50.0, 5.0]),
        (dict(skip_budget=2), [1.0, 1.0, 1.0, 1e9]),
        (dict(skip_budget=2, rewind=True), [nan, nan, nan, nan]),
        (dict(skip_budget=1, rewind=True), [nan, 1.0, nan]),
        (dict(skip_budget=1), [nan]),
    ]
    for kw, seq in cases:
        out = {}
        for pkg, cls in (("jax", JGuard), ("port", TGuard)):
            API[pkg].R.clear_events()
            kw2 = dict(kw)
            rewind = kw2.pop("rewind", False)
            g = cls(kw2.pop("skip_budget"), rewind_fn=(lambda: True)
                    if rewind else None, **kw2)
            verdicts = []
            for v in seq:
                try:
                    verdicts.append(g.check(v))
                except FloatingPointError as e:
                    verdicts.append("gave up: %s" % e)
            out[pkg] = (verdicts, g.skips, g.rewinds, g.tainted,
                        g.baseline(),
                        [(e["kind"], e["reason"], e.get("consecutive"))
                         for e in API[pkg].R.events()])
        assert out["port"] == out["jax"], (kw, seq)


def test_counters_and_the_trainer_timeline_section(tmp_path):
    for api in API.values():
        api.prof.update_trainer_counters(batches_skipped=2, guard_rewinds=1,
                                         steps_hung=1)
    art = {pkg: API[pkg].prof.write_timeline(str(tmp_path / (pkg + ".json")))
           for pkg in PKGS}
    assert art["port"]["trainer"] == art["jax"]["trainer"] == {
        "batches_skipped": 2.0, "guard_rewinds": 1.0, "steps_hung": 1.0}
    tprof.reset_trainer_counters()
    assert tprof.trainer_counters() == {}


def test_the_step_site_is_hit_once_a_step(tmp_path):
    """fault_point("trainer.step") runs once before each step: a raise
    armed at hit 3 leaves train() after two batches."""
    state = _startup_state()
    for pkg in PKGS:
        api = API[pkg]
        with api.scope():
            tr = _build(pkg)
            book.init_from(tr, pkg, state)
            api.faults.arm("trainer.step", "raise", nth=3, times=1)
            seen = []
            with pytest.raises(api.faults.FaultError):
                tr.train(_batches(5), num_passes=1,
                         event_handler=lambda e: seen.append(e.batch_id)
                         if type(e).__name__ == "EndIteration" else None)
            assert seen == [0, 1]
            assert api.faults.hits("trainer.step") == 3


def test_pipelined_and_synchronous_guarded_runs_agree(tmp_path):
    """Within the port, the guard's per-batch sync point leaves the
    pipelined losses and trail those of the synchronous run."""
    state = _startup_state()
    runs = [_scenario("port", tmp_path / str(p), state,
                      {"loss_skip_budget": 2}, _batches(8, nan_at=3),
                      seed_batches=4, pipeline=p) for p in (False, True)]
    assert runs[0]["trail"] == runs[1]["trail"]
    assert runs[0]["costs"][:3] == runs[1]["costs"][:3]
    assert _accepted(runs[0]) == _accepted(runs[1])


def test_batch_timers_nest_under_the_pass_timer():
    tprof.reset_stats()
    state = _startup_state()
    with scope_guard(Scope()):
        tr = _build("port")
        book.init_from(tr, "port", state)
        tr.train(_batches(3), num_passes=2)
    snap = tprof.stat_summary()
    assert snap["pass"][0] == 2 and snap["pass.batch"][0] == 6
    tprof.reset_stats()



def test_an_armed_watchdog_on_the_card_builds_the_kernels_first(
        monkeypatch):
    """ROADMAP.md Queue 3 #25: train() with step_timeout_s makes the
    process's first autograd call (generic_grad.warm_up) and, on a CUDA
    device, runs kernels/_build.build_all() (a hash check when the
    libraries exist) before it arms the deadline, so neither an nvcc run
    nor torch's lazy import counts against a step; on the CPU it builds
    nothing."""
    from paddle_tpu_torch.kernels import _build as kbuild
    from paddle_tpu_torch.ops import generic_grad
    order = []
    real_warm = generic_grad.warm_up
    monkeypatch.setattr(generic_grad, "warm_up",
                        lambda: order.append("warm_up") or real_warm())

    class Armed(Exception):
        pass

    def factory(timeout_s, **kw):
        order.append("watchdog")
        raise Armed()

    monkeypatch.setattr(kbuild, "build_all",
                        lambda: order.append("build_all") or {})
    monkeypatch.setattr(ttrainer_mod, "StepWatchdog", factory)
    state = _startup_state()
    with scope_guard(Scope()):
        tr = _build("port")
        book.init_from(tr, "port", state)
        with tflags_guard(step_timeout_s=5.0):
            with pytest.raises(Armed):
                tr.train(_batches(2), num_passes=1)
            assert order == ["warm_up", "watchdog"]
            del order[:]
            cpu = tr.exe.device
            tr.exe.device = types.SimpleNamespace(type="cuda")
            try:
                with pytest.raises(Armed):
                    tr.train(_batches(2), num_passes=1)
            finally:
                tr.exe.device = cpu
    assert order == ["build_all", "warm_up", "watchdog"]
