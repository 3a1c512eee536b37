"""The feed pipeline and the pipelined Trainer
(``paddle_tpu_torch/pipeline.py``, ``trainer.py``) against the JAX
package's (``paddle_tpu/pipeline.py``, the counterparts of
``tests/test_async_pipeline.py:69-340`` that apply), on the CPU.

Contracts: losses bit-identical between the synchronous and the
pipelined Trainer over 3 passes, the ring of ``depth`` slots reused
(slot_reuse = batches - depth), the lazy fetches materialized only at
the declared points with the JAX package's counters, the
``pipeline.feed_next`` fault site (the feed thread dies, a
``pipeline_degraded`` event, the pass finishes synchronously with no
batch lost) and a reader's exception reaching the consumer. Tolerance:
none, every comparison is exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu_torch import layers  # noqa: E402
from paddle_tpu_torch import optimizer  # noqa: E402
from paddle_tpu_torch.configs import fit_a_line  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import AsyncFetch, Executor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope, scope_guard  # noqa: E402
from paddle_tpu_torch.data_feeder import DataFeeder  # noqa: E402
from paddle_tpu_torch.flags import flags_guard  # noqa: E402
from paddle_tpu_torch.pipeline import (FeedPipeline, materialize,  # noqa: E402
                                       materialize_scalar)
from paddle_tpu_torch.resilience import events, faults  # noqa: E402
from paddle_tpu_torch.trainer import (EndIteration, EndPass,  # noqa: E402
                                      Trainer)

N_BATCHES = 8
BATCH = 4
DIM = 8


def _build():
    main, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, startup):
        x = layers.data("x", shape=[DIM], dtype="float32")
        y = layers.data("y", shape=[1], dtype="float32")
        h = layers.fc(input=x, size=16, act="relu")
        pred = layers.fc(input=h, size=1, act=None)
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
    return main, startup, cost, [x, y]


def _jax_build():
    main, startup = jpt.Program(), jpt.Program()
    with jun.guard(), jpt.program_guard(main, startup):
        x = jlayers.data("x", shape=[DIM], dtype="float32")
        y = jlayers.data("y", shape=[1], dtype="float32")
        h = jlayers.fc(input=x, size=16, act="relu")
        pred = jlayers.fc(input=h, size=1, act=None)
        cost = jlayers.mean(jlayers.square_error_cost(input=pred, label=y))
    return main, startup, cost, [x, y]


def _reader(n=N_BATCHES, seed=3):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            xs = rng.rand(BATCH, DIM).astype("float32")
            yield [(xs[i], xs[i, :1]) for i in range(BATCH)]
    return r


def _train(pipelined, num_passes=3, depth=2):
    """One Trainer run in a fresh scope; the handler never reads .cost
    during the pass."""
    with scope_guard(Scope()), flags_guard(log_period=0):
        main, startup, cost, feeds = _build()
        tr = Trainer(cost=cost, optimizer=optimizer.SGD(learning_rate=0.05),
                     feed_list=feeds, device="cpu", main_program=main,
                     startup_program=startup)
        evs = []
        tr.train(_reader(), num_passes=num_passes, event_handler=evs.append,
                 pipeline=pipelined, pipeline_depth=depth)
        losses = [e.cost for e in evs if isinstance(e, EndIteration)]
        avgs = [e.metrics["avg_cost"] for e in evs if isinstance(e, EndPass)]
        return losses, avgs, tr


def test_bit_exact_parity_sync_vs_pipelined():
    l_sync, p_sync, _ = _train(False)
    l_pipe, p_pipe, tr = _train(True)
    assert len(l_sync) == 3 * N_BATCHES
    assert l_sync == l_pipe and p_sync == p_pipe
    st = tr.exe.stats
    assert st["lazy_fetches"] == 3 * N_BATCHES
    assert 1 <= st["dispatch_depth"] <= 2
    assert st["feed_wait_ms"] >= 0.0
    # the last pass's ring, as the Trainer keeps it
    assert tr.pipeline_stats["batches"] == N_BATCHES
    assert tr.pipeline_stats["slot_reuse"] == N_BATCHES - 2


def test_pipeline_flag_default():
    with flags_guard(pipeline=True):
        l_pipe, _, tr = _train(None)
    assert tr.exe.stats["lazy_fetches"] > 0
    l_sync, _, tr2 = _train(False)
    assert tr2.exe.stats["lazy_fetches"] == 0
    assert l_pipe == l_sync


def test_check_nan_inf_forces_synchronous():
    with flags_guard(check_nan_inf=True):
        _, _, tr = _train(True, num_passes=1)
    assert tr.exe.stats["lazy_fetches"] == 0
    assert tr.exe.stats["jit_runs"] == 0


def test_ring_buffer_reuse_depth2():
    with scope_guard(Scope()):
        main, startup, cost, feeds = _build()
        exe = Executor("cpu")
        exe.run(startup)
        feeder = DataFeeder(feeds, device="cpu", program=main)
        pipe = FeedPipeline(_reader(), feeder, exe, depth=2)
        try:
            got = list(pipe)
        finally:
            pipe.close()
    assert len(got) == N_BATCHES
    assert all(set(f) == set(feeder.feed_names) for f in got)
    st = pipe.stats
    assert st["depth"] == 2 and st["batches"] == N_BATCHES
    assert 1 <= st["max_in_flight"] <= 2
    assert st["slot_reuse"] == N_BATCHES - 2


def test_depth_one_still_works():
    l_pipe, p_pipe, _ = _train(True, num_passes=1, depth=1)
    l_sync, p_sync, _ = _train(False, num_passes=1)
    assert l_pipe == l_sync and p_pipe == p_sync


def _lazy_sequence(pkg):
    """The JAX test's lazy-fetch sequence; the counters after each
    step."""
    seen = []
    if pkg == "jax":
        main, startup, cost, feeds = _jax_build()
        scope = jpt.Scope()
        ctx = jpt.scope_guard(scope)
        exe = jpt.Executor(jpt.CPUPlace())
        feeder = jpt.DataFeeder(feed_list=feeds, program=main)
    else:
        main, startup, cost, feeds = _build()
        ctx = scope_guard(Scope())
        exe = Executor("cpu")
        feeder = DataFeeder(feeds, device="cpu", program=main)

    def mark():
        seen.append((exe.stats["lazy_fetches"],
                     exe.stats["fetch_sync_count"]))

    with ctx:
        exe.run(startup)
        feed = feeder.feed(next(iter(_reader(n=1)())))
        h = exe.run(main, feed=feed, fetch_list=[cost], sync=False)[0]
        mark()
        h.block()
        assert h.ready
        mark()
        v = float(h)
        mark()
        assert float(h) == v == float(np.asarray(h).reshape(-1)[0])
        assert materialize_scalar(h) == v
        mark()
        out = exe.run(main, feed=feed, fetch_list=[cost])
        assert isinstance(out[0], np.ndarray)
        mark()
        h, extra = exe.run(main, feed=feed, fetch_list=[cost, cost],
                           sync=False)
        ev = (jpt.EndIteration if pkg == "jax" else EndIteration)(
            0, 0, h, {"fetches": [extra]})
        mark()
        c = ev.cost
        assert isinstance(c, float)
        mark()
        f = ev.metrics["fetches"]
        assert float(np.asarray(f[0]).reshape(-1)[0]) == c
        mark()
    return seen


def test_lazy_fetch_counters_move_as_in_jax():
    port = _lazy_sequence("port")
    assert port == _lazy_sequence("jax")
    assert port[:3] == [(1, 0), (1, 0), (1, 1)]


def test_async_fetch_is_the_executors_handle():
    with scope_guard(Scope()):
        main, startup, cost, feeds = _build()
        exe = Executor("cpu")
        exe.run(startup)
        feed = DataFeeder(feeds, device="cpu", program=main).feed(
            next(iter(_reader(n=1)())))
        h = exe.run(main, feed=feed, fetch_list=[cost], sync=False)[0]
    assert isinstance(h, AsyncFetch)


def test_materialize_passthrough():
    assert materialize(3.5) == 3.5
    assert materialize([1, 2]) == [1, 2]
    assert materialize_scalar(np.float32(2.0)) == 2.0


def test_feed_thread_death_falls_back_synchronous():
    faults.reset()
    events.clear_events()
    faults.arm("pipeline.feed_next", action="raise", nth=3)
    try:
        l_pipe, p_pipe, tr = _train(True, num_passes=1)
    finally:
        faults.reset()
    l_sync, p_sync, _ = _train(False, num_passes=1)
    assert l_pipe == l_sync and p_pipe == p_sync
    evs = events.events(kind="pipeline_degraded")
    assert evs and evs[0]["site"] == "pipeline.feed_next"
    assert evs[0]["batch"] == 2


def test_persistent_feed_fault_degrades_cleanly():
    faults.reset()
    events.clear_events()
    faults.arm("pipeline.feed_next", action="raise", nth=1, times=None,
               exc=ConnectionError)
    try:
        l_pipe, p_pipe, _ = _train(True, num_passes=2)
    finally:
        faults.reset()
    l_sync, p_sync, _ = _train(False, num_passes=2)
    assert l_pipe == l_sync and p_pipe == p_sync
    assert len(events.events(kind="pipeline_degraded")) == 2  # a pass each


def test_reader_exception_propagates_through_pipeline():
    def dying():
        for d in _reader(n=2)():
            yield d
        raise ValueError("reader died")

    with scope_guard(Scope()):
        main, startup, cost, feeds = _build()
        exe = Executor("cpu")
        exe.run(startup)
        feeder = DataFeeder(feeds, device="cpu", program=main)
        pipe = FeedPipeline(dying, feeder, exe, depth=2)
        try:
            with pytest.raises(ValueError, match="reader died"):
                list(pipe)
        finally:
            pipe.close()


def test_fit_a_line_config_parity():
    """Losses bit-identical sync vs pipelined on the port's book config
    (the one the CLI trains)."""
    def run(pipelined):
        with scope_guard(Scope()), flags_guard(log_period=0):
            main, startup = ir.Program(), ir.Program()
            with unique_name.guard(), ir.program_guard(main, startup):
                spec = fit_a_line.model()
                tr = Trainer(spec["cost"], spec["optimizer"],
                             spec["feed_list"], device="cpu")
            evs = []
            tr.train(spec["reader"], num_passes=2,
                     event_handler=evs.append, pipeline=pipelined)
            return [e.cost for e in evs if isinstance(e, EndIteration)]

    l_sync = run(False)
    assert l_sync and l_sync == run(True)


def test_fit_a_line_trains_like_jax_from_the_same_state():
    """Both packages' Trainers on fit_a_line, pipelined, from the JAX
    startup state: the losses of every batch agree (1e-5 relative)."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec_ = importlib.util.spec_from_file_location(
        "jax_fit_a_line", os.path.join(root, "examples", "configs",
                                       "fit_a_line.py"))
    jcfg = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(jcfg)
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        main, startup = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, startup):
            jspec = jcfg.model()
            jtr = jpt.Trainer(cost=jspec["cost"],
                              optimizer=jspec["optimizer"],
                              feed_list=jspec["feed_list"],
                              place=jpt.CPUPlace(), main_program=main,
                              startup_program=startup)
        jtr.exe.run(startup)
        jtr._initialized = True
        state = {v.name: np.asarray(jscope.find_var(v.name))
                 for v in main.list_vars() if v.persistable
                 and jscope.find_var(v.name) is not None}
        jevs = []
        jtr.train(jspec["reader"], num_passes=2, event_handler=jevs.append,
                  pipeline=True)
    from paddle_tpu_torch.core.scope import scope_from_numpy
    with scope_guard(Scope()), flags_guard(log_period=0):
        main, startup = ir.Program(), ir.Program()
        with unique_name.guard(), ir.program_guard(main, startup):
            spec = fit_a_line.model()
            tr = Trainer(spec["cost"], spec["optimizer"], spec["feed_list"],
                         device="cpu")
        tr._maybe_init()
        from paddle_tpu_torch.core.scope import global_scope
        scope_from_numpy(state, device="cpu", scope=global_scope())
        evs = []
        tr.train(spec["reader"], num_passes=2, event_handler=evs.append,
                 pipeline=True)
    jl = [e.cost for e in jevs if isinstance(e, jpt.EndIteration)]
    tl = [e.cost for e in evs if isinstance(e, EndIteration)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert tr.exe.stats["lazy_fetches"] == jtr.exe.stats["lazy_fetches"]
