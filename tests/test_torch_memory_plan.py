"""The port's memory planner and the Executor's memory behaviour
(``paddle_tpu_torch/analysis/memory.py``, ``core/executor.py``) against
the JAX package's planner, on the CPU.

1. Plan parity: ``plan_memory`` and ``compute_liveness`` give the same
   summary (peak, classes, high-water op, unknown vars) and the same live
   sets in both packages on the training steps of the tiny LM,
   fit_a_line, a small ResNet, the LoD text classifier and the two
   DynamicRNN book models (a While, its body flattened into the plan).
2. PT030-PT033 fire as the JAX package's tests have them
   (``tests/test_memory_analysis.py``).
3. The preflight under ``FLAGS.verify``: raises before any step, silent
   at a generous budget, off without the flag, and its prediction within
   25 % of the measured live bytes on a feed-dominated model.
4. The release schedule: the per-op, compiled and hybrid paths give
   bit-identical fetches and state with it and without it (every value
   kept, the parent's behaviour) on the tiny LM, the LoD text classifier
   and a training step with a ``save`` in its forward; after a per-op
   run the environment holds only fetches, persistables and feeds; a
   value read twice far apart lives to its second read; a lowering that
   reads a dropped value raises.
"""
import contextlib
import gc

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import layers as jlayers
from paddle_tpu.analysis import memory as jmem
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.analysis import ProgramVerifyError
from paddle_tpu_torch.analysis import Severity
from paddle_tpu_torch.analysis import memory as tmem
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.core.scope import Scope, scope_from_numpy, \
    scope_to_numpy
from paddle_tpu_torch.flags import flags_guard

import torch_book as book

PLAN_BATCH = {"fit_a_line": 16, "tiny_lm": 4, "resnet_cifar": 4,
              "text_rnn": 4, "rnn_encoder_decoder": 2,
              "machine_translation": 2}


def codes(diags):
    return sorted({d.code for d in diags})


# ---------------------------------------------------------------------------
# 1. plan parity


def _flat_sets(mem, prog):
    ops = mem.flatten_ops(prog)
    uses = [set(n for n in op.input_arg_names if n) for _, _, op in ops]
    defs = [set(n for n in op.output_arg_names if n) for _, _, op in ops]
    return uses, defs


@pytest.mark.parametrize("kind", sorted(PLAN_BATCH))
def test_plan_and_liveness_match_the_jax_package(kind):
    got = {}
    for pkg, mem in (("jax", jmem), ("port", tmem)):
        main, _, spec = book.build(pkg, kind)
        plan = mem.plan_memory(main, batch=PLAN_BATCH[kind],
                               fetches=[spec["cost"]], vmem=False)
        summary = plan.summary()
        summary.pop("vmem_scratch_bytes")  # TPU VMEM against H100 smem
        uses, defs = _flat_sets(mem, main)
        got[pkg] = (summary, plan.unknown, plan.top_residents(5),
                    mem.compute_liveness(uses, defs), uses, defs,
                    {n: (r.nbytes, r.cls, r.start, r.end)
                     for n, r in plan.records.items()})
    j, t = got["jax"], got["port"]
    assert t[0] == j[0]
    assert t[1] == j[1]
    assert [r.name for r in t[2]] == [r.name for r in j[2]]
    assert t[4] == j[4] and t[5] == j[5]
    assert t[3] == j[3]
    assert t[6] == j[6]
    assert t[0]["peak_bytes"] > t[0]["param_bytes"]


GPT2 = dict(vocab=50257, seq=1024, hidden=768, num_layers=12, num_heads=12)


def _gpt2_small(pkg, batch):
    """The GPT-2-small LM's training step (Adam 1e-3) in ``pkg``, built
    only: (program, cost)."""
    if pkg == "jax":
        from paddle_tpu import models as jmodels
        from paddle_tpu.core import unique_name as jun
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            toks = jlayers.data("toks", shape=[GPT2["seq"]], dtype="int64")
            toks.shape = (-1, GPT2["seq"])
            tgt = jlayers.data("tgt", shape=[GPT2["seq"]], dtype="int64")
            tgt.shape = (-1, GPT2["seq"])
            logits = jmodels.transformer_lm(
                toks, vocab_size=GPT2["vocab"], hidden=GPT2["hidden"],
                num_layers=GPT2["num_layers"], num_heads=GPT2["num_heads"])
            flat = jlayers.reshape(logits, shape=[-1, GPT2["vocab"]])
            cost = jlayers.mean(jlayers.softmax_with_cross_entropy(
                flat, jlayers.reshape(tgt, shape=[-1, 1])))
            jpt.optimizer.Adam(learning_rate=1e-3).minimize(cost)
        return main, cost
    from paddle_tpu_torch.configs import tiny_lm
    main, start = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, start):
        spec = tiny_lm.model(batch=batch, samples=1, learning_rate=1e-3,
                             **GPT2)
        spec["optimizer"].minimize(spec["cost"])
    return main, spec["cost"]


def test_gpt2_small_plan_matches_the_jax_package_and_chip_smoke():
    """The plan chip_smoke.py's phase 15 holds the card's step to: the
    GPT-2-small LM at batch 8, built (not run) in both packages."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_constants", os.path.join(book.ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    plans = {}
    for pkg, mem in (("jax", jmem), ("port", tmem)):
        main, cost = _gpt2_small(pkg, smoke.TRAIN_BATCH)
        assert len(main.global_block().ops) == 617
        plans[pkg] = mem.plan_memory(main, batch=smoke.TRAIN_BATCH,
                                     fetches=[cost], vmem=False)
    j, t = plans["jax"].summary(), plans["port"].summary()
    assert t == j
    assert plans["port"].unknown == plans["jax"].unknown
    assert t["peak_bytes"] == smoke.LM_PLAN_PEAK_BYTES
    assert t["peak_op"] == "block0:op220 (generic_grad)"
    assert t["unknown_vars"] == 199
    # the batch the phase refuses: far above an 80 GB card
    main, cost = _gpt2_small("port", smoke.MEM_REFUSE_BATCH)
    assert tmem.plan_memory(main, batch=smoke.MEM_REFUSE_BATCH,
                            fetches=[cost]).peak_bytes > 100e9


def test_plan_prices_the_port_kernels_shared_memory():
    """The kernel-scratch row: the conv3x3 population's shared memory a
    block, by the tune space's model (the JAX package prices VMEM)."""
    cfg_main, cfg_start = tir.Program(), tir.Program()
    from paddle_tpu_torch.configs import resnet_cifar
    with tun.guard(), tir.program_guard(cfg_main, cfg_start):
        resnet_cifar.model(depth=8, image=16, batch=4, samples=4)
    plan = tmem.plan_memory(cfg_main, batch=4)
    assert plan.vmem_scratch[0] == "conv3x3" and plan.vmem_scratch[1] > 0
    assert "kernel shared memory a block (worst op conv3x3)" in plan.table()


def test_compute_liveness_contract():
    uses = [set(), {"a"}, {"b"}]
    defs = [{"a"}, {"b"}, {"c"}]
    live_in, live_out = tmem.compute_liveness(uses, defs)
    assert live_out[0] == {"a"} and live_in[1] == {"a"}
    assert live_out[1] == {"b"} and live_in[2] == {"b"}
    assert live_out[2] == set()
    assert (live_in, live_out) == jmem.compute_liveness(uses, defs)


def test_sharded_residency_is_refused_not_ignored():
    main, _, _ = _train_program()
    for kw in ({"specs": {"fc_0.w_0": ("dp", None)}},
               {"mesh_shape": {"dp": 2}}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            tmem.plan_memory(main, batch=16, **kw)


# ---------------------------------------------------------------------------
# 2. the codes


def _train_program(P="port", size=4, feat=13):
    """fit-a-line-shaped train step: forward, backward, Momentum."""
    if P == "jax":
        main, startup = jpt.Program(), jpt.Program()
        with jpt.program_guard(main, startup):
            x = jlayers.data(name="x", shape=[feat], dtype="float32")
            y = jlayers.data(name="y", shape=[1], dtype="float32")
            pred = jlayers.fc(input=x, size=size, act=None)
            cost = jlayers.mean(jlayers.square_error_cost(input=pred,
                                                          label=y))
            jpt.optimizer.Momentum(learning_rate=0.01,
                                   momentum=0.9).minimize(cost)
        return main, startup, cost
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tlayers.data(name="x", shape=[feat], dtype="float32")
        y = tlayers.data(name="y", shape=[1], dtype="float32")
        pred = tlayers.fc(input=x, size=size, act=None)
        cost = tlayers.mean(tlayers.square_error_cost(input=pred, label=y))
        topt.Momentum(learning_rate=0.01, momentum=0.9).minimize(cost)
    return main, startup, cost


def test_plan_classifies_and_prices_the_train_step():
    main, _startup, cost = _train_program()
    plan = tmem.plan_memory(main, batch=16, fetches=[cost])
    cb = plan.class_bytes
    assert cb["params"] == (13 * 4 + 4) * 4
    assert cb["optimizer_state"] >= (13 * 4 + 4) * 4
    assert cb["gradients"] > 0 and cb["activations"] > 0
    assert cb["feeds"] == 16 * (13 + 1) * 4
    assert plan.exact and plan.peak_bytes > cb["params"]
    assert "block0:op" in plan.peak_op_ref() and plan.top_residents(3)
    assert plan.records[cost.name].end == plan.n_ops - 1
    p4 = tmem.plan_memory(main, batch=16, fetches=[cost], dp=4)
    assert p4.class_bytes["feeds"] * 4 == cb["feeds"]
    assert p4.class_bytes["params"] == cb["params"]
    assert p4.peak_bytes < plan.peak_bytes


def test_pt030_over_budget_names_high_water_op_and_residents():
    for P, mem in (("port", tmem), ("jax", jmem)):
        main, _startup, cost = _train_program(P)
        plan, diags = mem.check_memory(main, batch=16, fetches=[cost],
                                       budget_bytes=64)
        (d,) = [d for d in diags if d.code == "PT030"]
        assert d.is_error and d.hint
        assert plan.peak_op_ref() in d.message
        assert plan.top_residents(1)[0].name in d.message
        _plan, diags = mem.check_memory(main, batch=16, fetches=[cost],
                                        budget_bytes=1 << 34)
        assert "PT030" not in codes(diags)
    # the two packages name the same op at the same peak
    tp = tmem.plan_memory(_train_program("port")[0], batch=16, vmem=False)
    jp = jmem.plan_memory(_train_program("jax")[0], batch=16, vmem=False)
    assert (tp.peak_op_ref(), tp.peak_bytes) == (jp.peak_op_ref(),
                                                 jp.peak_bytes)


def test_pt031_big_dead_feed_with_compatible_output():
    def build(name, shape):
        main, startup = tir.Program(), tir.Program()
        with tir.program_guard(main, startup):
            x = tlayers.data(name=name, shape=shape,
                             append_batch_size=False, dtype="float32")
            tlayers.scale(x, scale=2.0)
        return main
    _plan, diags = tmem.check_memory(build("bigfeed", [512, 1024]), batch=1)
    hits = [d for d in diags if d.code == "PT031"]
    assert hits and hits[0].var == "bigfeed"
    assert hits[0].severity == Severity.WARNING
    assert "donate" in (hits[0].hint or "")
    _plan, diags = tmem.check_memory(build("smallfeed", [4, 4]), batch=1)
    assert "PT031" not in codes(diags)


def test_pt032_write_only_persistable():
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tlayers.data(name="x", shape=[8], dtype="float32")
        h = tlayers.fc(input=x, size=4)
        blk = main.global_block()
        dead = blk.create_var(name="kept_for_nothing", shape=[4, 4],
                              dtype="float32", persistable=True)
        blk.append_op("assign", inputs={"X": [h]}, outputs={"Out": [dead]})
    _plan, diags = tmem.check_memory(main, batch=16)
    hits = [d for d in diags if d.code == "PT032"]
    assert hits and hits[0].var == "kept_for_nothing"
    tmain, _tstartup, _cost = _train_program()
    _plan, tdiags = tmem.check_memory(tmain, batch=16)
    assert "PT032" not in codes(tdiags)


def test_pt033_unknown_sizes_degrade_to_bounded_estimate():
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tlayers.data(name="x", shape=[8], dtype="float32")
        h = tlayers.fc(input=x, size=4)
        blk = main.global_block()
        mystery = blk.create_var(name="mystery", dtype="float32")
        blk.append_op("assign", inputs={"X": [h]},
                      outputs={"Out": [mystery]})
        mystery.shape = None
    plan, diags = tmem.check_memory(main, batch=16)
    assert not plan.exact and "mystery" in plan.unknown
    hits = [d for d in diags if d.code == "PT033"]
    assert hits and "LOWER BOUND" in hits[0].message
    assert "x" in tmem.plan_memory(main, batch=None).unknown


def test_zero_false_positives_at_a_generous_budget():
    for kind in sorted(PLAN_BATCH):
        main, _, _ = book.build("port", kind)
        _plan, diags = tmem.check_memory(main, batch=16,
                                         budget_bytes=1 << 36)
        assert not [d for d in diags if d.is_error], kind


def test_pt034_keeps_its_codes_on_the_shared_diagnostic():
    from paddle_tpu_torch.analysis import Diagnostic
    pool = tmem.kv_pool_bytes(4, 2, 8, 64, 16)
    (d,) = tmem.check_kv_pool(4, 2, 8, 64, 16, budget_bytes=pool - 1)
    (j,) = jmem.check_kv_pool(4, 2, 8, 64, 16, budget_bytes=pool - 1)
    assert isinstance(d, Diagnostic) and d.is_error
    assert str(d) == str(j)


# ---------------------------------------------------------------------------
# 3. the preflight


def _port_state(main, startup):
    scope = Scope()
    Executor("cpu").run(startup, scope=scope)
    return scope


def _feeds16():
    return {"x": np.random.RandomState(0).rand(16, 13).astype(np.float32),
            "y": np.random.RandomState(1).rand(16, 1).astype(np.float32)}


@pytest.mark.parametrize("use_jit", [True, False])
def test_preflight_raises_before_any_step(use_jit):
    main, startup, cost = _train_program()
    exe, scope = Executor("cpu"), Scope()
    exe.run(startup, scope=scope)
    before = dict(exe.stats)
    with flags_guard(verify=True, memory_budget_gb=1e-7):
        with pytest.raises(ProgramVerifyError) as ei:
            exe.run(main, feed=_feeds16(), fetch_list=[cost], scope=scope,
                    use_jit=use_jit)
    msg = str(ei.value)
    assert "before the step's first run" in msg
    assert "PT030" in msg and "high-water op" in msg
    assert "predicted per-device HBM residency" in msg
    for k in ("jit_runs", "eager_runs", "hybrid_runs", "ops_run"):
        assert exe.stats[k] == before[k], k


def test_preflight_silent_at_generous_budget_and_once_a_key():
    main, startup, cost = _train_program()
    exe, scope = Executor("cpu"), Scope()
    exe.run(startup, scope=scope)
    with flags_guard(verify=True, memory_budget_gb=64.0):
        out = exe.run(main, feed=_feeds16(), fetch_list=[cost], scope=scope)
        assert np.isfinite(np.asarray(out[0])).all()
        predicted = exe.stats["mem_predicted_peak_bytes"]
        want = tmem.plan_memory(main, batch=16, fetches=[cost.name])
        assert predicted == want.peak_bytes > 0
        exe.run(main, feed=_feeds16(), fetch_list=[cost], scope=scope)
    assert len(exe._preflighted) == 1  # main's key, checked once


def test_preflight_prices_the_tiny_lm_as_its_plan():
    main, start, spec = book.build("port", "tiny_lm")
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    feed = book.feeds("tiny_lm", "port", 1)[0]
    with flags_guard(verify=True):
        exe.run(main, feed=feed, fetch_list=[spec["cost"]], scope=scope)
    plan = tmem.plan_memory(main, batch=feed["toks"].shape[0],
                            fetches=[spec["cost"]])
    assert exe.stats["mem_predicted_peak_bytes"] == plan.peak_bytes


def test_preflight_off_without_verify():
    main, startup, cost = _train_program()
    exe, scope = Executor("cpu"), Scope()
    exe.run(startup, scope=scope)
    with flags_guard(verify=False, memory_budget_gb=1e-7):
        out = exe.run(main, feed=_feeds16(), fetch_list=[cost], scope=scope)
    assert np.isfinite(np.asarray(out[0])).all()
    assert exe.stats["mem_predicted_peak_bytes"] == 0


def test_preflight_prediction_tracks_measured_live_bytes():
    """Feed-dominated model (the JAX package's test): the predicted peak
    within 25 % of the live bytes the step leaves measured at its
    boundary."""
    gc.collect()
    base = tmem.measure_live_bytes()
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tlayers.data(name="x", shape=[1024], dtype="float32")
        y = tlayers.data(name="y", shape=[1], dtype="float32")
        pred = tlayers.fc(input=x, size=4, act=None)
        cost = tlayers.mean(tlayers.square_error_cost(input=pred, label=y))
        topt.SGD(learning_rate=0.01).minimize(cost)
    exe, scope = Executor("cpu"), Scope()
    exe.run(startup, scope=scope)
    batch = 2048  # feed = 2048 x 1024 x 4 B = 8 MiB >> params (16 KiB)
    feed = exe.prepare_feed({"x": np.ones((batch, 1024), np.float32),
                             "y": np.ones((batch, 1), np.float32)})
    with flags_guard(verify=True, memory_budget_gb=64.0):
        out = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    float(np.asarray(out[0]).reshape(-1)[0])
    gc.collect()
    measured = tmem.measure_live_bytes() - base
    predicted = exe.stats["mem_predicted_peak_bytes"]
    assert predicted > 0 and measured > 0
    assert abs(predicted - measured) / measured < 0.25, \
        "predicted %d vs measured %d" % (predicted, measured)


# ---------------------------------------------------------------------------
# 4. the release schedule


@contextlib.contextmanager
def _keep_all(monkeypatch):
    """Every value kept (the parent's Executor): a schedule that drops
    nothing."""
    with monkeypatch.context() as m:
        m.setattr(tmem, "release_schedule",
                  lambda block, ops, keep: [()] * len(ops))
        yield


def _hybrid_fit_a_line(path):
    """fit_a_line's training step with a ``save`` of the fc's product in
    its forward: two device segments around a host op."""
    main, start, spec = book.build("port", "fit_a_line")
    blk = main.global_block()
    blk.insert_op(1, "save", inputs={"X": [blk.ops[0].output("Out")[0]]},
                  attrs={"file_path": path})
    return main, start, spec


def _case(kind, tmp_path):
    if kind == "hybrid":
        return _hybrid_fit_a_line(str(tmp_path / "fc_out")), "fit_a_line"
    return book.build("port", kind), kind


def _steps(main, state, feeds, fetch, use_jit):
    exe, scope = Executor("cpu"), Scope()
    scope_from_numpy(state, device="cpu", scope=scope)
    outs = [[np.asarray(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope, use_jit=use_jit)]
            for f in feeds]
    return outs, scope_to_numpy(scope, names=state), exe


@pytest.mark.parametrize("use_jit", [False, True])
@pytest.mark.parametrize("kind", ["tiny_lm", "text_rnn", "hybrid"])
def test_release_is_bit_identical_to_keeping_every_value(kind, use_jit,
                                                         tmp_path,
                                                         monkeypatch):
    (main, start, spec), feed_kind = _case(kind, tmp_path)
    main.random_seed = start.random_seed = 3
    state = scope_to_numpy(_port_state(main, start),
                           names=book.persist_names(main))
    feeds = book.feeds(feed_kind, "port", 3)
    fetch = [spec["cost"].name] + [m.name for m in spec.get("metrics", ())]
    got, got_state, exe = _steps(main, state, feeds, fetch, use_jit)
    with _keep_all(monkeypatch):
        want, want_state, _ = _steps(main, state, feeds, fetch, use_jit)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(a, b)
    assert sorted(got_state) == sorted(want_state)
    for n in want_state:
        assert np.array_equal(got_state[n], want_state[n]), n
    path = {"hybrid": "hybrid_runs", False: "eager_runs",
            True: "jit_runs"}["hybrid" if kind == "hybrid" and use_jit
                              else use_jit]
    assert exe.stats[path] == 3
    assert any(exe._release(main, fetch))


def test_per_op_env_holds_only_fetches_persistables_and_feeds(monkeypatch):
    main, start, spec = book.build("port", "tiny_lm")
    scope = _port_state(main, start)
    feed = book.feeds("tiny_lm", "port", 1)[0]
    envs = []
    real = texecutor.trace_ops

    def spy(block, env, *a, **kw):
        real(block, env, *a, **kw)
        envs.append(env)

    monkeypatch.setattr(texecutor, "trace_ops", spy)
    fetch = [spec["cost"].name]
    Executor("cpu").run(main, feed=feed, fetch_list=fetch, scope=scope,
                        use_jit=False)
    persist = {v.name for v in main.list_vars() if v.persistable}
    (env,) = envs
    assert set(env) <= set(fetch) | persist | set(feed)
    assert set(fetch) <= set(env)
    with _keep_all(monkeypatch):
        Executor("cpu").run(main, feed=feed, fetch_list=fetch, scope=scope,
                            use_jit=False)
    assert len(envs[1]) > len(env) + 100  # the parent kept every value


def _read_twice_program():
    prog = tir.Program()
    blk = prog.global_block()
    for n in ("x", "a", "b", "c", "d"):
        blk.create_var(name=n, shape=(2, 3), dtype="float32")
    blk.append_op("scale", inputs={"X": ["x"]}, outputs={"Out": ["a"]},
                  attrs={"scale": 2.0})
    blk.append_op("scale", inputs={"X": ["a"]}, outputs={"Out": ["b"]},
                  attrs={"scale": 3.0})
    blk.append_op("scale", inputs={"X": ["b"]}, outputs={"Out": ["c"]},
                  attrs={"scale": 5.0})
    blk.append_op("elementwise_add", inputs={"X": ["c"], "Y": ["a"]},
                  outputs={"Out": ["d"]})
    return prog


@pytest.mark.parametrize("use_jit", [False, True])
def test_value_read_twice_far_apart_lives_to_its_second_read(use_jit):
    prog = _read_twice_program()
    exe = Executor("cpu")
    assert exe._release(prog, ["d"]) == [(), (), ("b",), ("a", "c")]
    assert exe._release(prog, ["a", "d"]) == [(), (), ("b",), ("c",)]
    xs = np.arange(6, dtype=np.float32).reshape(2, 3)
    for _ in range(3):
        d, = exe.run(prog, feed={"x": xs}, fetch_list=["d"],
                     use_jit=use_jit)
        np.testing.assert_array_equal(d, 2 * xs * 3 * 5 + 2 * xs)


@tregistry.register_op("test_reads_env_by_attr")
def _reads_env_by_attr(ctx):
    # a faulty lowering: it reads a value by a name that is not among its
    # op's inputs, so the schedule cannot know it is read here
    ctx.set_output("Out", ctx.env[ctx.attr("name")] + 1)


def test_a_release_that_breaks_a_lowering_raises(monkeypatch):
    prog = _read_twice_program()
    blk = prog.global_block()
    blk.create_var(name="e", shape=(2, 3), dtype="float32")
    blk.append_op("test_reads_env_by_attr", inputs={"X": ["d"]},
                  outputs={"Out": ["e"]}, attrs={"name": "b"})
    xs = np.ones((2, 3), np.float32)
    with pytest.raises(KeyError, match="'b'"):
        Executor("cpu").run(prog, feed={"x": xs}, fetch_list=["e"],
                            use_jit=False)
    with _keep_all(monkeypatch):
        e, = Executor("cpu").run(prog, feed={"x": xs}, fetch_list=["e"],
                                 use_jit=False)
    np.testing.assert_array_equal(e, 2 * xs * 3 + 1)
