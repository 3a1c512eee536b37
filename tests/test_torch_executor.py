"""The Executor's compiled path (``paddle_tpu_torch/core/executor.py``)
against the JAX package's jit path (``paddle_tpu/core/executor.py``), on
the CPU.

On the CPU the port's compiled path runs everything but the graph: the
first run of a key is the eager warm-up, the second sets up the static
buffers and runs the step through them, later runs copy the feeds in
and run the step again (``graph_captures`` stays 0). The JAX side runs
with its default ``use_jit=True``.

Tolerances: float32 losses within 1e-5 relative of the JAX package's
(REL_TOL); every persistable within REL_TOL of max(1, its largest
magnitude), per array: Adam moves a parameter by about the learning rate
per step whatever its gradient's size, so the float32 sum-order noise of
a gradient near 0 reaches a bias that started at 0 at that scale (the
worst, 7.1e-6, is text_gru's embedding after 4 steps; a bias of largest
magnitude 0.008 differs by 1.1e-6). The port's compiled path is
bit-identical to its own eager path.
"""
import importlib.util
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.core import lod as jlod  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch.configs import fit_a_line as tfit  # noqa: E402
from paddle_tpu_torch.configs import resnet_cifar as tresnet  # noqa: E402
from paddle_tpu_torch.configs import text_rnn as trnn  # noqa: E402
from paddle_tpu_torch.configs import tiny_lm as ttiny  # noqa: E402
from paddle_tpu_torch.core import executor as texec  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import lod as tlod  # noqa: E402
from paddle_tpu_torch.core import registry as tregistry  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope as TScope,  # noqa: E402
                                         scope_from_numpy, scope_guard,
                                         scope_to_numpy)
from paddle_tpu_torch.flags import flags_guard as tflags_guard  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
STEPS = 4


def _jax_config(name):
    spec = importlib.util.spec_from_file_location(
        "jax_cfg_" + name, os.path.join(ROOT, "examples", "configs",
                                        name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the models, built alike in both packages ---------------------------------

RNN = dict(vocab=200, hidden=128, layers=2, batch=4, learning_rate=0.002)


def _jax_rnn(cell):
    """The JAX twin of ``configs/text_rnn.model(cell, lstm_impl="scan",
    **RNN)``."""
    words = jlayers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    inp = jlayers.embedding(input=words, size=[RNN["vocab"], RNN["hidden"]])
    for i in range(RNN["layers"]):
        if cell == "lstm":
            proj = jlayers.fc(input=inp, size=RNN["hidden"] * 4)
            inp, _ = jlayers.dynamic_lstm(input=proj, size=RNN["hidden"] * 4,
                                          use_peepholes=False,
                                          is_reverse=(i % 2 == 1))
        else:
            proj = jlayers.fc(input=inp, size=RNN["hidden"] * 3)
            inp = jlayers.dynamic_gru(input=proj, size=RNN["hidden"],
                                      is_reverse=(i % 2 == 1))
    pooled = jlayers.sequence_pool(input=inp, pool_type="max")
    pred = jlayers.fc(input=pooled, size=2, act="softmax")
    cost = jlayers.mean(jlayers.cross_entropy(input=pred, label=label))
    jpt.optimizer.Adam(learning_rate=RNN["learning_rate"]).minimize(cost)
    return cost


def _rnn_feeds(lod_mod):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(STEPS):
        lengths = rng.randint(3, 12, RNN["batch"])
        seqs = [rng.randint(0, RNN["vocab"], (n, 1)).astype(np.int64)
                for n in lengths]
        labels = rng.randint(0, 2, (RNN["batch"], 1)).astype(np.int64)
        out.append((seqs, labels))
    return [{"words": lod_mod.build_lod_tensor(s), "label": y}
            for s, y in out]


def _stack(batch, names):
    return {n: np.stack([s[i] for s in batch]) for i, n in enumerate(names)}


def _build(kind):
    """(jax (main, startup, cost, feeds), port (main, startup, cost,
    feeds)) of one model, each under its package's unique_name guard."""
    jmain, jstart = jpt.Program(), jpt.Program()
    tmain, tstart = tir.Program(), tir.Program()
    if kind in ("tiny_lm", "fit_a_line"):
        jcfg = _jax_config(kind)
        tcfg = {"tiny_lm": ttiny, "fit_a_line": tfit}[kind]
        with jun.guard(), jpt.program_guard(jmain, jstart):
            jspec = jcfg.model()
            jspec["optimizer"].minimize(jspec["cost"])
        with tun.guard(), tir.program_guard(tmain, tstart):
            tspec = tcfg.model()
            tspec["optimizer"].minimize(tspec["cost"])
        names = [v.name for v in jspec["feed_list"]]
        batches = []
        while len(batches) < STEPS:
            batches += [_stack(b, names) for b in jspec["reader"]()]
        feeds = batches[:STEPS]
        return ((jmain, jstart, jspec["cost"], feeds),
                (tmain, tstart, tspec["cost"], feeds))
    if kind == "resnet_cifar":
        with jun.guard(), jpt.program_guard(jmain, jstart):
            img = jlayers.data(name="img", shape=[3, 16, 16],
                               dtype="float32")
            label = jlayers.data(name="label", shape=[1], dtype="int64")
            pred = jmodels.resnet(img, class_dim=10, depth=8,
                                  variant="cifar")
            jcost = jlayers.mean(x=jlayers.cross_entropy(input=pred,
                                                         label=label))
            jlayers.accuracy(input=pred, label=label)
            jpt.optimizer.Momentum(learning_rate=0.01,
                                   momentum=0.9).minimize(jcost)
        with tun.guard(), tir.program_guard(tmain, tstart):
            tspec = tresnet.model(variant="cifar", depth=8, image=16,
                                  class_dim=10, batch=4, samples=4 * STEPS,
                                  conv_impl="conv")
            tspec["optimizer"].minimize(tspec["cost"])
        feeds = [_stack(b, ["img", "label"]) for b in tspec["reader"]()]
        return ((jmain, jstart, jcost, feeds),
                (tmain, tstart, tspec["cost"], feeds[:STEPS]))
    cell = kind.split("_")[1]
    with jun.guard(), jpt.program_guard(jmain, jstart):
        jcost = _jax_rnn(cell)
    with tun.guard(), tir.program_guard(tmain, tstart):
        tspec = trnn.model(cell=cell, lstm_impl="scan", **RNN)
        tspec["optimizer"].minimize(tspec["cost"])
    return ((jmain, jstart, jcost, _rnn_feeds(jlod)),
            (tmain, tstart, tspec["cost"], _rnn_feeds(tlod)))


def _jax_train(jmain, jstart, jcost, feeds):
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    jexe = jpt.Executor(jpt.CPUPlace())
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jexe.run(jstart)
        state = {n: np.asarray(jscope.find_var(n)) for n in persist
                 if jscope.find_var(n) is not None}
        losses = [float(np.asarray(jexe.run(jmain, feed=f,
                                            fetch_list=[jcost])[0])
                        .reshape(-1)[0]) for f in feeds]
        final = {n: np.asarray(jscope.find_var(n)) for n in state}
    return state, losses, final, jexe.stats


def _port_train(tmain, tstart, tcost, feeds, state, use_jit=True):
    texe = TExecutor("cpu")
    tscope = TScope()
    texe.run(tstart, scope=tscope)
    scope_from_numpy(state, device="cpu", scope=tscope)
    losses = [float(texe.run(tmain, feed=f, fetch_list=[tcost],
                             scope=tscope, use_jit=use_jit)[0]
                    .reshape(-1)[0]) for f in feeds]
    return losses, scope_to_numpy(tscope, names=state), texe.stats


def _rel(got, want):
    """The largest error over max(1, the largest magnitude of want)."""
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1.0))


@pytest.fixture(scope="module", params=["tiny_lm", "resnet_cifar",
                                        "text_lstm", "text_gru",
                                        "fit_a_line"])
def parity_run(request):
    (jm, js, jc, jf), (tm, ts, tc, tf) = _build(request.param)
    state, jlosses, jfinal, jstats = _jax_train(jm, js, jc, jf)
    tlosses, tfinal, tstats = _port_train(tm, ts, tc, tf, state)
    elosses, efinal, _ = _port_train(tm, ts, tc, tf, state, use_jit=False)
    return dict(kind=request.param, jlosses=jlosses, jfinal=jfinal,
                jstats=jstats, tlosses=tlosses, tfinal=tfinal,
                tstats=tstats, elosses=elosses, efinal=efinal)


def test_compiled_losses_and_persistables_match_jax(parity_run):
    r = parity_run
    np.testing.assert_allclose(r["tlosses"], r["jlosses"], rtol=REL_TOL,
                               atol=0, err_msg=r["kind"])
    assert sorted(r["tfinal"]) == sorted(r["jfinal"])
    for name, want in r["jfinal"].items():
        assert _rel(r["tfinal"][name], want) <= REL_TOL, (r["kind"], name)


def test_compiled_path_is_bit_identical_to_eager(parity_run):
    r = parity_run
    assert r["tlosses"] == r["elosses"], r["kind"]
    for name, want in r["efinal"].items():
        assert np.array_equal(r["tfinal"][name], want), (r["kind"], name)


def test_every_step_ran_compiled_as_in_jax(parity_run):
    r = parity_run
    # the startup program and the STEPS steps: one warm-up, one capture
    # run, then runs through the static buffers; no graph on the CPU
    assert r["tstats"]["jit_runs"] == r["jstats"]["jit_runs"] == 1 + STEPS
    assert r["tstats"]["eager_runs"] == r["jstats"]["eager_runs"] == 0
    assert r["tstats"]["graph_captures"] == r["tstats"]["graph_replays"] == 0


# -- versions -----------------------------------------------------------------

def test_program_uid_and_version_move_as_in_jax():
    for mod, Program in ((tir, tir.Program), (jpt, jpt.Program)):
        a, b = Program(), Program()
        assert a._uid != b._uid
        v0 = a._version
        blk = a.global_block()
        x = blk.create_var(name="x", shape=(2,), dtype="float32")
        blk.append_op("scale", inputs={"X": [x]}, outputs={"Out": [x]},
                      attrs={"scale": 2.0})
        assert a._version == v0 + 1
        blk.insert_op(0, "scale", inputs={"X": [x]}, outputs={"Out": [x]},
                      attrs={"scale": 2.0})
        assert a._version == v0 + 2
        c = a.clone()
        assert c._uid not in (a._uid, b._uid)
        assert len(c.global_block().ops) == 2


def test_scope_names_version_moves_only_on_new_names():
    for S in (TScope, jpt.Scope):
        s = S()
        v = s._names_version
        s.set_var("a", 1)
        assert s._names_version == v + 1
        s.set_var("a", 2)
        assert s._names_version == v + 1
        s.erase("a")
        assert s._names_version == v + 2


# -- the cache ----------------------------------------------------------------

def _fit(pkg="port"):
    if pkg == "port":
        main, start = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, start):
            spec = tfit.model()
            spec["optimizer"].minimize(spec["cost"])
    else:
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            spec = _jax_config("fit_a_line").model()
            spec["optimizer"].minimize(spec["cost"])
    feeds = [_stack(b, ["x", "y"]) for b in spec["reader"]()]
    return main, start, spec["cost"], feeds


def test_a_changed_feed_shape_and_a_mutated_program_make_new_entries():
    main, start, cost, feeds = _fit()
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(start, scope=scope)
    for _ in range(3):
        exe.run(main, feed=feeds[0], fetch_list=[cost], scope=scope)
    n = len(exe._cache)
    half = {k: v[:8] for k, v in feeds[1].items()}
    exe.run(main, feed=half, fetch_list=[cost], scope=scope)
    assert len(exe._cache) == n + 1
    blk = main.global_block()
    out = blk.create_var(name="cost_x2", shape=(1,), dtype="float32")
    blk.append_op("scale", inputs={"X": [cost]}, outputs={"Out": [out]},
                  attrs={"scale": 2.0})
    got = exe.run(main, feed=feeds[0], fetch_list=[cost, out], scope=scope)
    assert len(exe._cache) == n + 2
    assert float(got[1].reshape(-1)[0]) == 2 * float(got[0].reshape(-1)[0])


def test_a_ragged_step_gets_an_entry_per_longest_sequence():
    (_, _), (tm, ts, tc, _) = (None, None), _build("text_gru")[1]
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(ts, scope=scope)

    def feed(lengths):
        seqs = [np.arange(n, dtype=np.int64).reshape(n, 1) for n in lengths]
        return {"words": tlod.build_lod_tensor(seqs),
                "label": np.zeros((len(lengths), 1), np.int64)}

    exe.run(tm, feed=feed([3, 5, 4, 2]), fetch_list=[tc], scope=scope)
    n = len(exe._cache)
    # the same total of words, another longest sequence
    exe.run(tm, feed=feed([3, 6, 3, 2]), fetch_list=[tc], scope=scope)
    assert len(exe._cache) == n + 1


def test_the_cache_evicts_the_least_recently_used_step():
    main, start, cost, feeds = _fit()
    exe, scope = TExecutor("cpu"), TScope()
    exe.graph_cache_limit = 2
    exe.run(start, scope=scope)
    keys = []
    for b in (16, 8, 4):
        f = {k: v[:b] for k, v in feeds[0].items()}
        exe.run(main, feed=f, fetch_list=[cost], scope=scope)
        keys.append(next(reversed(exe._cache)))
    assert list(exe._cache) == keys[1:]


def test_a_scope_value_replaced_between_runs_is_what_the_next_run_reads(
        tmp_path):
    """load_persistables between compiled runs: the next run reads the
    loaded values in both packages."""
    out = {}
    for pkg in ("jax", "port"):
        main, start, cost, feeds = _fit(pkg)
        if pkg == "jax":
            exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
            with jpt.scope_guard(scope):
                exe.run(start)
                jpt.io.save_persistables(exe, str(tmp_path / "ck"), main)
                losses = [float(np.asarray(exe.run(
                    main, feed=f, fetch_list=[cost])[0]).reshape(-1)[0])
                    for f in feeds[:3]]
                jpt.io.load_persistables(exe, str(tmp_path / "ck"), main)
                losses.append(float(np.asarray(exe.run(
                    main, feed=feeds[0], fetch_list=[cost])[0])
                    .reshape(-1)[0]))
        else:
            exe, scope = TExecutor("cpu"), TScope()
            exe.run(start, scope=scope)
            scope_from_numpy(out["state"], device="cpu", scope=scope)
            losses = [float(exe.run(main, feed=f, fetch_list=[cost],
                                    scope=scope)[0].reshape(-1)[0])
                      for f in feeds[:3]]
            with scope_guard(scope):
                tio.load_persistables(exe, str(tmp_path / "ck"), main)
            losses.append(float(exe.run(main, feed=feeds[0],
                                        fetch_list=[cost],
                                        scope=scope)[0].reshape(-1)[0]))
        if pkg == "jax":
            out["state"] = {v.name: np.asarray(scope.find_var(v.name))
                            for v in main.list_vars() if v.persistable}
            import pickle
            for n in out["state"]:
                with open(str(tmp_path / "ck" / n), "rb") as f:
                    out["state"][n] = pickle.load(f)["data"]
        out[pkg] = losses
    # after the load the step sees the saved start again: step 1's loss
    assert out["port"][3] == out["port"][0]
    np.testing.assert_allclose(out["port"], out["jax"], rtol=REL_TOL)


def test_state_is_updated_in_place_from_the_capture_run_on():
    main, start, cost, feeds = _fit()
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(start, scope=scope)
    w = main.all_parameters()[0].name
    exe.run(main, feed=feeds[0], fetch_list=[cost], scope=scope)
    exe.run(main, feed=feeds[1], fetch_list=[cost], scope=scope)
    t = scope.find_var(w)
    before = t.clone()
    exe.run(main, feed=feeds[2], fetch_list=[cost], scope=scope)
    assert scope.find_var(w) is t
    assert not torch.equal(t, before)


def _fit_alone(main, start, cost, feeds, seed):
    """The state of a scope that ran ``feeds`` alone from startup with
    ``seed``, and its losses."""
    exe, scope = TExecutor("cpu"), TScope()
    start.random_seed = seed
    exe.run(start, scope=scope)
    losses = [exe.run(main, feed=f, fetch_list=[cost], scope=scope)[0]
              for f in feeds]
    return losses, scope_to_numpy(scope)


def test_one_executor_keeps_the_steps_of_two_scopes_apart():
    """One Executor runs one program in two scopes, interleaved: each
    scope ends as a run alone does, and the first is untouched while the
    second trains."""
    main, start, cost, feeds = _fit()
    alone = {s: _fit_alone(main, start, cost, feeds[:4], s) for s in (1, 2)}
    exe, scopes = TExecutor("cpu"), {}
    for s in (1, 2):
        scopes[s] = TScope()
        start.random_seed = s
        exe.run(start, scope=scopes[s])
    losses = {1: [], 2: []}
    for f in feeds[:3]:
        for s in (1, 2):
            losses[s].append(exe.run(main, feed=f, fetch_list=[cost],
                                     scope=scopes[s])[0])
    held = scope_to_numpy(scopes[1])
    losses[2].append(exe.run(main, feed=feeds[3], fetch_list=[cost],
                             scope=scopes[2])[0])
    for n, v in scope_to_numpy(scopes[1]).items():
        assert np.array_equal(v, held[n]), n
    losses[1].append(exe.run(main, feed=feeds[3], fetch_list=[cost],
                             scope=scopes[1])[0])
    for s in (1, 2):
        want_losses, want = alone[s]
        for a, b in zip(losses[s], want_losses):
            assert np.array_equal(a, b), s
        got = scope_to_numpy(scopes[s])
        for n, v in want.items():
            assert np.array_equal(got[n], v), (s, n)
    w = main.all_parameters()[0].name
    assert scopes[1].find_var(w) is not scopes[2].find_var(w)
    assert len([k for k in exe._cache if k[1] == main._uid]) == 2


def test_each_scope_draws_from_its_own_generator_on_the_compiled_path():
    def program():
        main = tir.Program()
        blk = main.global_block()
        r = blk.create_var(name="r", shape=(3, 5), dtype="float32")
        blk.append_op("uniform_random", outputs={"Out": [r]},
                      attrs={"shape": [3, 5], "dtype": "float32",
                             "min": -1.0, "max": 1.0})
        return main, r

    def scope(seed):
        s = TScope()
        s.set_var(texec.RNG_VAR, torch.Generator().manual_seed(seed))
        return s

    main, r = program()
    alone = {}
    for seed in (3, 4):
        sc = scope(seed)
        alone[seed] = [TExecutor("cpu").run(main, fetch_list=[r], scope=sc,
                                            use_jit=False)[0]
                       for _ in range(4)]
    exe, scopes = TExecutor("cpu"), {seed: scope(seed) for seed in (3, 4)}
    got = {3: [], 4: []}
    for _ in range(4):
        for seed in (3, 4):
            got[seed].append(exe.run(main, fetch_list=[r],
                                     scope=scopes[seed])[0])
    for seed in (3, 4):
        for a, b in zip(got[seed], alone[seed]):
            assert np.array_equal(a, b), seed
    assert not np.array_equal(got[3][0], got[4][0])


def test_the_steps_of_a_collected_scope_are_freed():
    main, start, cost, feeds = _fit()
    exe = TExecutor("cpu")
    kept = TScope()
    exe.run(start, scope=kept)
    gone = TScope()
    exe.run(start, scope=gone)
    for sc in (kept, gone):
        for f in feeds[:2]:
            exe.run(main, feed=f, fetch_list=[cost], scope=sc)

    def serials():
        return sorted({k[0] for k in exe._cache if k[1] == main._uid})

    assert len(serials()) == 2
    del gone, sc
    import gc
    gc.collect()
    exe.run(main, feed=feeds[2], fetch_list=[cost], scope=kept)
    assert serials() == [exe._scope_serial(kept)]


# -- repeat -------------------------------------------------------------------

def test_repeat_equals_single_runs_in_both_packages():
    main, start, cost, feeds = _fit()
    finals = []
    for rep in (True, False):
        exe, scope = TExecutor("cpu"), TScope()
        exe.run(start, scope=scope)
        exe.run(main, feed=feeds[1], fetch_list=[cost], scope=scope)
        exe.run(main, feed=feeds[1], fetch_list=[cost], scope=scope)
        if rep:
            got = exe.run(main, feed=feeds[0], fetch_list=[cost],
                          scope=scope, repeat=3)
        else:
            for _ in range(3):
                got = exe.run(main, feed=feeds[0], fetch_list=[cost],
                              scope=scope)
        finals.append((got[0], scope_to_numpy(scope)))
    assert np.array_equal(finals[0][0], finals[1][0])
    for n, v in finals[1][1].items():
        assert np.array_equal(finals[0][1][n], v), n
    jmain, jstart, jcost, jfeeds = _fit("jax")
    jfinals = []
    for rep in (True, False):
        exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        with jpt.scope_guard(scope):
            exe.run(jstart)
            if rep:
                got = exe.run(jmain, feed=jfeeds[0], fetch_list=[jcost],
                              repeat=3)
            else:
                for _ in range(3):
                    got = exe.run(jmain, feed=jfeeds[0], fetch_list=[jcost])
            jfinals.append(np.asarray(got[0]))
    np.testing.assert_allclose(jfinals[0], jfinals[1], rtol=1e-6)


def test_repeat_off_the_compiled_path_raises_in_both_packages():
    main, start, cost, feeds = _fit()
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(start, scope=scope)
    with pytest.raises(ValueError, match="jit path"):
        exe.run(main, feed=feeds[0], fetch_list=[cost], scope=scope,
                use_jit=False, repeat=2)
    jmain, jstart, jcost, jfeeds = _fit("jax")
    jexe = jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(jpt.Scope()):
        jexe.run(jstart)
        with pytest.raises(ValueError, match="jit path"):
            jexe.run(jmain, feed=jfeeds[0], fetch_list=[jcost],
                     use_jit=False, repeat=2)


# -- async fetches and the run counters ---------------------------------------

def _counter_sequence(pkg, tmp_path):
    """startup, STEPS steps with lazy and synchronous fetches, a save
    program, a check_nan_inf run: the Executor's counters after each."""
    main, start, cost, feeds = _fit(pkg)
    keys = ("jit_runs", "eager_runs", "hybrid_runs", "lazy_fetches",
            "fetch_sync_count")
    seen = []
    if pkg == "jax":
        exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        guard, io_mod = jpt.scope_guard(scope), jpt.io
    else:
        exe, scope = TExecutor("cpu"), TScope()
        guard, io_mod = scope_guard(scope), tio
    with guard:
        exe.run(start)
        seen.append({k: exe.stats[k] for k in keys})
        for i, f in enumerate(feeds[:STEPS]):
            outs = exe.run(main, feed=f, fetch_list=[cost, cost],
                           sync=(i % 2 == 1))
            if i == 0:
                assert isinstance(outs[0], (texec.AsyncFetch,
                                            jpt.pipeline.AsyncFetch))
                assert exe.stats["fetch_sync_count"] == 0
                a = float(outs[0])
                assert float(outs[0]) == a and outs[0].ready
            seen.append({k: exe.stats[k] for k in keys})
        io_mod.save_persistables(exe, str(tmp_path / pkg), main)
        seen.append({k: exe.stats[k] for k in keys})
        exe.check_nan_inf = True
        exe.run(main, feed=feeds[0], fetch_list=[cost])
        seen.append({k: exe.stats[k] for k in keys})
    return seen


def test_run_and_fetch_counters_move_as_in_jax(tmp_path):
    assert _counter_sequence("port", tmp_path) == \
        _counter_sequence("jax", tmp_path)


def test_async_fetch_handles_have_the_jax_api():
    main, start, cost, feeds = _fit()
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(start, scope=scope)
    h, h2 = exe.run(main, feed=feeds[0], fetch_list=[cost, cost],
                    scope=scope, sync=False)
    assert exe.stats["lazy_fetches"] == 2 and h.ready
    assert repr(h) == "AsyncFetch(ready)"
    h.block()
    v = float(h)
    assert exe.stats["fetch_sync_count"] == 1
    assert np.asarray(h).reshape(-1)[0] == v == h.numpy().reshape(-1)[0]
    assert h.value() is h.value() and repr(h) == "AsyncFetch(materialized)"
    assert exe.stats["fetch_sync_count"] == 1
    assert float(h2) == v and exe.stats["fetch_sync_count"] == 2


# -- NaN / Inf ----------------------------------------------------------------

def test_check_nan_inf_names_the_same_variable_as_jax():
    x = np.ones((4, 13), np.float32)
    x[1, 3] = np.inf
    y = np.zeros((4, 1), np.float32)
    names = []
    for pkg in ("jax", "port"):
        main, start, cost, _ = _fit(pkg)
        if pkg == "jax":
            exe = jpt.Executor(jpt.CPUPlace(), check_nan_inf=True)
            with jpt.scope_guard(jpt.Scope()):
                exe.run(start)
                with pytest.raises(FloatingPointError) as e:
                    exe.run(main, feed={"x": x, "y": y}, fetch_list=[cost])
        else:
            with tflags_guard(check_nan_inf=True):
                exe, scope = TExecutor("cpu"), TScope()
                exe.run(start, scope=scope)
                with pytest.raises(FloatingPointError) as e:
                    exe.run(main, feed={"x": x, "y": y}, fetch_list=[cost],
                            scope=scope)
                assert exe.stats["eager_runs"] == 2
                assert exe.stats["jit_runs"] == 0
        names.append(str(e.value))
    assert names[0] == names[1] and "NaN/Inf detected in" in names[0]


# -- a capture that fails -----------------------------------------------------

# calls of test_host_read; its second is the compiled path's capture run
_HOST_READ_CALLS = [0]


@tregistry.register_op("test_host_read", no_gradient=True)
def _test_host_read(ctx):
    """Reads a value back to the host, which a capture on the card
    refuses: on the CPU its second call (the run that stands in for the
    capture) raises that refusal."""
    x = ctx.input("X")
    _HOST_READ_CALLS[0] += 1
    if _HOST_READ_CALLS[0] == 2:
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    ctx.set_output("Out", x * float(x.abs().max().item()))


def _host_read_program():
    main = tir.Program()
    blk = main.global_block()
    x = blk.create_var(name="x", shape=(4,), dtype="float32")
    out = blk.create_var(name="out", shape=(4,), dtype="float32")
    blk.append_op("test_host_read", inputs={"X": [x]},
                  outputs={"Out": [out]})
    return main, out


def test_a_failed_capture_warns_falls_back_and_computes_the_result():
    main, out = _host_read_program()
    exe, scope = TExecutor("cpu"), TScope()
    x = np.array([1.0, -3.0, 2.0, 0.5], np.float32)
    _HOST_READ_CALLS[0] = 0
    exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    with pytest.warns(RuntimeWarning, match="test_host_read"):
        got = exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(got[0], x * 3.0)
    assert exe.stats["eager_runs"] == 1 and exe.stats["jit_runs"] == 1
    assert main._uid in exe._force_eager and not exe._cache
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
        # the next program still takes the compiled path
        fmain, fstart, cost, feeds = _fit()
        exe.run(fstart, scope=scope)
        for f in feeds[:3]:
            exe.run(fmain, feed=f, fetch_list=[cost], scope=scope)
    assert exe.stats["jit_runs"] == 1 + 4
    assert all(e.ready for e in exe._cache.values() if e.runs > 1)


def test_a_step_that_draws_random_numbers_draws_as_the_eager_run():
    def program():
        main = tir.Program()
        main.random_seed = 7
        blk = main.global_block()
        r = blk.create_var(name="r", shape=(3, 5), dtype="float32")
        blk.append_op("uniform_random", outputs={"Out": [r]},
                      attrs={"shape": [3, 5], "dtype": "float32",
                             "min": -1.0, "max": 1.0})
        return main, r

    draws = []
    for use_jit in (True, False):
        main, r = program()
        exe, scope = TExecutor("cpu"), TScope()
        draws.append([exe.run(main, fetch_list=[r], scope=scope,
                              use_jit=use_jit)[0] for _ in range(4)])
    for a, b in zip(*draws):
        assert np.array_equal(a, b)
    assert not np.array_equal(draws[0][1], draws[0][2])
