"""Checkpoints (``paddle_tpu_torch/checkpoint.py``) against the JAX
package's (``paddle_tpu/checkpoint.py``), on the CPU: the counterparts
of ``tests/test_checkpoint.py`` (without the mesh layouts) and of the
hardened-checkpoint tests of ``tests/test_resilience.py``.

- the async handle, a torn checkpoint rejected, retention ordered by
  step first and pruned so;
- corruption found by the CRC32 with a fallback and its event, no half
  install, the fallback confined to retention siblings, the manifest's
  own CRC;
- checkpoints crossing the packages both ways, bit for bit, and the
  same state written to the same bytes by both;
- a bfloat16 shard, which the port loads and the JAX package refuses
  (a fault of the reference: ROADMAP, faults of the reference);
- the snapshot finished before an async save returns (the compiled step
  writes the scope's tensors in place), the loaded values not aliasing
  the staged arrays, and a restore into an Executor whose step is
  already captured.

Tolerance: none, every comparison is exact.
"""
import json
import os
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import checkpoint as jckpt  # noqa: E402
from paddle_tpu_torch import checkpoint  # noqa: E402
from paddle_tpu_torch import layers, optimizer  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,  # noqa: E402
                                         scope_guard, scope_to_numpy)
from paddle_tpu_torch.param_attr import ParamAttr  # noqa: E402
from paddle_tpu_torch.resilience import events, faults  # noqa: E402
from paddle_tpu_torch.trainer import EndIteration, Trainer  # noqa: E402

import torch_book as book  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    events.clear_events()
    yield
    faults.reset()
    events.clear_events()


def _model(momentum=True):
    """fc(4 -> 3) with named parameters and Momentum: 2 params and their
    2 velocities; (main, scope after the startup)."""
    main, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, startup):
        x = layers.data("x", shape=[4], dtype="float32")
        y = layers.data("y", shape=[1], dtype="int64")
        pred = layers.fc(x, size=3, act="softmax",
                         param_attr=ParamAttr(name="rz_w"),
                         bias_attr=ParamAttr(name="rz_b"))
        loss = layers.mean(layers.cross_entropy(pred, y))
        if momentum:
            optimizer.Momentum(learning_rate=0.1,
                               momentum=0.9).minimize(loss)
    scope = Scope()
    Executor("cpu").run(startup, scope=scope)
    return main, scope


def _w(scope, name="rz_w"):
    return scope.find_var(name).numpy().copy()


def test_async_checkpoint_handle(tmp_path):
    main, scope = _model()
    h = checkpoint.save_checkpoint(str(tmp_path / "ack"), main, scope=scope,
                                   step=7, async_=True)
    assert isinstance(h, checkpoint.AsyncCheckpoint)
    out = h.result(timeout=30)
    assert h.done()
    fresh = Scope()
    assert checkpoint.load_checkpoint(out, main, scope=fresh,
                                      device="cpu") == 7
    assert np.array_equal(_w(fresh), _w(scope))
    assert fresh.find_var("rz_w").device.type == "cpu"


def test_torn_checkpoint_rejected_and_latest_skips_it(tmp_path):
    main, scope = _model()
    root = tmp_path / "root"
    os.makedirs(str(root))
    good = str(root / "ck-1")
    checkpoint.save_checkpoint(good, main, scope=scope, step=1)
    torn = str(root / "ck-2")
    checkpoint.save_checkpoint(torn, main, scope=scope, step=2)
    os.remove(os.path.join(torn, "_COMPLETE"))  # a crash before the marker
    with pytest.raises(IOError, match="missing or torn"):
        checkpoint.load_checkpoint(torn, main, scope=Scope(), device="cpu")
    assert checkpoint.latest_checkpoint(str(root)) == good
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    assert checkpoint.load_latest(str(tmp_path / "none"), main) is None


def _fake_retained(root, step, mtime=None):
    d = os.path.join(root, "ckpt-%08d" % step)
    os.makedirs(d)
    with open(os.path.join(d, "_COMPLETE"), "w") as f:
        json.dump({"sizes": {}}, f)
    if mtime is not None:
        os.utime(d, (mtime, mtime))
    return d


def test_retention_order_is_step_first_mtime_tiebreak(tmp_path):
    root = str(tmp_path)
    now = time.time()
    d1 = _fake_retained(root, 1, now)
    d2 = _fake_retained(root, 2, now)
    d3 = _fake_retained(root, 3, now)
    os.utime(d3, (now - 5, now - 5))  # the highest step, the oldest mtime
    assert checkpoint.latest_checkpoint(root) == d3
    assert checkpoint._previous_complete(d3) == d2
    assert checkpoint._previous_complete(d2) == d1
    assert checkpoint._previous_complete(d1) is None
    assert jckpt.latest_checkpoint(root) == d3


def test_prune_keeps_highest_steps_not_newest_mtimes(tmp_path):
    root = str(tmp_path)
    now = time.time()
    dirs = {s: _fake_retained(root, s, now) for s in (1, 2, 3, 4)}
    os.utime(dirs[4], (now - 60, now - 60))
    checkpoint._prune(root, keep_last=2)
    assert sorted(os.listdir(root)) == ["ckpt-00000003", "ckpt-00000004"]


def test_corruption_detected_and_fallback(tmp_path):
    main, scope = _model()
    root = str(tmp_path / "root")
    d1 = checkpoint.save_checkpoint(root, main, scope=scope, step=1,
                                    keep_last=4)
    w1 = _w(scope)
    scope.set_var("rz_w", scope.find_var("rz_w") + 1.0)
    faults.arm("checkpoint.write", action="corrupt", nth=1, times=1, seed=11)
    d2 = checkpoint.save_checkpoint(root, main, scope=scope, step=2,
                                    keep_last=4)
    faults.reset()
    assert checkpoint.latest_checkpoint(root) == d2  # only the CRC knows
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = checkpoint.load_latest(root, main, scope=scope)
    assert got == (d1, 1)
    assert np.array_equal(_w(scope), w1)
    evs = events.events(kind="checkpoint_fallback")
    assert len(evs) == 1
    assert evs[0]["bad"] == os.path.abspath(d2)
    assert evs[0]["used"] == os.path.abspath(d1)
    with pytest.raises(checkpoint.CheckpointCorruption, match="CRC32"):
        checkpoint.load_checkpoint(d2, main, scope=Scope(), device="cpu",
                                   fallback=False)


def test_corrupt_load_does_not_half_install(tmp_path):
    main, scope = _model()
    d = str(tmp_path / "solo")
    # the second shard written rots
    faults.arm("checkpoint.write", action="corrupt", nth=2, times=1, seed=3)
    checkpoint.save_checkpoint(d, main, scope=scope, step=9)
    faults.reset()
    before = {n: _w(scope, n) + 5.0 for n in ("rz_w", "rz_b")}
    for n, v in before.items():
        scope.set_var(n, torch.from_numpy(v.copy()))
    with pytest.raises(checkpoint.CheckpointCorruption):
        checkpoint.load_checkpoint(d, main, scope=scope)  # no sibling
    for n, v in before.items():
        assert np.array_equal(_w(scope, n), v)


def test_fallback_confined_to_retention_siblings(tmp_path):
    main, scope = _model()
    checkpoint.save_checkpoint(str(tmp_path / "other_model"), main,
                               scope=scope, step=1)
    faults.arm("checkpoint.write", action="corrupt", nth=1, times=1, seed=2)
    d = str(tmp_path / "this_model")
    checkpoint.save_checkpoint(d, main, scope=scope, step=2)
    faults.reset()
    with pytest.raises(checkpoint.CheckpointCorruption):
        checkpoint.load_checkpoint(d, main, scope=scope)
    assert not events.events(kind="checkpoint_fallback")


def test_manifest_corruption_detected(tmp_path):
    main, _ = _model(momentum=False)
    _, scope = _model(momentum=False)
    d = str(tmp_path / "mck")
    # one hit a shard (rz_w, rz_b), then the manifest: hit 3
    faults.arm("checkpoint.write", action="corrupt", nth=3, times=1, seed=4)
    checkpoint.save_checkpoint(d, main, scope=scope, step=1)
    assert faults.hits("checkpoint.write") == 3
    faults.reset()
    assert checkpoint._is_complete(d)  # the sizes still match
    with pytest.raises(checkpoint.CheckpointCorruption, match="manifest"):
        checkpoint.load_checkpoint(d, main, scope=Scope(), device="cpu",
                                   fallback=False)


def test_load_fault_site_raises_before_install(tmp_path):
    main, scope = _model()
    d = checkpoint.save_checkpoint(str(tmp_path / "ck"), main, scope=scope,
                                   step=1)
    faults.arm("checkpoint.load", action="raise", nth=2, times=1)
    fresh = Scope()
    with pytest.raises(faults.FaultError):
        checkpoint.load_checkpoint(d, main, scope=fresh, device="cpu")
    assert fresh.local_var_names() == []
    assert events.events(kind="fault_injected", site="checkpoint.load")


def test_keep_last_retention(tmp_path):
    main, scope = _model()
    root = str(tmp_path / "root")
    for s in range(1, 6):
        checkpoint.save_checkpoint(root, main, scope=scope, step=s,
                                   keep_last=2)
    left = sorted(d for d in os.listdir(root)
                  if not d.endswith((".tmp", ".old")))
    assert left == ["ckpt-%08d" % 4, "ckpt-%08d" % 5]
    d = checkpoint.save_checkpoint(root, main, scope=scope, keep_last=2)
    assert d.endswith("ckpt-%08d" % 6)
    assert checkpoint.load_latest(root, main, scope=Scope(),
                                  device="cpu") == (d, 6)
    with pytest.raises(ValueError):
        checkpoint.save_checkpoint(root, main, scope=scope, keep_last=0)


def test_async_retention_saves_do_not_collide(tmp_path):
    main, scope = _model()
    root = str(tmp_path / "root")
    h1 = checkpoint.save_checkpoint(root, main, scope=scope, async_=True,
                                    keep_last=4)
    h2 = checkpoint.save_checkpoint(root, main, scope=scope, async_=True,
                                    keep_last=4)
    d1, d2 = h1.result(timeout=30), h2.result(timeout=30)
    assert {os.path.basename(d1), os.path.basename(d2)} == \
        {"ckpt-%08d" % 0, "ckpt-%08d" % 1}
    for d in (d1, d2):
        assert checkpoint.load_checkpoint(d, main, scope=Scope(),
                                          device="cpu",
                                          fallback=False) in (0, 1)


def test_async_write_error_reraised_by_result(tmp_path):
    main, scope = _model()
    faults.arm("checkpoint.write", action="raise", nth=1, times=1)
    h = checkpoint.save_checkpoint(str(tmp_path / "ck"), main, scope=scope,
                                   async_=True)
    with pytest.raises(faults.FaultError):
        h.result(timeout=30)
    assert not os.path.exists(str(tmp_path / "ck"))


def test_crc_recorded_per_shard(tmp_path):
    main, scope = _model()
    d = str(tmp_path / "ck")
    checkpoint.save_checkpoint(d, main, scope=scope, step=1)
    with open(os.path.join(d, "_MANIFEST.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest["vars"]) == sorted(
        v.name for v in main.list_vars() if v.persistable)
    for e in manifest["vars"].values():
        assert len(e["files"]) == 1
        assert e["files"][0]["index"] == [[0, s] for s in e["shape"]]
        assert isinstance(e["files"][0]["crc32"], int)


def test_dist_context_is_refused(tmp_path):
    main, scope = _model()
    d = checkpoint.save_checkpoint(str(tmp_path / "ck"), main, scope=scope)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        checkpoint.load_checkpoint(d, main, scope=Scope(),
                                   dist_context=object())
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        checkpoint.load_latest(str(tmp_path), main, dist_context=object())


# -- across the packages ------------------------------------------------------

STEPS = 3


def _trained(kind, pkg):
    """``kind`` built in ``pkg`` and trained STEPS steps from the JAX
    startup's state: (main, scope, the state as numpy)."""
    jmain, jstart, _ = book.build("jax", kind)
    state = book.jax_startup_state(jmain, jstart)
    if pkg == "jax":
        spec_cost = book.build("jax", kind)[2]["cost"].name
        scope = jpt.Scope()
        exe = jpt.Executor(jpt.CPUPlace())
        with jpt.scope_guard(scope):
            for n, v in state.items():
                scope.set_var(n, v)
            for f in book.feeds(kind, "jax", STEPS):
                exe.run(jmain, feed=f, fetch_list=[spec_cost])
        return jmain, scope, {n: np.asarray(scope.find_var(n))
                              for n in state}
    tmain, _, tspec = book.build("port", kind)
    exe, scope = Executor("cpu"), Scope()
    scope_from_numpy(state, device="cpu", scope=scope)
    for f in book.feeds(kind, "port", STEPS):
        exe.run(tmain, feed=f, fetch_list=[tspec["cost"]], scope=scope)
    return tmain, scope, scope_to_numpy(scope, names=state)


@pytest.mark.parametrize("kind", ["fit_a_line", "tiny_lm"])
def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path, kind):
    tmain, tscope, want = _trained(kind, "port")
    d = checkpoint.save_checkpoint(str(tmp_path / "ck"), tmain, scope=tscope,
                                   step=STEPS)
    jmain, _, _ = book.build("jax", kind)
    jscope = jpt.Scope()
    assert jckpt.load_checkpoint(d, jmain, scope=jscope) == STEPS
    for n, w in want.items():
        got = np.asarray(jscope.find_var(n))
        assert got.dtype == w.dtype and np.array_equal(got, w), n


@pytest.mark.parametrize("kind", ["fit_a_line", "tiny_lm"])
def test_jax_checkpoint_loads_in_the_port_bit_for_bit(tmp_path, kind):
    jmain, jscope, want = _trained(kind, "jax")
    d = str(tmp_path / "root")
    jckpt.save_checkpoint(d, jmain, scope=jscope, step=STEPS, keep_last=2)
    tmain, _, _ = book.build("port", kind)
    scope = Scope()
    got_dir, step = checkpoint.load_latest(d, tmain, scope=scope,
                                           device="cpu")
    assert step == STEPS and got_dir.endswith("ckpt-%08d" % STEPS)
    got = scope_to_numpy(scope, names=want)
    for n, w in want.items():
        assert got[n].dtype == w.dtype and np.array_equal(got[n], w), n


def _tree(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as f:
            out[fn] = f.read()
    return out


def test_same_state_writes_the_same_bytes(tmp_path):
    """The JAX package and the port write one state to identical files:
    every shard, the manifest and the marker."""
    jmain, jscope, state = _trained("tiny_lm", "jax")
    tmain, _, _ = book.build("port", "tiny_lm")
    jd = jckpt.save_checkpoint(str(tmp_path / "j"), jmain, scope=jscope,
                               step=5)
    td = checkpoint.save_checkpoint(
        str(tmp_path / "t"), tmain,
        scope=scope_from_numpy(state, device="cpu"), step=5)
    want, got = _tree(jd), _tree(td)
    assert sorted(got) == sorted(want)
    for fn in want:
        assert got[fn] == want[fn], fn


# -- bfloat16 shards ------------------------------------------------------------

def _bf16_program(pkg):
    program = jpt.Program() if pkg == "jax" else ir.Program()
    blk = program.global_block()
    blk.create_var(name="h_bf16", shape=(3, 5), dtype="bfloat16",
                   persistable=True)
    blk.create_var(name="w_f32", shape=(2,), dtype="float32",
                   persistable=True)
    return program


def _bf16_values():
    import ml_dtypes
    rng = np.random.RandomState(0)
    return {"h_bf16": rng.randn(3, 5).astype(ml_dtypes.bfloat16),
            "w_f32": rng.randn(2).astype(np.float32)}


def test_bf16_shard_round_trip_and_jax_files(tmp_path):
    vals = _bf16_values()
    program = _bf16_program("port")
    scope = Scope()
    scope.set_var("h_bf16", torch.from_numpy(
        vals["h_bf16"].view(np.int16).copy()).view(torch.bfloat16))
    scope.set_var("w_f32", torch.from_numpy(vals["w_f32"].copy()))
    d = checkpoint.save_checkpoint(str(tmp_path / "t"), program, scope=scope,
                                   step=1)
    with open(os.path.join(d, "_MANIFEST.json")) as f:
        assert json.load(f)["vars"]["h_bf16"]["dtype"] == "bfloat16"
    fresh = Scope()
    checkpoint.load_checkpoint(d, program, scope=fresh, device="cpu")
    got = fresh.find_var("h_bf16")
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          vals["h_bf16"].view(np.int16))
    # the JAX package writes the same bytes, and the port loads them
    jscope = jpt.Scope()
    for n, v in vals.items():
        jscope.set_var(n, v)
    jd = jckpt.save_checkpoint(str(tmp_path / "j"), _bf16_program("jax"),
                               scope=jscope, step=1)
    assert _tree(jd) == _tree(d)
    fresh = Scope()
    checkpoint.load_checkpoint(jd, program, scope=fresh, device="cpu")
    assert np.array_equal(fresh.find_var("h_bf16").view(torch.int16).numpy(),
                          vals["h_bf16"].view(np.int16))


def test_bf16_shard_is_refused_by_the_jax_package(tmp_path):
    """The fault of the reference: np.load gives a bfloat16 shard back as
    a two-byte void type, which the JAX loader cannot assign into its
    bfloat16 array; it reports CheckpointCorruption. The port views the
    bytes as bfloat16 and loads them."""
    vals = _bf16_values()
    jscope = jpt.Scope()
    for n, v in vals.items():
        jscope.set_var(n, v)
    d = jckpt.save_checkpoint(str(tmp_path / "j"), _bf16_program("jax"),
                              scope=jscope, step=1)
    with pytest.raises(jckpt.CheckpointCorruption, match="dtype"):
        jckpt.load_checkpoint(d, _bf16_program("jax"), scope=jpt.Scope(),
                              fallback=False)
    fresh = Scope()
    assert checkpoint.load_checkpoint(d, _bf16_program("port"), scope=fresh,
                                      device="cpu", fallback=False) == 1


# -- the state updated in place -------------------------------------------------

def test_async_save_snapshots_before_it_returns(tmp_path):
    """The compiled step writes the scope's tensors in place: an async
    save holds its own host copy, taken before it returns, so the
    checkpoint has the values of the call, not the later ones."""
    main, scope = _model()
    want = {n: _w(scope, n) for n in scope.local_var_names()
            if isinstance(scope.find_var(n), torch.Tensor)}
    faults.arm("checkpoint.write", action="raise", nth=99)  # counts hits
    h = checkpoint.save_checkpoint(str(tmp_path / "ck"), main, scope=scope,
                                   step=1, async_=True)
    for n in want:
        scope.find_var(n).add_(1.0)  # in place, as a replay writes
    d = h.result(timeout=30)
    fresh = Scope()
    checkpoint.load_checkpoint(d, main, scope=fresh, device="cpu")
    for n, w in want.items():
        assert np.array_equal(_w(fresh, n), w), n
        assert not np.array_equal(_w(scope, n), w)


def test_loaded_tensors_do_not_alias_the_staged_arrays(tmp_path,
                                                       monkeypatch):
    main, scope = _model()
    d = checkpoint.save_checkpoint(str(tmp_path / "ck"), main, scope=scope)
    staged = []
    real = checkpoint.torch.from_numpy

    def spy(arr):
        staged.append(arr)
        return real(arr)

    monkeypatch.setattr(checkpoint.torch, "from_numpy", spy)
    fresh = Scope()
    checkpoint.load_checkpoint(d, main, scope=fresh, device="cpu")
    assert len(staged) == len(fresh.local_var_names()) > 0
    for arr in staged:
        for n in fresh.local_var_names():
            assert not np.shares_memory(fresh.find_var(n).numpy(), arr), n


def test_restore_into_a_captured_step_runs_from_the_loaded_values(tmp_path):
    """A load between two ``train`` calls whose step is captured: the next
    step runs from the loaded values (the Executor copies a replaced
    scope entry into its captured tensor before the replay)."""
    with scope_guard(Scope()):
        main, startup = ir.Program(), ir.Program()
        with unique_name.guard(), ir.program_guard(main, startup):
            x = layers.data("x", shape=[4], dtype="float32")
            y = layers.data("y", shape=[1], dtype="int64")
            pred = layers.fc(x, size=3, act="softmax")
            loss = layers.mean(layers.cross_entropy(pred, y))
            tr = Trainer(loss, optimizer.Adam(learning_rate=0.05), [x, y],
                         device="cpu", main_program=main,
                         startup_program=startup)
        rng = np.random.RandomState(1)
        rows = [(rng.rand(4).astype("float32"),
                 rng.randint(0, 3, (1,)).astype("int64"))
                for _ in range(4 * 6)]

        def reader(lo, hi):
            return lambda: ([rows[i] for i in range(b * 4, b * 4 + 4)]
                            for b in range(lo, hi))

        losses = []

        def handler(e):
            if isinstance(e, EndIteration):
                losses.append(e.cost)

        tr.train(reader(0, 3), event_handler=handler, pipeline=False)
        assert tr.exe.stats["graph_replays"] == 0  # the CPU stands in
        saved = tr.save_checkpoint(str(tmp_path / "ck"), async_=True)
        d = saved.result(timeout=30)
        tr.train(reader(3, 6), event_handler=handler, pipeline=False)
        after = list(losses)
        checkpoint.load_checkpoint(d, main, device="cpu")
        del losses[:]
        tr.train(reader(3, 6), event_handler=handler, pipeline=False)
        assert losses == after[3:]
        # the startup and 9 steps, all on the compiled path
        assert tr.exe.stats["jit_runs"] == 10
        assert tr.exe.stats["eager_runs"] == 0
