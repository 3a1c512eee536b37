"""The Executor's compiled path on the card: every kernel on a training
path captured in a CUDA graph and replayed, against the same steps run
eagerly from the same state.

JAX-free, so that it runs where the card is. Tolerance: none. A replay
runs the kernels the capture recorded on the same static buffers, so
losses and state must equal the eager run's bit for bit, and each
kernel's launch count (the capture's delta added at every replay) must
equal the eager run's.
"""
import gc
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import amp, kernels, tune  # noqa: E402
from paddle_tpu_torch.cli import _tune_populations  # noqa: E402
from paddle_tpu_torch.configs import fit_a_line  # noqa: E402
from paddle_tpu_torch.configs import resnet_cifar, text_rnn  # noqa: E402
from paddle_tpu_torch.configs import tiny_lm  # noqa: E402
from paddle_tpu_torch.core import ir, lod, registry  # noqa: E402
from paddle_tpu_torch.core import unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope  # noqa: E402
from paddle_tpu_torch.flags import flags_guard  # noqa: E402
from paddle_tpu_torch.kernels import matmul as tmm  # noqa: E402
from paddle_tpu_torch.trainer import EndIteration, Trainer  # noqa: E402

STEPS = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


@pytest.fixture
def tune_dir(tmp_path):
    """An empty winner cache, so that no winner on the machine reroutes
    a gemm."""
    with flags_guard(tune_cache_dir=str(tmp_path / "tune"), tune=True):
        tune.clear_memory_cache()
        yield str(tmp_path / "tune")
    tune.clear_memory_cache()


def _build(model, **kw):
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        spec = model(**kw)
        spec["optimizer"].minimize(spec["cost"])
    return main, start, spec


def _twin(main, start, cost, feeds):
    """Run ``feeds`` eagerly and compiled from one startup state: per
    mode the losses, the final state, the launch counts and the stats."""
    exe, scope = Executor("cuda"), Scope()
    exe.run(start, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable
             and isinstance(scope.find_var(v.name), torch.Tensor)]
    state = {n: scope.find_var(n).clone() for n in names}
    out = {}
    for use_jit in (False, True):
        exe, scope = Executor("cuda"), Scope()
        for n, t in state.items():
            scope.set_var(n, t.clone())
        torch.cuda.synchronize()
        kernels.reset_launches()
        losses = [exe.run(main, feed=f, fetch_list=[cost], scope=scope,
                          use_jit=use_jit)[0] for f in feeds]
        torch.cuda.synchronize()
        out[use_jit] = dict(
            losses=losses, counts=kernels.launch_counts(),
            final={n: scope.find_var(n).clone() for n in names},
            stats=dict(exe.stats))
        exe.close()
    return out[False], out[True]


def _assert_twins(eager, compiled, kernel_names):
    for a, b in zip(eager["losses"], compiled["losses"]):
        assert np.array_equal(a, b), (eager["losses"], compiled["losses"])
    for n, t in eager["final"].items():
        assert torch.equal(t, compiled["final"][n]), n
    assert compiled["counts"] == eager["counts"]
    for k in kernel_names:
        assert compiled["counts"][k] > 0, (k, compiled["counts"])
    st = compiled["stats"]
    assert st["graph_captures"] == 1 and st["graph_replays"] == STEPS - 1
    assert st["jit_runs"] == STEPS and st["eager_runs"] == 0


def _seed_matmul(main, batch, tiling, dtype=None):
    pops, _ = _tune_populations(main, batch, compute_dtype=dtype)
    cfg = dict(zip(("block_m", "block_n", "block_k"), tiling))
    for kernel, key in pops:
        if kernel == "matmul":
            tune.WinnerCache().put(tune.cache_key(
                tune.device_kind(), "matmul", tune.signature(key)), cfg)
    tune.clear_memory_cache()


def _lm_feeds(spec):
    b = next(iter(spec["reader"]()))
    f = {"toks": np.stack([s[0] for s in b]),
         "tgt": np.stack([s[1] for s in b])}
    return [f] * STEPS


LM = dict(hidden=128, num_heads=2, seq=64, batch=4, samples=4)


@pytest.mark.cuda
def test_lm_step_captures_flash_and_matmul_float32(cuda_device, tune_dir):
    main, start, spec = _build(tiny_lm.model, **LM)
    _seed_matmul(main, LM["batch"], tmm.TILINGS[0])
    eager, compiled = _twin(main, start, spec["cost"], _lm_feeds(spec))
    _assert_twins(eager, compiled, ("flash_attention_fwd",
                                    "flash_attention_bwd_dkv",
                                    "flash_attention_bwd_dq", "matmul"))


@pytest.mark.cuda
def test_pure_amp_lm_step_captures_the_bf16_faces(cuda_device, tune_dir):
    main, start, spec = _build(tiny_lm.model, **LM)
    amp.enable(main, pure=True)
    _seed_matmul(main, LM["batch"], tmm.TILINGS_BF16[0], dtype="bfloat16")
    eager, compiled = _twin(main, start, spec["cost"], _lm_feeds(spec))
    _assert_twins(eager, compiled, ("flash_attention_fwd_bf16",
                                    "flash_attention_bwd_dkv_bf16",
                                    "flash_attention_bwd_dq_bf16",
                                    "matmul_bf16"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [False, "pure"])
def test_resnet_step_captures_conv3x3(cuda_device, tune_dir, mode):
    main, start, spec = _build(resnet_cifar.model, depth=8, image=16,
                               batch=4, samples=4, amp=mode)
    b = next(iter(spec["reader"]()))
    feed = {"img": np.stack([s[0] for s in b]),
            "label": np.stack([s[1] for s in b])}
    # cuDNN's default weight-gradient algorithms are not deterministic:
    # at ResNet-50's shapes two eager steps differ (chip_smoke phase 12)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, compiled = _twin(main, start, spec["cost"], [feed] * STEPS)
    finally:
        torch.backends.cudnn.deterministic = saved
    face = "_bf16" if mode else ""
    _assert_twins(eager, compiled, ("conv3x3_fwd" + face,
                                    "conv3x3_dx" + face))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,bias,mode", [("lstm", True, False),
                                            ("gru", True, False),
                                            ("lstm", False, "pure")])
def test_text_rnn_step_captures_the_cooperative_recurrences(
        cuda_device, tune_dir, cell, bias, mode):
    main, start, spec = _build(text_rnn.model, cell=cell, bias=bias,
                               vocab=200, hidden=128, batch=4, samples=4)
    if mode:
        amp.enable(main, pure=True)
    b = next(iter(spec["reader"]()))
    feed = {"words": lod.build_lod_tensor([s[0] for s in b]),
            "label": np.stack([s[1] for s in b])}
    eager, compiled = _twin(main, start, spec["cost"], [feed] * STEPS)
    _assert_twins(eager, compiled,
                  ("fused_%s%s" % (cell, "_bf16" if mode else ""),))


@registry.register_op("test_card_host_read", no_gradient=True)
def _host_read(ctx):
    """Reads a value back to the host, which a capture refuses."""
    x = ctx.input("X")
    ctx.set_output("Out", x * float(x.abs().max().item()))


@pytest.mark.cuda
def test_a_host_read_falls_back_loudly_and_the_next_program_captures(
        cuda_device, tune_dir):
    main = ir.Program()
    blk = main.global_block()
    x = blk.create_var(name="x", shape=(4,), dtype="float32")
    out = blk.create_var(name="out", shape=(4,), dtype="float32")
    blk.append_op("test_card_host_read", inputs={"X": [x]},
                  outputs={"Out": [out]})
    exe, scope = Executor("cuda"), Scope()
    xs = np.array([1.0, -3.0, 2.0, 0.5], np.float32)
    exe.run(main, feed={"x": xs}, fetch_list=[out], scope=scope)
    with pytest.warns(RuntimeWarning, match="test_card_host_read"):
        got = exe.run(main, feed={"x": xs}, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(got[0], xs * 3.0)
    assert exe.stats["eager_runs"] == 1 and exe.stats["graph_captures"] == 0
    fmain, fstart, spec = _build(fit_a_line.model)
    b = next(iter(spec["reader"]()))
    feed = {"x": np.stack([s[0] for s in b]),
            "y": np.stack([s[1] for s in b])}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exe.run(fstart, scope=scope)
        for _ in range(3):
            exe.run(fmain, feed=feed, fetch_list=[spec["cost"]],
                    scope=scope)
    assert exe.stats["graph_captures"] == 1
    assert exe.stats["graph_replays"] == 2
    # the failed capture's pool is not joined again
    assert list(exe._pool_graphs.values()) == [1]


def _big_program(n):
    main = ir.Program()
    blk = main.global_block()
    x = blk.create_var(name="x", shape=(n, n), dtype="float32")
    a = blk.create_var(name="a", shape=(n, n), dtype="float32")
    b = blk.create_var(name="b", shape=(n, n), dtype="float32")
    m = blk.create_var(name="m", shape=(1,), dtype="float32")
    blk.append_op("scale", inputs={"X": [x]}, outputs={"Out": [a]},
                  attrs={"scale": 2.0})
    blk.append_op("scale", inputs={"X": [a]}, outputs={"Out": [b]},
                  attrs={"scale": 3.0})
    blk.append_op("mean", inputs={"X": [b]}, outputs={"Out": [m]})
    return main, m


@pytest.mark.cuda
def test_an_evicted_graph_frees_its_pool(cuda_device):
    n = 4096  # 64 MiB a float32 value
    big, m = _big_program(n)
    small, ms = _big_program(8)
    exe, scope = Executor("cuda"), Scope()
    exe.graph_cache_limit = 1
    xs = np.ones((n, n), np.float32)
    for _ in range(2):
        got = exe.run(big, feed={"x": xs}, fetch_list=[m], scope=scope)
    assert float(got[0].reshape(-1)[0]) == 6.0
    assert exe.stats["graph_captures"] == 1
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(cuda_device)
    for _ in range(2):
        exe.run(small, feed={"x": np.ones((8, 8), np.float32)},
                fetch_list=[ms], scope=scope)
    assert exe.stats["graph_captures"] == 2 and len(exe._cache) == 1
    gc.collect()
    torch.cuda.empty_cache()
    freed = held - torch.cuda.memory_reserved(cuda_device)
    # the big step's static feed and its two intermediates in the pool
    assert freed >= 3 * n * n * 4, freed


@pytest.mark.cuda
def test_the_graphs_of_several_feed_shapes_share_one_pool(cuda_device):
    """Four feed shapes of one program, each a key and a graph of its
    own: the graphs share the Executor's pool, so after the first the
    card holds only each key's static feed more, not its intermediates
    again."""
    big, m = _big_program(4096)
    exe, scope = Executor("cuda"), Scope()
    shapes = ((4096, 4096), (8192, 2048), (2048, 8192), (16384, 1024))
    value = 64 << 20  # bytes of one float32 value of each shape
    held = []
    for shape in shapes:
        xs = np.ones(shape, np.float32)
        for _ in range(3):
            got = exe.run(big, feed={"x": xs}, fetch_list=[m], scope=scope)
        assert float(got[0].reshape(-1)[0]) == 6.0
        gc.collect()
        torch.cuda.empty_cache()
        held.append(torch.cuda.memory_reserved(cuda_device))
    assert exe.stats["graph_captures"] == 4
    assert exe.stats["graph_replays"] == 8
    assert exe._pool_graphs == {exe._pool: 4}
    # a pool of its own for each graph would add its two intermediates
    for before, after in zip(held, held[1:]):
        assert after - before < value + value // 2, held
    exe.close()
    assert exe._pool is None and not exe._pool_graphs


@pytest.mark.cuda
def test_one_executor_keeps_two_scopes_apart_on_the_card(cuda_device):
    main, start, spec = _build(fit_a_line.model)
    feeds = []
    for b in spec["reader"]():
        feeds.append({"x": np.stack([s[0] for s in b]),
                      "y": np.stack([s[1] for s in b])})
    feeds = feeds[:4]
    names = [v.name for v in main.list_vars() if v.persistable]

    def state(scope):
        return {n: scope.find_var(n).clone() for n in names
                if isinstance(scope.find_var(n), torch.Tensor)}

    alone, scopes, exe = {}, {}, Executor("cuda")
    for seed in (1, 2):
        start.random_seed = seed
        solo, sc = Executor("cuda"), Scope()
        solo.run(start, scope=sc)
        alone[seed] = [solo.run(main, feed=f, fetch_list=[spec["cost"]],
                                scope=sc)[0] for f in feeds], state(sc)
        scopes[seed] = Scope()
        exe.run(start, scope=scopes[seed])
    got = {1: [], 2: []}
    for f in feeds:
        for seed in (1, 2):
            got[seed].append(exe.run(main, feed=f, fetch_list=[spec["cost"]],
                                     scope=scopes[seed])[0])
    for seed in (1, 2):
        for a, b in zip(got[seed], alone[seed][0]):
            assert np.array_equal(a, b), seed
        final = state(scopes[seed])
        for n, t in alone[seed][1].items():
            assert torch.equal(final[n], t), (seed, n)
    assert exe.stats["graph_captures"] == 2


@pytest.mark.cuda
def test_random_draws_of_a_captured_step_equal_the_eager_draws(
        cuda_device):
    def program():
        main = ir.Program()
        main.random_seed = 7
        blk = main.global_block()
        r = blk.create_var(name="r", shape=(64, 33), dtype="float32")
        blk.append_op("uniform_random", outputs={"Out": [r]},
                      attrs={"shape": [64, 33], "dtype": "float32",
                             "min": -1.0, "max": 1.0})
        return main, r

    draws, stats = [], []
    for use_jit in (False, True):
        main, r = program()
        exe, scope = Executor("cuda"), Scope()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            draws.append([exe.run(main, fetch_list=[r], scope=scope,
                                  use_jit=use_jit)[0] for _ in range(5)])
        stats.append((dict(exe.stats), [str(w.message) for w in caught]))
    for a, b in zip(*draws):
        assert np.array_equal(a, b)
    assert not np.array_equal(draws[1][2], draws[1][3])
    st, caught = stats[1]
    if hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        assert st["graph_captures"] == 1 and st["graph_replays"] == 4
        assert not caught
    else:
        assert st["graph_captures"] == 0 and st["eager_runs"] == 4
        assert any("register_generator_state" in c for c in caught)


@pytest.mark.cuda
def test_async_fetches_wait_on_their_event(cuda_device):
    main, start, spec = _build(fit_a_line.model)
    b = next(iter(spec["reader"]()))
    feed = {"x": np.stack([s[0] for s in b]),
            "y": np.stack([s[1] for s in b])}
    exe, scope = Executor("cuda"), Scope()
    exe.run(start, scope=scope)
    handles = [exe.run(main, feed=feed, fetch_list=[spec["cost"]],
                       scope=scope, sync=False)[0] for _ in range(4)]
    handles[-1].block()
    assert all(h.ready for h in handles)
    assert exe.stats["lazy_fetches"] == 4
    assert exe.stats["fetch_sync_count"] == 0
    costs = [float(h) for h in handles]
    assert exe.stats["fetch_sync_count"] == 4
    assert all(np.isfinite(costs)) and costs[-1] < costs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_trainer_is_bit_identical_on_the_card(cuda_device, depth):
    def train(pipelined):
        main, start, spec = _build(fit_a_line.model)
        tr = Trainer(spec["cost"], spec["optimizer"], spec["feed_list"],
                     device="cuda", main_program=main, startup_program=start)
        with flags_guard(log_period=0):
            from paddle_tpu_torch.core.scope import scope_guard
            with scope_guard(Scope()):
                events = []
                tr.train(spec["reader"], num_passes=3,
                         event_handler=events.append, pipeline=pipelined,
                         pipeline_depth=depth)
        return [e.cost for e in events if isinstance(e, EndIteration)], tr

    sync, _ = train(False)
    piped, tr = train(True)
    assert sync == piped
    assert tr.exe.stats["graph_captures"] == 1
    assert tr.exe.stats["lazy_fetches"] == len(sync)
    # the last pass's ring of device slots, refilled in place
    st = tr.pipeline_stats
    assert st["slot_reuse"] == st["batches"] - depth
    assert not st["fallback_sync"]
