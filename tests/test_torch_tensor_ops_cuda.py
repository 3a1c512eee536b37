"""The dense tensor ops on the card, where the CPU tests cannot reach:

- ``one_hot`` of ids out of [0, depth) gives rows of zeros and leaves the
  CUDA context usable (``F.one_hot`` would end it with a device assert);
- ``argsort`` is stable at ties on the GPU sort (rows long enough for
  its multi-block path);
- ``range``, a host op, runs on the hybrid path;
- the random ops (``uniform_random_batch_size_like``,
  ``gaussian_random_batch_size_like``, ``truncated_gaussian_random``,
  ``sampling_id``) draw anew at every replay of a captured step, and two
  Executors from one seed draw the same;
- ``matmul`` and ``matmul_grad`` under plain and pure AMP against a
  float64 product of the same bfloat16 operands: plain within 1e-5 of
  max(1, the largest magnitude), pure within one bfloat16 ulp of the
  largest magnitude plus 2e-5 of it;
- the ops whose corners take JAX's gradients (``clip``, ``abs`` and the
  clipped activations) captured in a training step with no copy from
  the host, bit-identical to the per-op path.

JAX-free, so that it runs where the card is.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch.ops  # noqa: E402,F401
from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import layers  # noqa: E402
from paddle_tpu_torch.core import ir  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope  # noqa: E402

F32_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _one_op(op_type, inputs, outputs, attrs=None):
    """``op_type`` alone in a program; ``inputs`` {slot: [(name, array)]},
    ``outputs`` {slot: [name]}."""
    main = ir.Program()
    blk = main.global_block()
    ins = {}
    for slot, items in inputs.items():
        ins[slot] = []
        for name, arr in items:
            blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype))
            ins[slot].append(name)
    for names in outputs.values():
        for n in names:
            blk.create_var(name=n, dtype=None)
    blk.append_op(type=op_type, inputs=ins, outputs=dict(outputs),
                  attrs=dict(attrs or {}))
    feed = {n: a for items in inputs.values() for n, a in items}
    return main, feed


@pytest.mark.cuda
def test_one_hot_out_of_range_is_zero_on_the_card(cuda_device):
    ids = np.array([[-1], [4], [2], [-5], [0], [1000]], np.int64)
    main, feed = _one_op("one_hot", {"X": [("x", ids)]}, {"Out": ["o"]},
                         {"depth": 4})
    got, = Executor(cuda_device).run(main, feed=feed, fetch_list=["o"],
                                     scope=Scope(), use_jit=False)
    want = np.zeros((6, 4), np.float32)
    want[2, 2] = want[4, 0] = 1.0
    np.testing.assert_array_equal(got, want)
    torch.cuda.synchronize()
    assert float(torch.ones(3, device=cuda_device).sum()) == 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", [((4, 6), -1), ((3, 5000), -1),
                                        ((5000, 3), 0)])
def test_argsort_is_stable_on_the_card(cuda_device, shape, axis):
    x = np.random.RandomState(1).randint(0, 3, shape).astype(np.float32)
    main, feed = _one_op("argsort", {"X": [("x", x)]},
                         {"Out": ["o"], "Indices": ["i"]}, {"axis": axis})
    out, idx = Executor(cuda_device).run(main, feed=feed,
                                         fetch_list=["o", "i"],
                                         scope=Scope())
    assert idx.dtype == np.int64
    np.testing.assert_array_equal(idx, np.argsort(x, axis=axis,
                                                  kind="stable"))
    np.testing.assert_array_equal(out, np.sort(x, axis=axis))


@pytest.mark.cuda
def test_range_runs_on_the_hybrid_path_on_the_card(cuda_device):
    main, start = ir.Program(), ir.Program()
    with ir.program_guard(main, start):
        bounds = [layers.fill_constant([1], "float32", v)
                  for v in (2.0, 11.0, 3.0)]
        out = main.global_block().create_var(name="r", dtype=None)
        main.global_block().append_op(
            type="range", inputs={"Start": [bounds[0]], "End": [bounds[1]],
                                  "Step": [bounds[2]]},
            outputs={"Out": [out]})
        y = layers.scale(out, scale=0.5)
    exe = Executor(cuda_device)
    for _ in range(3):
        r, half = exe.run(main, fetch_list=["r", y], scope=Scope())
        assert r.dtype == np.int64 and r.tolist() == [2, 5, 8]
        np.testing.assert_array_equal(half, [1.0, 2.5, 4.0])
    assert exe.stats["hybrid_runs"] == 3 and exe.stats["eager_runs"] == 0


def _random_program(seed):
    main = ir.Program()
    main.random_seed = seed
    blk = main.global_block()
    ref = blk.create_var(name="ref", shape=(64, 3), dtype="float32")
    probs = blk.create_var(name="p", shape=(64, 50), dtype="float32")
    for n in ("u", "g", "t", "s"):
        blk.create_var(name=n, dtype=None)
    blk.append_op(type="uniform_random_batch_size_like",
                  inputs={"Input": [ref]}, outputs={"Out": ["u"]},
                  attrs={"shape": [-1, 8], "min": -1.0, "max": 1.0})
    blk.append_op(type="gaussian_random_batch_size_like",
                  inputs={"Input": [ref]}, outputs={"Out": ["g"]},
                  attrs={"shape": [-1, 8], "mean": 0.0, "std": 1.0})
    blk.append_op(type="truncated_gaussian_random", outputs={"Out": ["t"]},
                  attrs={"shape": [64, 8], "mean": 0.0, "std": 1.0})
    blk.append_op(type="sampling_id", inputs={"X": [probs]},
                  outputs={"Out": ["s"]})
    feed = {"ref": np.zeros((64, 3), np.float32),
            "p": np.ones((64, 50), np.float32)}
    return main, feed


@pytest.mark.cuda
def test_random_ops_draw_anew_at_every_replay(cuda_device):
    names = ["u", "g", "t", "s"]
    runs = {}
    for label in ("a", "b"):
        main, feed = _random_program(seed=5)
        exe, scope = Executor(cuda_device), Scope()
        runs[label] = [exe.run(main, feed=feed, fetch_list=names,
                               scope=scope) for _ in range(5)]
        assert exe.stats["graph_captures"] == 1
        assert exe.stats["graph_replays"] == 4
        assert exe.stats["eager_runs"] == 0
    for i in range(1, 5):
        for k, n in enumerate(names):
            assert not np.array_equal(runs["a"][i][k], runs["a"][i - 1][k]), \
                (n, i)
    for ra, rb in zip(runs["a"], runs["b"]):
        for va, vb in zip(ra, rb):
            np.testing.assert_array_equal(va, vb)
    u, g, t, s = runs["a"][-1]
    assert np.abs(u).max() <= 1.0 and np.abs(t).max() <= 2.0
    assert s.dtype == np.int64 and s.min() >= 0 and s.max() <= 49


def _bf16_values(seed, *shape):
    t = torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                         .astype(np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _bf16_ulp(m):
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("pure", [False, True], ids=["plain", "pure"])
@pytest.mark.parametrize("xs,ys,attrs", [
    ((2, 3, 128, 64), (2, 3, 128, 64), {"transpose_Y": True,
                                        "alpha": 0.125}),
    ((2, 3, 128, 64), (64, 96), {}),
    ((64, 128), (64, 96), {"transpose_X": True}),
], ids=["qk", "bcast", "tx"])
def test_matmul_under_amp_against_float64(cuda_device, pure, xs, ys, attrs):
    x, y = _bf16_values(1, *xs), _bf16_values(2, *ys)
    attrs = dict({"transpose_X": False, "transpose_Y": False, "alpha": 1.0},
                 **attrs)
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    y64 = torch.from_numpy(y).double().requires_grad_(True)
    a = x64.transpose(-1, -2) if attrs["transpose_X"] else x64
    b = y64.transpose(-1, -2) if attrs["transpose_Y"] else y64
    want = torch.matmul(a, b) * attrs["alpha"]
    dy = _bf16_values(3, *want.shape)
    wdx, wdw = torch.autograd.grad(want, [x64, y64],
                                   grad_outputs=torch.from_numpy(dy).double())
    fwd, feed = _one_op("matmul", {"X": [("x", x)], "Y": [("y", y)]},
                        {"Out": ["o"]}, attrs)
    bwd, bfeed = _one_op("matmul_grad",
                         {"X": [("x", x)], "Y": [("y", y)],
                          "Out@GRAD": [("d", dy)]},
                         {"X@GRAD": ["dx"], "Y@GRAD": ["dw"]}, attrs)
    for prog in (fwd, bwd):
        amp.enable(prog, pure=pure)
    exe = Executor(cuda_device)
    out, = exe.run(fwd, feed=feed, fetch_list=["o"], scope=Scope(),
                   use_jit=False, return_numpy=False)
    dx, dw = exe.run(bwd, feed=bfeed, fetch_list=["dx", "dw"],
                     scope=Scope(), use_jit=False)
    got = out.double().cpu().numpy()
    w = want.detach().numpy()
    m = np.abs(w).max()
    if pure:
        assert out.dtype == torch.bfloat16
        assert np.abs(got - w).max() <= _bf16_ulp(m) + 2e-5 * m
    else:
        assert out.dtype == torch.float32
        assert np.abs(got - w).max() <= F32_TOL * max(1.0, m)
    for g, ref in ((dx, wdx), (dw, wdw)):
        assert g.dtype == np.float32
        r = ref.numpy()
        assert np.abs(g - r).max() <= F32_TOL * max(1.0, np.abs(r).max())


def _corner_program():
    """An fc whose output passes through every op with a corner
    (``clip``, ``relu6``, ``brelu``, ``hard_sigmoid``, ``soft_relu``,
    ``softshrink``, ``abs``) and two losses that take |x|, their means
    summed and minimized by SGD."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.core import unique_name
    main, start = ir.Program(), ir.Program()
    main.random_seed = start.random_seed = 3
    with unique_name.guard(), ir.program_guard(main, start):
        x = layers.data(name="x", shape=[8], dtype="float32")
        lab = layers.data(name="lab", shape=[8], dtype="float32")
        h = layers.fc(input=x, size=8)
        parts = [layers.clip(h, -0.5, 0.5), layers.relu6(h),
                 layers.brelu(h, t_min=-1.0, t_max=1.0),
                 layers.hard_sigmoid(h), layers.soft_relu(h, threshold=1.0),
                 layers.softshrink(h), layers.abs(h),
                 layers.sigmoid_cross_entropy_with_logits(h, lab),
                 layers.smooth_l1(h, lab)]
        loss = layers.sums([layers.mean(p) for p in parts])
        optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, start, loss


@pytest.mark.cuda
def test_corner_ops_are_captured_with_no_host_copy(cuda_device):
    """The ops whose corners take JAX's gradients fill their bounds on
    the device: a step of them (and their generic grads) is captured
    once and replayed, equal to the per-op path bit for bit."""
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(16, 8).astype(np.float32),
            "lab": rng.rand(16, 8).astype(np.float32)}
    runs = {}
    for use_jit in (True, False):
        main, start, loss = _corner_program()
        exe, scope = Executor(cuda_device), Scope()
        exe.run(start, scope=scope)
        losses = [exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                          use_jit=use_jit)[0] for _ in range(4)]
        runs[use_jit] = (losses, scope.find_var("fc_0.w_0").cpu().numpy())
        if use_jit:
            assert exe.stats["graph_captures"] == 1
            assert exe.stats["graph_replays"] == 3
            assert exe.stats["eager_runs"] == 0
    for a, b in zip(runs[True][0], runs[False][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(runs[True][1], runs[False][1])
