"""The conv-net slice's ops on the card, where the CPU tests cannot reach:

- ``dropout`` in a captured step draws a new mask at every replay of the
  graph (the scope's generator registered with it), and two Executors
  from one seed draw the same masks;
- ``edit_distance`` and ``auc`` run inside a captured step: one capture,
  a replay a run, no fallback to the per-op path (no value read back
  to the host), equal to the per-op path;
- the conv3x3 kernel at VGG-16's first conv, [32, 224, 224, 3] -> 64
  (C = 3, K = 27), against its plain version (``CONV_REL_TOL`` 2e-5 of
  the largest magnitude);
- ``PADDLE_TPU_CONV_LAYOUT=nhwc`` runs the conv on ``channels_last``
  tensors and matches the default conv (1e-5 of the largest magnitude),
  its output NCHW-contiguous.

JAX-free, so that it runs where the card is.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu_torch.ops  # noqa: E402,F401
from paddle_tpu_torch.core import ir  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope  # noqa: E402

CONV_REL_TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _one_op(op_type, inputs, outputs, attrs=None, seed=None):
    main = ir.Program()
    if seed is not None:
        main.random_seed = seed
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
def test_dropout_draws_anew_at_each_replay(cuda_device):
    x = np.ones((64, 512), np.float32)
    main, feed = _one_op("dropout", {"X": [("x", x)]},
                         {"Out": ["o"], "Mask": ["m"]},
                         {"dropout_prob": 0.5}, seed=5)
    runs = []
    for _ in range(2):
        exe, scope = Executor(cuda_device), Scope()
        runs.append([exe.run(main, feed=feed, fetch_list=["m"],
                             scope=scope)[0] for _ in range(5)])
        assert exe.stats["graph_captures"] == 1
        assert exe.stats["graph_replays"] == 4
        assert exe.stats["eager_runs"] == 0
    masks = runs[0]
    for a in range(5):
        assert abs(float(masks[a].mean()) - 0.5) < 0.02
        for b in range(a):
            assert not np.array_equal(masks[a], masks[b]), (a, b)
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)


def _metric_program():
    rng = np.random.RandomState(3)
    p = rng.rand(64).astype(np.float32)
    feed = {"prob": np.stack([1 - p, p], 1),
            "label": rng.randint(0, 2, (64, 1)).astype(np.int64),
            "hyp": rng.randint(0, 5, (16, 12)).astype(np.int64),
            "ref": rng.randint(0, 5, (16, 9)).astype(np.int64)}
    main = ir.Program()
    blk = main.global_block()
    for n, a in feed.items():
        blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype))
    for n in ("auc", "dist", "num"):
        blk.create_var(name=n, dtype=None)
    blk.append_op(type="auc", inputs={"Out": ["prob"], "Label": ["label"]},
                  outputs={"AUC": ["auc"]}, attrs={"num_thresholds": 200})
    blk.append_op(type="edit_distance",
                  inputs={"Hyps": ["hyp"], "Refs": ["ref"]},
                  outputs={"Out": ["dist"], "SequenceNum": ["num"]},
                  attrs={"normalized": True})
    return main, feed


@pytest.mark.cuda
def test_edit_distance_and_auc_in_a_captured_step(cuda_device):
    main, feed = _metric_program()
    fetch = ["auc", "dist", "num"]
    exe, scope = Executor(cuda_device), Scope()
    runs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(3)]
    assert exe.stats["graph_captures"] == 1
    assert exe.stats["graph_replays"] == 2
    assert exe.stats["eager_runs"] == 0 and exe.stats["hybrid_runs"] == 0
    eager = Executor(cuda_device).run(main, feed=feed, fetch_list=fetch,
                                      scope=Scope(), use_jit=False)
    cpu = Executor("cpu").run(main, feed=feed, fetch_list=fetch,
                              scope=Scope(), use_jit=False)
    for got in runs:
        for g, e, c in zip(got, eager, cpu):
            np.testing.assert_array_equal(g, e)
            np.testing.assert_allclose(g, c, rtol=1e-6, atol=1e-6)
    assert runs[0][2].dtype == np.int64 and runs[0][2].tolist() == [16]


@pytest.mark.cuda
def test_conv3x3_at_vgg16_first_conv(cuda_device):
    from paddle_tpu_torch.kernels import conv3x3
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand(32, 224, 224, 3, generator=g, device=cuda_device)
    w = torch.randn(3, 3, 3, 64, generator=g, device=cuda_device) * 0.27
    got = conv3x3.conv3x3_s1_nhwc(x, w)
    want = conv3x3.conv3x3_reference(x, w)
    again = conv3x3._launch(x, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= CONV_REL_TOL, err
    assert torch.equal(got, again)
    assert tuple(got.shape) == (32, 224, 224, 64)


@pytest.mark.cuda
def test_nhwc_knob_runs_channels_last_and_matches_the_default(
        cuda_device, monkeypatch):
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import explicit_grads, nn_ops
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(8, 32, 28, 28, generator=g, device=cuda_device)
    w = torch.randn(48, 32, 3, 3, generator=g, device=cuda_device) * 0.08
    dy = torch.randn(8, 48, 28, 28, generator=g, device=cuda_device)
    # float32 is float32: cuDNN may pick TF32 algorithms otherwise, and
    # another for each layout
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.delenv("PADDLE_TPU_CONV_LAYOUT", raising=False)
    monkeypatch.delenv("PADDLE_TPU_CONV_IMPL", raising=False)
    base = nn_ops.conv2d_apply(x, w, [1, 1], [1, 1], [1, 1], 1)
    bdx, bdw = explicit_grads._conv_native_grad(x, w, dy, [1, 1], [1, 1],
                                                [1, 1], 1, True, True)
    monkeypatch.setenv("PADDLE_TPU_CONV_LAYOUT", "nhwc")
    xo, wo = nn_ops._native_operands(x, w, [1, 1], [1, 1], [1, 1], 1)[:2]
    assert xo.is_contiguous(memory_format=torch.channels_last)
    assert wo.is_contiguous(memory_format=torch.channels_last)
    got = nn_ops.conv2d_apply(x, w, [1, 1], [1, 1], [1, 1], 1)
    gdx, gdw = explicit_grads._conv_native_grad(x, w, dy, [1, 1], [1, 1],
                                                [1, 1], 1, True, True)
    torch.cuda.synchronize()
    for a, b in ((got, base), (gdx, bdx), (gdw, bdw)):
        assert a.is_contiguous()
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5
    plain = F.conv2d(x.double(), w.double(), None, 1, 1)
    assert float((got.double() - plain).abs().max()
                 / plain.abs().max()) <= 1e-5
