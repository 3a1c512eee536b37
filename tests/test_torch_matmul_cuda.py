"""The blocked matmul on the card: the CUDA kernel against its plain
version at every compiled tiling (ragged shapes included), its shared
memory against the wrapper's count, a second launch that must equal the
first bit for bit, and what it refuses.

JAX-free, so that it runs where the card is. Tolerance: 1e-5 of the
largest magnitude of the plain output (or 1e-5 absolute below 1),
float32 on both sides; the kernel takes its products in 3xTF32 on the
tensor cores, float32-exact, and it and the plain version's k tiles of
``torch.matmul`` sum in other orders, which moves outputs of size ~1-10
by ~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import matmul as tmm  # noqa: E402

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _inputs(shape, seed):
    M, K, N = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.1).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    return x, w, g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 384, 256), (100, 130, 200),
                                   (1, 3, 5), (130, 257, 66)])
def test_kernel_matches_plain_version_at_every_tiling(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, _ = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(shape, seed=7))
    lib = tmm._build.load("matmul")
    for t in tmm.TILINGS:
        assert lib.matmul_smem_bytes(*t) == tmm.smem_bytes(*t)
        cfg = dict(zip(("block_m", "block_n", "block_k"), t))
        kernels.reset_launches()
        got = tmm.matmul(x, w, config=cfg)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["matmul"] == 1
        want = tmm.matmul_reference(x, w, cfg)
        err = float((got - want).abs().max())
        assert err <= TOL * max(1.0, float(want.abs().max())), (t, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 384, 256), (130, 257, 66)])
def test_second_launch_is_bit_identical(cuda_device, shape):
    # no atomics and a fixed order of sums: the same inputs give the
    # same bits, at every tiling
    x, w, _ = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(shape, seed=9))
    for t in tmm.TILINGS:
        cfg = dict(zip(("block_m", "block_n", "block_k"), t))
        a = tmm.matmul(x, w, config=cfg)
        b = tmm.matmul(x, w, config=cfg)
        torch.cuda.synchronize()
        assert torch.equal(a, b), t


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.randn(64, 128, device=cuda_device)
    w = torch.randn(128, 128, device=cuda_device)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="float32"):
        tmm.matmul(x.bfloat16(), w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        tmm.matmul(x, torch.randn(128, 128, device=cuda_device).t())
    with pytest.raises(ValueError, match="w \\[K, N\\]"):
        tmm.matmul(x, w[:64])
    with pytest.raises(ValueError, match="float32"):
        tmm.matmul(x, w, out_dtype=torch.bfloat16)
    assert kernels.launch_counts()["matmul"] == 0
