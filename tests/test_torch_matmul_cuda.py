"""The blocked matmul on the card: the CUDA kernel against its plain
version at every compiled tiling (ragged shapes included), its shared
memory against the wrapper's count, a second launch that must equal the
first bit for bit, and what it refuses; the same of its bfloat16 face.

JAX-free, so that it runs where the card is. Tolerance: 1e-5 of the
largest magnitude of the plain output (or 1e-5 absolute below 1),
float32 on both sides; the kernel takes its products in 3xTF32 on the
tensor cores, float32-exact, and it and the plain version's k tiles of
``torch.matmul`` sum in other orders, which moves outputs of size ~1-10
by ~1e-6.
"""
import math

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
    for a, b in ((x.double(), w.double()), (x.half(), w.half()),
                 (x.bfloat16(), w), (x, w.bfloat16())):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tmm.matmul(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        tmm.matmul(x, torch.randn(128, 128, device=cuda_device).t())
    with pytest.raises(ValueError, match="contiguous"):
        tmm.matmul(x.bfloat16(),
                   torch.randn(128, 128, device=cuda_device).bfloat16().t())
    with pytest.raises(ValueError, match="w \\[K, N\\]"):
        tmm.matmul(x, w[:64])
    with pytest.raises(ValueError, match="writes torch.float32, not"):
        tmm.matmul(x, w, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not torch.float16"):
        tmm.matmul(x.bfloat16(), w.bfloat16(), out_dtype=torch.float16)
    assert set(kernels.launch_counts().values()) == {0}


# -- the bfloat16 face (AMP) --------------------------------------------------
#
# bfloat16 operands, float32 sums, written in bfloat16 or float32. The
# plain version sums the same k tiles exactly in float32 in another
# order and rounds once: a bfloat16 output within one bfloat16 ulp of the
# largest magnitude, a float32 one within 1e-5 of it.


def _bf16_ulp(m):
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _check_face(got, want):
    assert got.dtype == want.dtype
    err = float((got.double() - want.double()).abs().max())
    m = float(want.double().abs().max())
    tol = _bf16_ulp(m) if want.dtype == torch.bfloat16 \
        else TOL * max(1.0, m)
    assert err <= tol, (err, tol)


BF16_SHAPES = [(256, 384, 256), (100, 130, 200), (1, 3, 5), (130, 257, 66),
               (64, 3072, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_face_matches_plain_version_at_every_tiling(cuda_device,
                                                         shape):
    x, w, _ = (torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in _inputs(shape, seed=17))
    for t in tmm.TILINGS:
        assert tmm.kernel_smem_bytes(*t, dtype=torch.bfloat16) == \
            tmm.smem_bytes(*t, torch.bfloat16)
        cfg = dict(zip(("block_m", "block_n", "block_k"), t))
        for out_dtype in (None, torch.float32):
            kernels.reset_launches()
            got = tmm.matmul(x, w, out_dtype, cfg)
            again = tmm.matmul(x, w, out_dtype, cfg)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["matmul_bf16"] == 2
            assert kernels.launch_counts()["matmul"] == 0
            assert torch.equal(got, again), t
            _check_face(got, tmm.matmul_reference(x, w, cfg, out_dtype))


@pytest.mark.cuda
def test_bf16_face_takes_a_misaligned_operand(cuda_device):
    # an operand that starts one value past a 16-byte boundary is staged
    # by the face's plain loads (as a ragged K or N is), not refused
    x, w, _ = (torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in _inputs((64, 256, 128), seed=18))
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)
    xm = buf[1:].view(64, 256)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    cfg = {"block_m": 64, "block_n": 64, "block_k": 32}
    got = tmm.matmul(xm, w, None, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, tmm.matmul(x, w, None, cfg))
    _check_face(got, tmm.matmul_reference(x, w, cfg))
