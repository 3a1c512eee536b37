"""The blocked matmul on the card: the CUDA kernel against its plain
version at every compiled tiling (ragged shapes included), its shared
memory against the wrapper's count, a second launch that must equal the
first bit for bit, and what it refuses, and its outputs held to recorded
checksums; the same of its bfloat16 face's wgmma kernel (at the LM's
shapes too) and of that face's ragged path, each launch counted on its
own path.

JAX-free, so that it runs where the card is. Tolerance: 1e-5 of the
largest magnitude of the plain output (or 1e-5 absolute below 1),
float32 on both sides; the kernel takes its products in 3xTF32 on the
tensor cores, float32-exact, and it and the plain version's k tiles of
``torch.matmul`` sum in other orders, which moves outputs of size ~1-10
by ~1e-6.
"""
import hashlib
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
# largest magnitude, a float32 one within 1e-5 of it. Operands TMA can
# describe (K and N multiples of 8, 16-byte-aligned pointers) run the
# wgmma kernel at the tiling asked for; any other the ragged path
# (mma.sync, one tiling), each counted on its own.


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
# the LM step's three gemms (GPT-2 small, 8 x 1024 tokens)
LM_SHAPES = [(8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768)]


def _ragged(shape):
    """Whether the face takes its ragged path at ``shape`` (contiguous
    operands from torch, so aligned)."""
    _, K, N = shape
    return K == 0 or K % 8 != 0 or N % 8 != 0


def _bf16_operands(shape, seed, dev):
    return [torch.from_numpy(a).to(dev).bfloat16()
            for a in _inputs(shape, seed)[:2]]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BF16_SHAPES + LM_SHAPES)
def test_bf16_face_matches_plain_version_at_every_tiling(cuda_device,
                                                         shape):
    x, w = _bf16_operands(shape, 17, cuda_device)
    path = "matmul_bf16_ragged" if _ragged(shape) else "matmul_bf16"
    for t in tmm.TILINGS_BF16:
        assert tmm.kernel_smem_bytes(*t, dtype=torch.bfloat16) == \
            tmm.smem_bytes(*t, torch.bfloat16)
        cfg = dict(zip(("block_m", "block_n", "block_k"), t))
        for out_dtype in (None, torch.float32):
            kernels.reset_launches()
            got = tmm.matmul(x, w, out_dtype, cfg)
            again = tmm.matmul(x, w, out_dtype, cfg)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert counts[path] == 2 and sum(counts.values()) == 2, counts
            assert torch.equal(got, again), t
            _check_face(got, tmm.matmul_reference(x, w, cfg, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 5), (130, 257, 66),
                                   (100, 130, 200), (64, 256, 100),
                                   (16, 0, 64)])
def test_bf16_ragged_operands_take_the_ragged_path(cuda_device, shape):
    # K or N not a multiple of 8 (or K 0): TMA cannot describe the rows,
    # so the entry point runs the mma.sync kernel at its one tiling,
    # whatever tiling is asked for
    x, w = _bf16_operands(shape, 19, cuda_device)
    assert tmm.kernel_smem_bytes(*tmm.RAGGED_TILING, dtype="bfloat16") == \
        tmm.smem_bytes(*tmm.RAGGED_TILING, torch.bfloat16) == 56832
    for out_dtype in (None, torch.float32):
        kernels.reset_launches()
        got = tmm.matmul(x, w, out_dtype)
        again = tmm.matmul(x, w, out_dtype, {"block_m": 64})
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["matmul_bf16_ragged"] == 2, counts
        assert counts["matmul_bf16"] == 0
        assert torch.equal(got, again)
        _check_face(got, tmm.matmul_reference(x, w, None, out_dtype))


@pytest.mark.cuda
def test_bf16_face_takes_a_misaligned_operand(cuda_device):
    # an operand that starts one value past a 16-byte boundary cannot be a
    # TMA base: it takes the ragged path, which stages it by plain loads,
    # and is not refused; the aligned copy takes the wgmma kernel
    x, w = _bf16_operands((64, 256, 128), 18, cuda_device)
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)
    xm = buf[1:].view(64, 256)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    cfg = {"block_m": 64, "block_n": 64, "block_k": 64}
    kernels.reset_launches()
    got = tmm.matmul(xm, w, None, cfg)
    again = tmm.matmul(xm, w, None, cfg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["matmul_bf16_ragged"] == 2 and counts["matmul_bf16"] == 0
    assert torch.equal(got, again)
    _check_face(got, tmm.matmul_reference(x, w, cfg))
    aligned = tmm.matmul(x, w, None, cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["matmul_bf16"] == 1
    _check_face(got, aligned)
    _check_face(aligned, tmm.matmul_reference(x, w, cfg))


@pytest.mark.cuda
def test_bf16_step_sums_miss_the_tolerance(cuda_device):
    # the control: a gemm whose running sum were bfloat16 (rounded after
    # each 64-deep tile) misses the face's tolerance at the LM's K 3072,
    # so the tolerance can tell the face's float32 sum from it
    x, w = _bf16_operands((8192, 3072, 768), 21, cuda_device)
    acc = None
    for k0 in range(0, 3072, 64):
        t = x[:, k0:k0 + 64].float() @ w[k0:k0 + 64].float()
        acc = (t if acc is None else acc.float() + t).bfloat16()
    with pytest.raises(AssertionError):
        _check_face(acc, tmm.matmul_reference(x, w))
    _check_face(tmm.matmul(x, w), tmm.matmul_reference(x, w))


# sha256 of the float32 face's outputs at these (shape, tiling) cases,
# seed 7, as the float32 face computed them before the bfloat16 face had
# its wgmma kernel: the bfloat16 work left the float32 face bit for bit
# as it was
F32_CHECKSUMS = {
    "(256, 384, 256) (128, 128, 8)":
        "d52be2941ce16d980b31e1ec412c020aeacc391b2671a8c9dabebdaf1493cf87",
    "(256, 384, 256) (64, 128, 32)":
        "501939987cde1766f074db84a0cd53c0dcb7e591b1c8e19cb2f047733fed8181",
    "(130, 257, 66) (128, 128, 8)":
        "e682efb5723872f5e5c5fe3ebe900f48426662dc2475299b2d55c3754b006b1b",
    "(130, 257, 66) (64, 128, 32)":
        "2d6df0f59e31c27b141cf13bf08f5b4e61d19c78351a4b3ef21631462e859534",
    "(8192, 768, 768) (128, 128, 8)":
        "8e19c81dfa9d9498918bca6e9f9a5b0530c545b7e9fc1a1bf1ab7544472db9dd",
    "(8192, 768, 768) (64, 128, 32)":
        "82bf6ef24a9b6c1b95a4ac6fe23ac9f012f38ea1bc9278c4e960792d509cdc7e"
}


@pytest.mark.cuda
def test_float32_face_is_bit_identical_to_its_recorded_outputs(cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    for shape in ((256, 384, 256), (130, 257, 66), (8192, 768, 768)):
        x, w, _ = (torch.from_numpy(a).to(cuda_device)
                   for a in _inputs(shape, seed=7))
        for t in ((128, 128, 8), (64, 128, 32)):
            out = tmm.matmul(x, w, config=dict(
                zip(("block_m", "block_n", "block_k"), t)))
            got["%s %s" % (shape, t)] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()
    assert got == F32_CHECKSUMS
