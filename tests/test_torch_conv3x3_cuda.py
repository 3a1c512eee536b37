"""The 3x3 / s1 / p1 convolution on the card: the CUDA kernel (forward,
and dx on the rotated filter) against its plain version, at shapes where
its rule takes each of its three tilings and at each tail, relaunched
bit-identically, and its refusal of other dtypes; the same of its
bfloat16 face.

JAX-free, so that it runs where the card is. Tolerance: 1e-5 of the
largest magnitude of the plain output (or 1e-5 absolute below 1),
float32 on both sides; the kernel and the plain version's 9 tap matmuls
sum in other orders, which moves outputs of size ~1-30 by ~1e-6.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import conv3x3 as tconv  # noqa: E402

TOL = 1e-5
SHAPES = [(2, 8, 8, 16, 32), (1, 7, 7, 64, 64), (2, 14, 14, 32, 16),
          (3, 7, 9, 24, 40)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _inputs(shape, seed):
    n, h, w, c, o = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)
    g = rng.randn(n, h, w, o).astype(np.float32)
    return x, wt, g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 5, 6, 3, 7)])
def test_kernel_matches_plain_version_on_the_card(cuda_device, shape):
    x, w, g = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(shape, seed=7))
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launches()
    out = tconv.conv3x3_s1_nhwc(x, w)
    dx, dw = tconv.conv3x3_bwd(x, w, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv3x3_fwd"] == 1
    assert kernels.launch_counts()["conv3x3_dx"] == 1
    want = tconv.conv3x3_reference(x, w)
    want_dx, want_dw = tconv.conv3x3_bwd_reference(x, w, g)
    for got, ref in ((out, want), (dx, want_dx), (dw, want_dw)):
        assert float((got - ref).abs().max()) <= \
            TOL * max(1.0, float(ref.abs().max()))


# shapes at which the kernel's rule takes each tiling on an H100 (132
# SMs), with the tails: (N, H, W, C, O) and the forward's tiling
TILING_CASES = [
    ((32, 56, 56, 64, 64), (128, 64)),     # ResNet-50's first stage
    ((4, 95, 97, 64, 40), (128, 64)),      # a BM tail, O 40 a BN tail
    ((16, 33, 33, 32, 200), (128, 128)),   # BM and BN tails; dx 64 x 64
    ((32, 7, 7, 512, 512), (64, 64)),      # the deep stage
    ((2, 7, 7, 512, 512), (64, 64)),       # the deep stage at batch 2
    ((3, 7, 9, 24, 40), (64, 64)),         # C 24 a short chunk, O 40
    ((2, 9, 11, 36, 64), (64, 64)),        # C 36: 4 channels past 32
    ((2, 5, 6, 3, 7), (64, 64)),           # the 4-byte copies
    ((1, 1, 1, 1, 1), (64, 64)),           # one pixel, all halo but one
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", TILING_CASES)
def test_each_tiling_and_tail_relaunches_bit_identically(cuda_device,
                                                         shape, want):
    N, H, W, C, O = shape
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert tconv.kernel_tiling(*shape) == tconv.tiling(*shape, sms=sms)
    assert tconv.kernel_tiling(N, H, W, O, C) == \
        tconv.tiling(N, H, W, O, C, sms=sms)
    if sms == tconv.H100_SMS:
        assert tconv.kernel_tiling(*shape) == want
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32)).to(
        cuda_device)
    w = torch.from_numpy((rng.randn(3, 3, C, O) * (2.0 / (9 * C)) ** 0.5)
                         .astype(np.float32)).to(cuda_device)
    g = torch.from_numpy(rng.randn(N, H, W, O).astype(np.float32)).to(
        cuda_device)
    w_rot = tconv.rotate_filter(w)
    for a, b in ((x, w), (g, w_rot)):
        got = tconv._launch(a, b)
        again = tconv._launch(a, b)
        want_out = tconv.conv3x3_reference(a.double(), b.double())
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert float((got.double() - want_out).abs().max()) <= \
            TOL * max(1.0, float(want_out.abs().max()))


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes(cuda_device):
    x, w, _ = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(SHAPES[0], seed=8))
    kernels.reset_launches()
    for a, b in ((x.double(), w.double()), (x.half(), w.half()),
                 (x.bfloat16(), w), (x, w.bfloat16())):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            tconv.conv3x3_s1_nhwc(a, b)
    with pytest.raises(ValueError, match="writes torch.float32, not"):
        tconv.conv3x3_s1_nhwc(x, w, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv3x3_s1_nhwc(
            x.bfloat16().permute(0, 2, 1, 3).contiguous().permute(
                0, 2, 1, 3), w.bfloat16())
    assert set(kernels.launch_counts().values()) == {0}


# -- the bfloat16 face (AMP) --------------------------------------------------
#
# bfloat16 operands, float32 sums, written in bfloat16 or float32; dx on
# the rotated filter in bfloat16. The plain version sums exactly in
# float32 in another order and rounds once: a bfloat16 output within one
# bfloat16 ulp of the largest magnitude, a float32 one within 1e-5 of it.


def _bf16_ulp(m):
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _check_face(got, want):
    assert got.dtype == want.dtype
    err = float((got.double() - want.double()).abs().max())
    m = float(want.double().abs().max())
    tol = _bf16_ulp(m) if want.dtype == torch.bfloat16 \
        else TOL * max(1.0, m)
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", TILING_CASES)
def test_bf16_face_at_each_tiling_and_tail_relaunches_bit_identically(
        cuda_device, shape, want):
    N, H, W, C, O = shape
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for bm, bn in tconv.TILINGS:
        assert tconv.kernel_smem_bytes(bm, bn, torch.bfloat16) == \
            tconv.smem_bytes(bm, bn, torch.bfloat16)
    rng = np.random.RandomState(sum(shape) + 1)
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32)).to(
        cuda_device).bfloat16()
    w = torch.from_numpy((rng.randn(3, 3, C, O) * (2.0 / (9 * C)) ** 0.5)
                         .astype(np.float32)).to(cuda_device).bfloat16()
    g = torch.from_numpy(rng.randn(N, H, W, O).astype(np.float32)).to(
        cuda_device).bfloat16()
    w_rot = tconv.rotate_filter(w)
    for a, b, out_dtype in ((x, w, None), (x, w, torch.float32),
                            (g, w_rot, None)):
        kernels.reset_launches()
        got = tconv.conv3x3_s1_nhwc(a, b, out_dtype)
        again = tconv.conv3x3_s1_nhwc(a, b, out_dtype)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["conv3x3_fwd_bf16"] == 2 and counts["conv3x3_fwd"] == 0
        assert torch.equal(got, again)
        _check_face(got, tconv.conv3x3_reference(a, b, out_dtype))
    # the backward's dx launches the face as dx; the tiling rule is the
    # float32 face's
    kernels.reset_launches()
    dx, dw = tconv.conv3x3_bwd(x, w, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv3x3_dx_bf16"] == 1
    assert dx.dtype == dw.dtype == torch.bfloat16
    want_dx, want_dw = tconv.conv3x3_bwd_reference(x, w, g)
    _check_face(dx, want_dx)
    _check_face(dw, want_dw)
    assert tconv.kernel_tiling(*shape) == tconv.tiling(*shape, sms=sms)
