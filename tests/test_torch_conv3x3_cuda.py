"""The 3x3 / s1 / p1 convolution on the card: the CUDA kernel (forward,
and dx on the rotated filter) against its plain version, at shapes where
its rule takes each of its three tilings and at each tail, relaunched
bit-identically, and its refusal of other dtypes; the same of its
bfloat16 face on the path and tiling its rule takes, its wgmma kernel at
every tiling forced and at its tails (the four tilings bit-identical to
one another), its ragged path counted apart, and the wgmma templates'
registers free of spills.

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
    # the forward in both outputs and dx, each on the path and at the
    # tiling the face's rule takes (the library's, held to the mirror),
    # counted on that path's counter
    N, H, W, C, O = shape
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for bm, bn in tconv.TILINGS:
        assert tconv.kernel_smem_bytes(bm, bn, torch.bfloat16) == \
            tconv.smem_bytes(bm, bn, torch.bfloat16)
    x, w, g = _bf16_inputs(shape, sum(shape) + 1, cuda_device)
    w_rot = tconv.rotate_filter(w)
    for a, b, out_dtype in ((x, w, None), (x, w, torch.float32),
                            (g, w_rot, None)):
        Ca, Oa = a.shape[3], b.shape[3]
        path, _ = tconv.kernel_tiling(N, H, W, Ca, Oa, torch.bfloat16)
        assert (path, _) == tconv.tiling_bf16(N, H, W, Ca, Oa, sms=sms)
        kernels.reset_launches()
        got = tconv.conv3x3_s1_nhwc(a, b, out_dtype)
        again = tconv.conv3x3_s1_nhwc(a, b, out_dtype)
        torch.cuda.synchronize()
        counter = "conv3x3_fwd_bf16" + ("_ragged" if path == "ragged"
                                        else "")
        assert kernels.launch_counts() == dict(
            {k: 0 for k in kernels.KERNEL_COUNTERS}, **{counter: 2})
        assert torch.equal(got, again)
        _check_face(got, tconv.conv3x3_reference(a, b, out_dtype))
    # the backward's dx launches the face as dx
    kernels.reset_launches()
    dx, dw = tconv.conv3x3_bwd(x, w, g)
    torch.cuda.synchronize()
    path = tconv.bf16_path(N, H, W, O, C)
    assert kernels.launch_counts()[
        "conv3x3_dx_bf16" + ("_ragged" if path == "ragged" else "")] == 1
    assert dx.dtype == dw.dtype == torch.bfloat16
    want_dx, want_dw = tconv.conv3x3_bwd_reference(x, w, g)
    _check_face(dx, want_dx)
    _check_face(dw, want_dw)
    assert tconv.kernel_tiling(*shape) == tconv.tiling(*shape, sms=sms)


def _bf16_inputs(shape, seed, dev):
    N, H, W, C, O = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(N, H, W, C).astype(np.float32)).to(
        dev).bfloat16()
    w = torch.from_numpy((rng.randn(3, 3, C, O) * (2.0 / (9 * C)) ** 0.5)
                         .astype(np.float32)).to(dev).bfloat16()
    g = torch.from_numpy(rng.randn(N, H, W, O).astype(np.float32)).to(
        dev).bfloat16()
    return x, w, g


# shapes of the wgmma kernel's tails, each run at every tiling: an M tail
# and a C chunk of 24 (of 64), O 40 (a BN tail of 64 and of 128), C 72 (a
# chunk and 8), O 136, one pixel (all halo but the centre), the deep stage
# at batch 2, 128-pixel boxes across three 7 x 7 images, and the shape
# where the rule takes 64 x 128
WGMMA_SHAPES = [(3, 7, 9, 24, 40), (2, 9, 11, 72, 136), (1, 1, 1, 8, 8),
                (2, 7, 7, 512, 512), (4, 7, 7, 64, 64), (2, 30, 40, 64, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("tiling", [(128, 128), (128, 64), (64, 128),
                                    (64, 64)])
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_bf16_wgmma_tilings_and_tails_relaunch_bit_identically(
        cuda_device, shape, tiling):
    assert tiling in tconv.TILINGS_BF16
    assert tconv.kernel_smem_bytes(*tiling, torch.bfloat16, "wgmma") == \
        tconv.smem_bytes_wgmma(*tiling)
    x, w, g = _bf16_inputs(shape, sum(shape) + 2, cuda_device)
    w_rot = tconv.rotate_filter(w)
    for a, b, out_dtype in ((x, w, None), (x, w, torch.float32),
                            (g, w_rot, None)):
        got = tconv._launch(a, b, out_dtype, "wgmma", tiling)
        again = tconv._launch(a, b, out_dtype, "wgmma", tiling)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _check_face(got, tconv.conv3x3_reference(a, b, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 7, 7, 512, 512),
                                   (16, 33, 33, 32, 200)])
def test_bf16_wgmma_tilings_agree_bit_for_bit(cuda_device, shape):
    # every tiling sums each output's 64-deep stages in the same order
    x, w, _ = _bf16_inputs(shape, 5, cuda_device)
    for out_dtype in (None, torch.float32):
        outs = [tconv._launch(x, w, out_dtype, "wgmma", t)
                for t in tconv.TILINGS_BF16]
        torch.cuda.synchronize()
        for o in outs[1:]:
            assert torch.equal(o, outs[0])


@pytest.mark.cuda
def test_bf16_ragged_path_counted_apart(cuda_device):
    # C 3 and C 36 (not multiples of 8), and a misaligned view of aligned
    # shapes, take the ragged path and its counters; the wgmma entry
    # refuses them
    for shape in ((2, 5, 6, 3, 7), (2, 9, 11, 36, 64)):
        x, w, g = _bf16_inputs(shape, 6, cuda_device)
        kernels.reset_launches()
        out = tconv.conv3x3_s1_nhwc(x, w)
        dx, _ = tconv.conv3x3_bwd(x, w, g, want_dw=False)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["conv3x3_fwd_bf16_ragged"] == 1
        assert counts["conv3x3_dx_bf16_ragged"] == 1
        assert counts["conv3x3_fwd_bf16"] == counts["conv3x3_dx_bf16"] == 0
        _check_face(out, tconv.conv3x3_reference(x, w))
        _check_face(dx, tconv.conv3x3_reference(g, tconv.rotate_filter(w)))
        with pytest.raises(RuntimeError, match="CUDA error"):
            tconv._launch(x, w, None, "wgmma", (64, 64))
    shape = (2, 9, 11, 64, 64)
    x, w, _ = _bf16_inputs(shape, 7, cuda_device)
    # a contiguous view 2 bytes past an aligned base
    buf = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    assert tconv.kernel_tiling(*shape, torch.bfloat16, aligned=False) == \
        ("ragged", tconv.tiling(*shape))
    kernels.reset_launches()
    got = tconv.conv3x3_s1_nhwc(xm, w)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["conv3x3_fwd_bf16_ragged"] == 1
    assert counts["conv3x3_fwd_bf16"] == 0
    want = tconv.conv3x3_s1_nhwc(x, w)  # the wgmma kernel, aligned
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv3x3_fwd_bf16"] == 1
    _check_face(got, tconv.conv3x3_reference(x, w))
    _check_face(want, tconv.conv3x3_reference(x, w))


@pytest.mark.cuda
def test_bf16_wgmma_templates_do_not_spill(cuda_device):
    # the wgmma kernel's four templates: registers reported, no spill; the
    # ragged path's six are compiled (its 128 x 128 copy-by-cp.async form
    # spills 24 bytes, as the face's first kernel did, and no main path
    # takes it)
    from paddle_tpu_torch.kernels import _build
    _build.load("conv3x3")
    log = _build.build_log("conv3x3")
    entries = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entries[name] = []
        elif name is not None and ("registers" in ln or "spill" in ln):
            entries[name].append(ln)
    wgmma = {k: v for k, v in entries.items()
             if "conv3x3_bf16_wgmma_kernel" in k}
    ragged = {k: v for k, v in entries.items()
              if "conv3x3_bf16_ragged_kernel" in k}
    assert len(wgmma) == 4 and len(ragged) == 6, list(entries)
    for k, lines in wgmma.items():
        assert any("registers" in ln for ln in lines), k
        for ln in lines:
            for part in ln.split(","):
                if "spill" in part:
                    assert part.split()[0] == "0", (k, ln)
