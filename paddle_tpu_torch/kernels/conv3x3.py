"""3x3 / stride-1 / pad-1 convolution, forward and backward (counterpart
of ``paddle_tpu/kernels/conv3x3.py``).

Layout: NHWC activations, HWIO filters, the JAX package's public layout;
``conv2d`` (``ops/nn_ops.py``) transposes NCHW/OIHW into it around the
call, as the JAX op does.

- :func:`conv3x3_reference` is the plain forward: 9 tap products on the
  zero-padded input, summed in float32 and written in ``out_dtype``
  (default the input's dtype), rounded once.
- :func:`conv3x3_bwd_reference` is the plain backward: dx as the forward
  of the output gradient with the spatially flipped, in/out-swapped
  filter, and dw as the 9 tap contractions.
- :func:`conv3x3_s1_nhwc` is the wrapper, a ``torch.autograd.Function``.
  A CPU tensor gets the plain versions. A CUDA tensor gets the
  hand-written kernel of ``csrc/conv3x3.cu`` or an exception, never the
  plain version: the forward launches it once, and :func:`conv3x3_bwd`
  launches it once more for dx (``_vjp_bwd`` of the JAX package reuses
  its Pallas kernel the same way). dw is 9 tap contractions summed in
  float32 and rounded to the filter's dtype, library gemms, as the JAX
  package leaves it to XLA outside Pallas.
- Two faces, as the JAX kernel is dtype-generic: float32 operands
  (``conv3x3_s1_nhwc_f32``, float32 out) and bfloat16 operands under AMP
  (``conv3x3_s1_nhwc_bf16``, float32 sums, bfloat16 or float32 out).
  The bfloat16 face has two paths, picked by the C entry point before
  the launch: a TMA-fed ``wgmma`` kernel for operands TMA can take (C
  and O multiples of 8, every pointer 16-byte aligned: every ResNet-50
  3x3 conv), and the ragged path, an ``mma.sync`` kernel, for any other
  (:func:`bf16_path`).
- ``launches`` and ``launches_dx`` count the float32 face's launches of
  the forward and of dx, ``launches_bf16`` and ``launches_dx_bf16`` the
  bfloat16 face's ``wgmma`` kernel's, ``launches_bf16_ragged`` and
  ``launches_dx_bf16_ragged`` its ragged path's.

The JAX wrapper takes a tiling ``config`` of the TPU schedule
(``block_n``, ``block_o``, ``grid_order``); it means nothing to this
kernel, and the wrapper accepts and ignores it. The kernel picks its own
tiling by a rule in its source, which :func:`tiling` mirrors (the
float32 face and the ragged path) and :func:`tiling_bf16` (the bfloat16
face's path and tiling), with the shared memory of each tiling in
:func:`smem_bytes` and :func:`smem_bytes_wgmma`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ..core.types import torch_dtype
from ..amp import matmul_f32

__all__ = ["H100_SMS", "TILINGS", "TILINGS_BF16", "bf16_path",
           "conv3x3_bwd", "conv3x3_bwd_reference", "conv3x3_reference",
           "conv3x3_s1_nhwc", "kernel_smem_bytes", "kernel_tiling",
           "launches", "launches_bf16", "launches_bf16_ragged",
           "launches_dx", "launches_dx_bf16", "launches_dx_bf16_ragged",
           "rotate_filter", "smem_bytes", "smem_bytes_wgmma",
           "supports_conv3x3", "tiling", "tiling_bf16"]

# kernel launches since the last reset: forward and dx, of the float32
# face, of the bfloat16 face's wgmma kernel and of its ragged path
launches = 0
launches_dx = 0
launches_bf16 = 0
launches_dx_bf16 = 0
launches_bf16_ragged = 0
launches_dx_bf16_ragged = 0

_NAME = "conv3x3"

# the kernel's tilings (BM pixels x BN output channels a block), largest
# first, each at BK = 32 input channels a step in a ring of 3 stages
# (csrc/conv3x3.cu): the float32 face's and the bfloat16 face's ragged
# path's
TILINGS = ((128, 128), (128, 64), (64, 64))
_BK = 32
_STAGES = 3
# the bfloat16 face's wgmma tilings, largest first: BM / 64 consumer
# warpgroups, BN the wgmma width; 64 input channels a stage (one 128-byte
# swizzled row) in a ring of 4 stages of unpadded boxes, and 1024 bytes
# to align the ring for the swizzle
TILINGS_BF16 = ((128, 128), (128, 64), (64, 128), (64, 64))
_CK = 64
_RING_W = 4
# row paddings of the A and B tiles, in elements, by face
_PADS = {torch.float32: (4, 8), torch.bfloat16: (8, 8)}
_FACES = {torch.float32: "conv3x3_s1_nhwc_f32",
          torch.bfloat16: "conv3x3_s1_nhwc_bf16"}
# the SMs of an H100 SXM; the kernel reads the card's own count
H100_SMS = 132


def tiling(N, H, W, C, O, sms=H100_SMS):
    """``(BM, BN)`` the kernel takes for x ``[N, H, W, C]`` and O output
    channels on a card of ``sms`` SMs (``pick_tiling`` of the source):
    the first of :data:`TILINGS` whose BN is at most ``max(64, O)`` and
    whose grid has at least 2 blocks an SM, else 64 x 64. C does not
    enter the rule."""
    del C
    M = N * H * W
    for bm, bn in TILINGS:
        blocks = -(-M // bm) * -(-O // bn)
        if bn <= max(64, O) and blocks >= 2 * sms:
            return bm, bn
    return TILINGS[-1]


def bf16_path(N, H, W, C, O, aligned=True):
    """``"wgmma"`` where the bfloat16 face's TMA can take the operands (C
    and O multiples of 8, every pointer 16-byte aligned: ``aligned``),
    else ``"ragged"`` (``tma_path`` of the source). N, H and W do not
    enter the rule."""
    del N, H, W
    return "wgmma" if aligned and C % 8 == 0 and O % 8 == 0 else "ragged"


def tiling_bf16(N, H, W, C, O, sms=H100_SMS, aligned=True):
    """``(path, (BM, BN))`` the bfloat16 face takes for x ``[N, H, W,
    C]`` and O output channels on a card of ``sms`` SMs: the ragged path
    at :func:`tiling`; the wgmma kernel at the first of
    :data:`TILINGS_BF16` whose BN is at most ``max(64, O)`` and whose
    grid has blocks for at least half the SMs, else 64 x 64
    (``pick_tiling_wgmma`` of the source)."""
    path = bf16_path(N, H, W, C, O, aligned)
    if path == "ragged":
        return path, tiling(N, H, W, C, O, sms)
    M = N * H * W
    for bm, bn in TILINGS_BF16:
        blocks = -(-M // bm) * -(-O // bn)
        if bn <= max(64, O) and blocks >= (sms + 1) // 2:
            return path, (bm, bn)
    return path, TILINGS_BF16[-1]


def smem_bytes_wgmma(bm, bn):
    """Dynamic shared memory of one block of a wgmma tiling: four stages
    of the ``bm x 64`` pixel box and the ``64 x bn`` filter boxes,
    bfloat16, and 1024 bytes of alignment (``TileW::SMEM_BYTES``)."""
    return _RING_W * (bm * _CK + _CK * bn) * 2 + 1024


def smem_bytes(bm, bn, dtype=torch.float32):
    """Dynamic shared memory of one block of the tiling: three stages of
    the A tile and the B tile, ``bm x (32 + 4)`` and ``32 x (bn + 8)``
    float32 values (``Tile::SMEM_BYTES`` of the source), or ``bm x (32 +
    8)`` and ``32 x (bn + 8)`` bfloat16 ones, the bfloat16 face's ragged
    path (``TileB::SMEM_BYTES``; its wgmma kernel's:
    :func:`smem_bytes_wgmma`). ``dtype`` may be a torch dtype or its
    name."""
    dtype = torch_dtype(dtype)
    if dtype not in _PADS:      # no face: priced as the float32 one
        dtype = torch.float32
    xpad, wpad = _PADS[dtype]
    return _STAGES * (bm * (_BK + xpad) + _BK * (bn + wpad)) \
        * dtype.itemsize


def supports_conv3x3(w_shape, strides, paddings, dilations, groups):
    """True when (kh, kw) = (3, 3), stride 1, pad 1, no dilation or
    groups: the ResNet mid-network population this kernel targets."""
    return (groups == 1 and tuple(dilations) == (1, 1)
            and tuple(strides) == (1, 1) and tuple(paddings) == (1, 1)
            and tuple(w_shape[-2:]) in ((3, 3),))


def rotate_filter(w):
    """HWIO ``[3, 3, C, O]`` -> ``[3, 3, O, C]``, spatially flipped: the
    filter whose 3x3 / s1 / p1 conv of the output gradient is dx."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _taps(xp, H, W):
    """The 9 shifted ``[N*H*W, C]`` views of the padded input, tap by
    tap (dy outer, dx inner)."""
    C = xp.shape[-1]
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, C)


def conv3x3_reference(x, w, out_dtype=None):
    """Plain forward: ``x [N, H, W, C]`` x ``w [3, 3, C, O]`` ->
    ``[N, H, W, O]``, the sum of 9 tap products in float32 (float64
    operands: float64), written in ``out_dtype`` (default ``x``'s
    dtype). Of bfloat16 operands each product is exact in float32 and
    the sum is rounded once."""
    N, H, W, C = x.shape
    O = w.shape[3]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy, dx, patch in _taps(xp, H, W):
        t = torch.matmul(patch.to(acc), w[dy, dx].to(acc))
        out = t if out is None else out + t
    return out.reshape(N, H, W, O).to(out_dtype or x.dtype)


def _dw_taps(x, g, dtype):
    """dw ``[3, 3, C, O]``: ``dw[dy, dx, c, o] = sum_{n,h,w}
    xpad[n, h+dy, w+dx, c] g[n, h, w, o]``, one gemm a tap summed in
    float32, written in ``dtype`` (the filter's: ``_vjp_bwd`` rounds the
    float32 taps to ``w.dtype``)."""
    N, H, W, C = x.shape
    O = g.shape[3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(-1, O)
    dw = torch.empty((3, 3, C, O), dtype=dtype, device=x.device)
    for dy, dx, patch in _taps(xp, H, W):
        dw[dy, dx] = matmul_f32(patch.t(), g2)
    return dw


def conv3x3_bwd_reference(x, w, g):
    """Plain backward: ``(dx [N, H, W, C], dw [3, 3, C, O])`` in the
    dtypes of ``x`` and ``w``."""
    return (conv3x3_reference(g.to(x.dtype), rotate_filter(w)),
            _dw_taps(x, g, w.dtype))


def _launch(x, w, out_dtype=None, path=None, tiling=None):
    """One launch of the face of ``x``'s dtype on checked operands;
    returns the ``[N, H, W, O]`` output in ``out_dtype`` (default
    ``x``'s dtype). The bfloat16 face takes the path and tiling of its
    rule, or a ``path`` forced: ``"ragged"`` at any operands, or
    ``"wgmma"`` at ``tiling`` (one of :data:`TILINGS_BF16`; default the
    rule's) on operands TMA can take."""
    N, H, W, C = x.shape
    O = w.shape[3]
    out_dtype = out_dtype or x.dtype
    out = torch.empty((N, H, W, O), dtype=out_dtype, device=x.device)
    lib = _build.load(_NAME)
    bf16 = x.dtype == torch.bfloat16
    name = _FACES[x.dtype]
    extra = (int(out_dtype == torch.float32),) if bf16 else ()
    if bf16 and path is not None:
        name += "_" + path
        if path == "wgmma":
            extra += tuple(tiling or kernel_tiling(N, H, W, C, O,
                                                   torch.bfloat16)[1])
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * (5 + len(extra)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, O,
              *extra, _build.stream_handle(x.device))
    _build.check(lib, code, _NAME)
    return out


def kernel_tiling(N, H, W, C, O, dtype=torch.float32, aligned=True):
    """The tiling the built kernel takes at the shape on the current
    card, its own rule asked through the library (needs the card):
    ``(BM, BN)`` of the float32 face, or ``(path, (BM, BN))`` of the
    bfloat16 face (as :func:`tiling_bf16`), its pointers 16-byte
    ``aligned`` or not."""
    lib = _build.load(_NAME)
    bf16 = torch_dtype(dtype) == torch.bfloat16
    fn = lib.conv3x3_bf16_tiling if bf16 else lib.conv3x3_tiling
    fn.argtypes = [ctypes.c_int] * (6 if bf16 else 5)
    fn.restype = ctypes.c_int
    code = fn(N, H, W, C, O, *((int(aligned),) if bf16 else ()))
    if code < 0:
        raise ValueError("%s: no tiling for shape %s"
                         % (_NAME, (N, H, W, C, O)))
    t = (code % 1000000 // 1000, code % 1000)
    if not bf16:
        return t
    return ("wgmma" if code >= 1000000 else "ragged"), t


def kernel_smem_bytes(bm, bn, dtype=torch.float32, path="ragged"):
    """The built library's shared memory of a tiling's block: the float32
    face's, or the bfloat16 face's on ``path`` (``"ragged"`` or
    ``"wgmma"``); -1 for a tiling it does not compile (needs the card's
    toolchain)."""
    lib = _build.load(_NAME)
    if torch_dtype(dtype) == torch.bfloat16 and path == "wgmma":
        fn = lib.conv3x3_bf16_wgmma_smem_bytes
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
        return fn(bm, bn)
    fn = lib.conv3x3_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(bm, bn, int(torch_dtype(dtype) == torch.bfloat16))


def _check(x, w, out_dtype=None):
    if x.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, x.device))
    if x.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.ndim != 4 \
            or w.shape[2] != x.shape[3]:
        raise ValueError("%s: the kernel takes x [N, H, W, C] and w "
                         "[3, 3, C, O], got %s and %s"
                         % (_NAME, tuple(x.shape), tuple(w.shape)))
    if x.dtype not in _FACES or w.dtype != x.dtype:
        raise ValueError("%s: the kernel takes float32 or bfloat16 operands "
                         "of one dtype, x is %s and w %s"
                         % (_NAME, x.dtype, w.dtype))
    outs = (torch.float32, torch.bfloat16) if x.dtype == torch.bfloat16 \
        else (torch.float32,)
    if out_dtype not in (None,) + outs:
        raise ValueError("%s: the %s face writes %s, not %s"
                         % (_NAME, x.dtype, " or ".join(map(str, outs)),
                            out_dtype))
    _build.check_cuda_operands(_NAME, x.device, x=x, w=w)


def _count(dx, x, w):
    """One more launch of the role (forward or ``dx``) on the path the
    checked operands ``x`` and ``w`` take (the output, a fresh tensor, is
    aligned)."""
    global launches, launches_dx, launches_bf16, launches_dx_bf16, \
        launches_bf16_ragged, launches_dx_bf16_ragged
    if x.dtype != torch.bfloat16:
        if dx:
            launches_dx += 1
        else:
            launches += 1
        return
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    ragged = bf16_path(*x.shape, w.shape[3], aligned) == "ragged"
    if dx and ragged:
        launches_dx_bf16_ragged += 1
    elif dx:
        launches_dx_bf16 += 1
    elif ragged:
        launches_bf16_ragged += 1
    else:
        launches_bf16 += 1


def _forward(x, w, out_dtype=None):
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, out_dtype)
    _check(x, w, out_dtype)
    out = _launch(x, w, out_dtype)
    _count(False, x, w)
    return out


def conv3x3_bwd(x, w, g, want_dx=True, want_dw=True):
    """``(dx, dw)`` of :func:`conv3x3_bwd_reference`, each None when not
    wanted. On CUDA dx is one launch of the kernel on ``g`` (cast to
    ``x``'s dtype) and the rotated filter, written in ``x``'s dtype, and
    dw the 9 tap gemms; float32 or bfloat16 contiguous operands,
    anything else raises."""
    dx = dw = None
    if want_dx:
        w_rot = rotate_filter(w)
        gx = g.to(x.dtype).contiguous()
        if x.device.type == "cpu":
            dx = conv3x3_reference(gx, w_rot)
        else:
            _check(gx, w_rot)
            dx = _launch(gx, w_rot)
            _count(True, gx, w_rot)
    if want_dw:
        dw = _dw_taps(x, g, w.dtype)
    return dx, dw


class _Conv3x3(torch.autograd.Function):
    """The forward kernel with the backward of the JAX package's custom
    vjp (``_vjp_fwd``/``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _forward(x, w, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return conv3x3_bwd(x, w, g, *ctx.needs_input_grad[:2]) + (None,)


def conv3x3_s1_nhwc(x, w, out_dtype=None, config=None):
    """3x3 / s1 / p1 convolution, NHWC x HWIO -> NHWC, float32 sums,
    written in ``out_dtype`` (default ``x``'s dtype), differentiable in
    ``x`` and ``w``. On CUDA: contiguous ``x [N, H, W, C]`` and ``w [3,
    3, C, O]`` on one device, both float32 (float32 out) or both
    bfloat16 (bfloat16 or float32 out); anything else raises.
    ``config`` (a TPU tiling) is ignored."""
    del config
    return _Conv3x3.apply(x, w, out_dtype)
