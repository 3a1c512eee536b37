"""3x3 / stride-1 / pad-1 convolution, forward and backward (counterpart
of ``paddle_tpu/kernels/conv3x3.py``).

Layout: NHWC activations, HWIO filters, the JAX package's public layout;
``conv2d`` (``ops/nn_ops.py``) transposes NCHW/OIHW into it around the
call, as the JAX op does.

- :func:`conv3x3_reference` is the plain forward: 9 tap products on the
  zero-padded input, summed in float32.
- :func:`conv3x3_bwd_reference` is the plain backward: dx as the forward
  of the output gradient with the spatially flipped, in/out-swapped
  filter, and dw as the 9 tap contractions.
- :func:`conv3x3_s1_nhwc` is the wrapper, a ``torch.autograd.Function``.
  A CPU tensor gets the plain versions. A CUDA tensor gets the
  hand-written kernel of ``csrc/conv3x3.cu`` or an exception, never the
  plain version: the forward launches it once, and :func:`conv3x3_bwd`
  launches it once more for dx (``_vjp_bwd`` of the JAX package reuses
  its Pallas kernel the same way). dw is 9 ``torch.matmul`` tap
  contractions, as the JAX package leaves it to XLA outside Pallas.
- ``launches`` and ``launches_dx`` count the kernel launches of the
  forward and of dx.

The JAX wrapper takes a tiling ``config`` of the TPU schedule
(``block_n``, ``block_o``, ``grid_order``); it means nothing to this
kernel, and the wrapper accepts and ignores it. The kernel picks its own
tiling by a rule in its source, which :func:`tiling` mirrors, with the
shared memory of each tiling in :func:`smem_bytes`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["H100_SMS", "TILINGS", "conv3x3_bwd", "conv3x3_bwd_reference",
           "conv3x3_reference", "conv3x3_s1_nhwc", "kernel_tiling",
           "launches", "launches_dx", "rotate_filter", "smem_bytes",
           "supports_conv3x3", "tiling"]

# kernel launches since the last reset: forward and dx
launches = 0
launches_dx = 0

_NAME = "conv3x3"

# the kernel's tilings (BM pixels x BN output channels a block), largest
# first, each at BK = 32 input channels a step in a ring of 3 stages
# (csrc/conv3x3.cu)
TILINGS = ((128, 128), (128, 64), (64, 64))
_BK = 32
_STAGES = 3
_X_PAD = 4
_W_PAD = 8
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


def smem_bytes(bm, bn):
    """Dynamic shared memory of one block of the tiling: three stages of
    the A tile (``bm x (32 + 4)``) and the B tile (``32 x (bn + 8)``),
    float32 (``Tile::SMEM_BYTES`` of the source)."""
    return _STAGES * (bm * (_BK + _X_PAD) + _BK * (bn + _W_PAD)) * 4


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


def conv3x3_reference(x, w):
    """Plain forward: ``x [N, H, W, C]`` x ``w [3, 3, C, O]`` ->
    ``[N, H, W, O]``, the sum of 9 tap products."""
    N, H, W, C = x.shape
    O = w.shape[3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy, dx, patch in _taps(xp, H, W):
        t = torch.matmul(patch, w[dy, dx])
        out = t if out is None else out + t
    return out.reshape(N, H, W, O)


def _dw_taps(x, g):
    """dw ``[3, 3, C, O]``: ``dw[dy, dx, c, o] = sum_{n,h,w}
    xpad[n, h+dy, w+dx, c] g[n, h, w, o]``, one matmul a tap."""
    N, H, W, C = x.shape
    O = g.shape[3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(-1, O)
    dw = torch.empty((3, 3, C, O), dtype=x.dtype, device=x.device)
    for dy, dx, patch in _taps(xp, H, W):
        dw[dy, dx] = torch.matmul(patch.t(), g2)
    return dw


def conv3x3_bwd_reference(x, w, g):
    """Plain backward: ``(dx [N, H, W, C], dw [3, 3, C, O])``."""
    return conv3x3_reference(g, rotate_filter(w)), _dw_taps(x, g)


def _launch(x, w):
    """One launch of the kernel on checked operands; returns the
    ``[N, H, W, O]`` output."""
    N, H, W, C = x.shape
    O = w.shape[3]
    out = torch.empty((N, H, W, O), dtype=torch.float32, device=x.device)
    lib = _build.load(_NAME)
    fn = lib.conv3x3_s1_nhwc_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, O,
              _build.stream_handle(x.device))
    _build.check(lib, code, _NAME)
    return out


def kernel_tiling(N, H, W, C, O):
    """``(BM, BN)`` the built kernel takes at the shape on the current
    card: its own rule, asked through the library (needs the card)."""
    lib = _build.load(_NAME)
    fn = lib.conv3x3_tiling
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    code = fn(N, H, W, C, O)
    if code < 0:
        raise ValueError("%s: no tiling for shape %s"
                         % (_NAME, (N, H, W, C, O)))
    return code // 1000, code % 1000


def _check(x, w):
    if x.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, x.device))
    if x.ndim != 4 or tuple(w.shape[:2]) != (3, 3) or w.ndim != 4 \
            or w.shape[2] != x.shape[3]:
        raise ValueError("%s: the kernel takes x [N, H, W, C] and w "
                         "[3, 3, C, O], got %s and %s"
                         % (_NAME, tuple(x.shape), tuple(w.shape)))
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise ValueError("%s: the kernel takes float32 operands, %s is "
                             "%s" % (_NAME, name, t.dtype))
    _build.check_cuda_operands(_NAME, x.device, x=x, w=w)


def _forward(x, w):
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    global launches
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    _check(x, w)
    out = _launch(x, w)
    launches += 1
    return out


def conv3x3_bwd(x, w, g, want_dx=True, want_dw=True):
    """``(dx, dw)`` of :func:`conv3x3_bwd_reference`, each None when not
    wanted. On CUDA dx is one launch of the kernel on ``g`` and the
    rotated filter, and dw the 9 tap matmuls; float32 contiguous
    operands, anything else raises."""
    global launches_dx
    dx = dw = None
    if x.device.type == "cpu":
        if want_dx:
            dx = conv3x3_reference(g, rotate_filter(w))
    elif want_dx:
        w_rot = rotate_filter(w)
        g = g.contiguous()
        _check(g, w_rot)
        dx = _launch(g, w_rot)
        launches_dx += 1
    if want_dw:
        dw = _dw_taps(x, g)
    return dx, dw


class _Conv3x3(torch.autograd.Function):
    """The forward kernel with the backward of the JAX package's custom
    vjp (``_vjp_fwd``/``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return conv3x3_bwd(x, w, g, *ctx.needs_input_grad)


def conv3x3_s1_nhwc(x, w, config=None):
    """3x3 / s1 / p1 convolution, NHWC x HWIO -> NHWC, float32
    accumulation, differentiable in ``x`` and ``w``. On CUDA: float32,
    contiguous ``x [N, H, W, C]`` and ``w [3, 3, C, O]`` on one device;
    anything else raises. ``config`` (a TPU tiling) is ignored."""
    del config
    return _Conv3x3.apply(x, w)
