"""Blocked matrix product (counterpart of ``paddle_tpu/kernels/matmul.py``).

``x [M, K] @ w [K, N] -> [M, N]`` with float32 sums, in a tiling
``config = {"block_m", "block_n", "block_k"}`` that the autotuner
(``paddle_tpu_torch/tune``) searches. Two faces, as the JAX kernel is
dtype-generic: float32 operands (``matmul_f32``, float32 out) and
bfloat16 operands, a tuned gemm under AMP (``matmul_bf16``, written in
``out_dtype or x.dtype``: bfloat16 unless float32 is asked for).

- :func:`matmul_reference` is the plain version: the float32 sum, over
  the tiling's k tiles in order, of ``x[:, k0:k1] @ w[k0:k1, :]``, the
  kernel's accumulation order at tile level, rounded once to the
  output dtype. A CPU tensor gets it.
- :func:`matmul` is the wrapper, a ``torch.autograd.Function``. A CUDA
  tensor gets the hand-written kernel of ``csrc/matmul.cu`` or an
  exception, never the plain version or ``torch.matmul``. Its backward
  is two ``torch.matmul`` products, as the JAX custom vjp's is two
  stock gemms (``_vjp_bwd``), so the kernel needs no backward.
- ``launches`` counts the float32 face's launches, ``launches_bf16``
  the bfloat16 face's wgmma kernel's and ``launches_bf16_ragged`` its
  ragged path's (operands TMA cannot describe: K or N not a multiple of
  8, a pointer not 16-byte aligned, K 0; the C entry point picks the
  path and reports it).

Dispatch: ``ops/math_ops.py`` routes ``mul`` here only when the tune
cache holds a winner tiling for the (device, shape); otherwise ``mul``
is ``torch.matmul``, as the JAX package's is ``jnp.matmul``.

The JAX kernel takes ``block_*`` of 0 for the full extent and needs
blocks that divide the shape; this kernel masks its ragged edges, so
any shape is right, and its tilings are the template instantiations of
``csrc/matmul.cu``, by face: :data:`TILINGS` (float32) and
:data:`TILINGS_BF16` (bfloat16, ``block_k`` 64). :func:`normalize_config`
maps a tiling the face does not compile (a stale cache entry) to the
face's default, the JAX rule that a stale entry must degrade to a
correct schedule and never fail the call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..core.types import torch_dtype

__all__ = ["DEFAULT_CONFIG", "DEFAULT_CONFIG_BF16", "RAGGED_TILING",
           "TILINGS", "TILINGS_BF16", "default_config", "launches",
           "launches_bf16", "launches_bf16_ragged", "kernel_smem_bytes",
           "matmul", "matmul_reference", "normalize_config", "smem_bytes",
           "supports_matmul", "tilings"]

# kernel launches since the last reset: the float32 face, the bfloat16
# face's wgmma kernel and its ragged path
launches = 0
launches_bf16 = 0
launches_bf16_ragged = 0

_NAME = "matmul"

# the (block_m, block_n, block_k) instantiations of csrc/matmul.cu: the
# float32 face's, and the bfloat16 face's wgmma kernel's (block_m / 64
# consumer warpgroups, block_n the wgmma width, block_k one 128-byte
# swizzled row; 128 x 192 would spill)
TILINGS = tuple((bm, bn, bk) for bm in (64, 128) for bn in (64, 128)
                for bk in (8, 16, 32))
DEFAULT_CONFIG = {"block_m": 128, "block_n": 128, "block_k": 8}
TILINGS_BF16 = ((64, 64, 64), (64, 128, 64), (64, 192, 64), (128, 64, 64),
                (128, 128, 64))
DEFAULT_CONFIG_BF16 = {"block_m": 128, "block_n": 128, "block_k": 64}
# the one tiling of the bfloat16 face's ragged path
RAGGED_TILING = (128, 128, 32)

# the shared-memory layouts of csrc/matmul.cu: the float32 face and the
# ragged path a ring of _STAGES stages of the x tile [bm][bk + x pad] and
# the w tile [bk][bn + w pad], the pads in elements by face; the wgmma
# kernel a ring of _RING_BF16 stages of unpadded boxes, and 1024 bytes to
# align it for the 128-byte swizzle
_STAGES = 3
_PADS = {torch.float32: (4, 8), torch.bfloat16: (8, 8)}
_RING_BF16 = 4
_FACES = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16"}


def _is_bf16(dtype):
    return torch_dtype(dtype) == torch.bfloat16


def tilings(dtype=torch.float32):
    """The compiled tilings of the ``dtype`` face (a torch dtype or its
    name; any other than bfloat16 is the float32 face's)."""
    return TILINGS_BF16 if _is_bf16(dtype) else TILINGS


def default_config(dtype=torch.float32):
    """The default tiling dict of the ``dtype`` face."""
    return dict(DEFAULT_CONFIG_BF16 if _is_bf16(dtype) else DEFAULT_CONFIG)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def supports_matmul(x_shape, y_shape, dtype):
    """True for the 2-D gemm population the kernel targets: the JAX
    package's rule (M % 8, K % 128 and N % 128 all 0) on float32 or
    bfloat16 operands."""
    if len(x_shape) != 2 or len(y_shape) != 2:
        return False
    M, K = x_shape
    K2, N = y_shape
    if K != K2:
        return False
    if _dtype_name(dtype) not in ("float32", "bfloat16"):
        return False
    return M % 8 == 0 and K % 128 == 0 and N % 128 == 0


def _config_triple(config, dtype):
    """``(block_m, block_n, block_k)`` of ``config`` with missing keys
    from the ``dtype`` face's default; None when a value is not an int."""
    cfg = default_config(dtype)
    cfg.update(dict(config) if config else {})
    try:
        return (int(cfg["block_m"]), int(cfg["block_n"]),
                int(cfg["block_k"]))
    except (TypeError, ValueError):
        return None


def is_tiling(config, dtype=torch.float32):
    """True when ``config`` (missing keys from the face's default) names
    one of the ``dtype`` face's compiled tilings: the tune dispatch's
    test of a cached winner."""
    return _config_triple(config, dtype) in tilings(dtype)


def normalize_config(config=None, dtype=torch.float32):
    """``(block_m, block_n, block_k)`` of the ``config`` dict (missing
    keys from the ``dtype`` face's default), or that default when the
    triple is not one of the face's tilings."""
    triple = _config_triple(config, dtype)
    if triple not in tilings(dtype):
        default = default_config(dtype)
        triple = (default["block_m"], default["block_n"],
                  default["block_k"])
    return triple


def smem_bytes(bm, bn, bk, dtype=torch.float32):
    """Dynamic shared memory of one block of the tiling. float32: three
    stages of the x tile and the w tile, ``bm x (bk + 4)`` and ``bk x
    (bn + 8)`` values (``Tile::SMEM_BYTES`` of the source). bfloat16:
    the wgmma kernel's four stages of ``bm x bk`` and ``bk x bn`` values
    and 1024 bytes of alignment (``TileW::SMEM_BYTES``), or, at
    :data:`RAGGED_TILING`, the ragged path's three stages of ``bm x (bk
    + 8)`` and ``bk x (bn + 8)`` (``TileB::SMEM_BYTES``). ``dtype`` may
    be a torch dtype or its name; a dtype with no face is priced as
    float32."""
    if _is_bf16(dtype) and (bm, bn, bk) != RAGGED_TILING:
        return _RING_BF16 * (bm * bk + bk * bn) * 2 + 1024
    dtype = torch.bfloat16 if _is_bf16(dtype) else torch.float32
    xpad, wpad = _PADS[dtype]
    return _STAGES * (bm * (bk + xpad) + bk * (bn + wpad)) * dtype.itemsize


def matmul_reference(x, w, config=None, out_dtype=None):
    """Plain version: ``x [M, K] @ w [K, N]`` as the float32 sum over the
    tiling's k tiles (the ``x.dtype`` face's tiling), in order, of
    ``x[:, k0:k1] @ w[k0:k1, :]`` (float64 operands: float64), written in
    ``out_dtype or x.dtype`` (bfloat16 products are exact in float32,
    and the sum is rounded once)."""
    _, _, bk = normalize_config(config, x.dtype)
    K = x.shape[1]
    acc = torch.promote_types(x.dtype, torch.float32)
    out = None
    for k0 in range(0, max(K, 1), bk):
        t = torch.matmul(x[:, k0:k0 + bk].to(acc), w[k0:k0 + bk].to(acc))
        out = t if out is None else out + t
    return out.to(out_dtype or x.dtype)


def _check(x, w, out_dtype):
    if x.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, x.device))
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("%s: the kernel takes x [M, K] and w [K, N], got "
                         "%s and %s" % (_NAME, tuple(x.shape),
                                        tuple(w.shape)))
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


def _launch(x, w, tiling, out_dtype=None):
    """Launch the ``x.dtype`` face at ``tiling``; returns the output and,
    for bfloat16, whether the ragged path ran (float32: False)."""
    M, K = x.shape
    N = w.shape[1]
    out_dtype = out_dtype or x.dtype
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out, False
    lib = _build.load(_NAME)
    fn = getattr(lib, _FACES[x.dtype])
    fn.restype = ctypes.c_int
    stream = _build.stream_handle(x.device)
    if x.dtype != torch.bfloat16:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                  *tiling, stream)
        _build.check(lib, code, _NAME)
        return out, False
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + \
        [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    ragged = ctypes.c_int(0)
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, *tiling,
              int(out_dtype == torch.float32), ctypes.byref(ragged), stream)
    _build.check(lib, code, _NAME)
    return out, bool(ragged.value)


def kernel_smem_bytes(bm, bn, bk, dtype=torch.float32):
    """The built library's shared memory of a tiling's block, float32 or
    bfloat16 face (the ragged path's at :data:`RAGGED_TILING`), or -1
    for a tiling it does not have."""
    lib = _build.load(_NAME)
    fn = lib.matmul_bf16_smem_bytes if _is_bf16(dtype) \
        else lib.matmul_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(bm, bn, bk)


def _forward(x, w, out_dtype, config):
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    global launches, launches_bf16, launches_bf16_ragged
    if x.device.type == "cpu":
        return matmul_reference(x, w, config, out_dtype)
    _check(x, w, out_dtype)
    out, ragged = _launch(x, w, normalize_config(config, x.dtype),
                          out_dtype)
    if x.dtype != torch.bfloat16:
        launches += 1
    elif ragged:
        launches_bf16_ragged += 1
    else:
        launches_bf16 += 1
    return out


class _Matmul(torch.autograd.Function):
    """The kernel forward with the JAX custom vjp's backward: dx = g wᵀ,
    dw = xᵀ g as plain products."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, config):
        ctx.save_for_backward(x, w)
        return _forward(x, w, out_dtype, config)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        dx = torch.matmul(g, w.float().t()).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        dw = torch.matmul(x.float().t(), g).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


def matmul(x, w, out_dtype=None, config=None):
    """``x [M, K] @ w [K, N] -> [M, N]``, float32 sums, written in
    ``out_dtype or x.dtype``, differentiable in ``x`` and ``w``.
    ``config`` is a tune "matmul" tiling dict; None runs the face's
    default (:func:`default_config`). On CUDA: contiguous operands on one device,
    both float32 (float32 out) or both bfloat16 (bfloat16 or float32
    out); anything else raises."""
    return _Matmul.apply(x, w, out_dtype, config)
