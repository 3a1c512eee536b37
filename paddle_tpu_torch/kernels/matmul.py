"""Blocked matrix product (counterpart of ``paddle_tpu/kernels/matmul.py``).

``x [M, K] @ w [K, N] -> [M, N]`` with float32 sums, in a tiling
``config = {"block_m", "block_n", "block_k"}`` that the autotuner
(``paddle_tpu_torch/tune``) searches.

- :func:`matmul_reference` is the plain version: the float32 sum, over
  the tiling's k tiles in order, of ``x[:, k0:k1] @ w[k0:k1, :]``, the
  kernel's accumulation order at tile level. A CPU tensor gets it.
- :func:`matmul` is the wrapper, a ``torch.autograd.Function``. A CUDA
  tensor gets the hand-written kernel of ``csrc/matmul.cu`` or an
  exception, never the plain version or ``torch.matmul``. Its backward
  is two ``torch.matmul`` products, as the JAX custom vjp's is two
  stock gemms (``_vjp_bwd``), so the kernel needs no backward.
- ``launches`` counts the kernel launches.

Dispatch: ``ops/math_ops.py`` routes ``mul`` here only when the tune
cache holds a winner tiling for the (device, shape); otherwise ``mul``
is ``torch.matmul``, as the JAX package's is ``jnp.matmul``.

The JAX kernel takes ``block_*`` of 0 for the full extent and needs
blocks that divide the shape; this kernel masks its ragged edges, so
any shape is right, and its tilings are the template instantiations of
``csrc/matmul.cu`` (:data:`TILINGS`). :func:`normalize_config` maps a
tiling that is not compiled (a stale cache entry) to the default one,
the JAX rule that a stale entry must degrade to a correct schedule and
never fail the call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["DEFAULT_CONFIG", "TILINGS", "launches", "matmul",
           "matmul_reference", "normalize_config", "smem_bytes",
           "supports_matmul"]

# kernel launches since the last reset
launches = 0

_NAME = "matmul"

# the (block_m, block_n, block_k) instantiations of csrc/matmul.cu
TILINGS = tuple((bm, bn, bk) for bm in (64, 128) for bn in (64, 128)
                for bk in (8, 16, 32))
DEFAULT_CONFIG = {"block_m": 128, "block_n": 128, "block_k": 8}

# the shared-memory layout of csrc/matmul.cu: a ring of _STAGES stages of
# the x tile [bm][bk + _X_PAD] and the w tile [bk][bn + _W_PAD]
_STAGES = 3
_X_PAD = 4
_W_PAD = 8


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def supports_matmul(x_shape, y_shape, dtype):
    """True for the 2-D gemm population the kernel targets: the JAX
    package's alignment rule (M % 8, K % 128 and N % 128 all 0) on
    float32 operands. bfloat16, which the JAX kernel also takes, stays
    out: the port has no AMP and the kernel is float32 only."""
    if len(x_shape) != 2 or len(y_shape) != 2:
        return False
    M, K = x_shape
    K2, N = y_shape
    if K != K2:
        return False
    if _dtype_name(dtype) != "float32":
        return False
    return M % 8 == 0 and K % 128 == 0 and N % 128 == 0


def normalize_config(config=None):
    """``(block_m, block_n, block_k)`` of the ``config`` dict (missing
    keys from :data:`DEFAULT_CONFIG`), or the default tiling when that
    triple is not compiled."""
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(dict(config) if config else {})
    try:
        triple = (int(cfg["block_m"]), int(cfg["block_n"]),
                  int(cfg["block_k"]))
    except (TypeError, ValueError):
        triple = None
    if triple not in TILINGS:
        triple = (DEFAULT_CONFIG["block_m"], DEFAULT_CONFIG["block_n"],
                  DEFAULT_CONFIG["block_k"])
    return triple


def smem_bytes(bm, bn, bk):
    """Dynamic shared memory of one block of the tiling: three stages of
    the x tile (``bm x (bk + 4)``) and the w tile (``bk x (bn + 8)``),
    float32 (``Tile::SMEM_BYTES`` of the source)."""
    return _STAGES * (bm * (bk + _X_PAD) + bk * (bn + _W_PAD)) * 4


def matmul_reference(x, w, config=None):
    """Plain version: ``x [M, K] @ w [K, N]`` as the float32 sum over the
    tiling's k tiles, in order, of ``x[:, k0:k1] @ w[k0:k1, :]``."""
    _, _, bk = normalize_config(config)
    K = x.shape[1]
    out = None
    for k0 in range(0, max(K, 1), bk):
        t = torch.matmul(x[:, k0:k0 + bk].float(), w[k0:k0 + bk].float())
        out = t if out is None else out + t
    return out


def _check(x, w, out_dtype):
    if x.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, x.device))
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("%s: the kernel takes x [M, K] and w [K, N], got "
                         "%s and %s" % (_NAME, tuple(x.shape),
                                        tuple(w.shape)))
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise ValueError("%s: the kernel takes float32 operands, %s is "
                             "%s" % (_NAME, name, t.dtype))
    if out_dtype not in (None, torch.float32):
        raise ValueError("%s: the kernel writes float32, not %s"
                         % (_NAME, out_dtype))
    _build.check_cuda_operands(_NAME, x.device, x=x, w=w)


def _launch(x, w, tiling):
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _build.load(_NAME)
    fn = lib.matmul_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, *tiling,
              _build.stream_handle(x.device))
    _build.check(lib, code, _NAME)
    return out


def _forward(x, w, out_dtype, config):
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    global launches
    tiling = normalize_config(config)
    if x.device.type == "cpu":
        out = matmul_reference(x, w, config)
        return out if out_dtype is None else out.to(out_dtype)
    _check(x, w, out_dtype)
    out = _launch(x, w, tiling)
    launches += 1
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
    """``x [M, K] @ w [K, N] -> [M, N]``, float32 sums, differentiable in
    ``x`` and ``w``. ``config`` is a tune "matmul" tiling dict; None
    runs :data:`DEFAULT_CONFIG`. On CUDA: float32, contiguous operands
    on one device; anything else raises."""
    return _Matmul.apply(x, w, out_dtype, config)
