"""Shared lowering helpers (counterpart of ``paddle_tpu/ops/common.py``):
Paddle's elementwise broadcasting, the mul op's 2-D flattening, and
``abs`` and ``clip`` with the gradients JAX gives them where the
function has a corner (ROADMAP Queue 3 #27), and device copies of host
tables that a captured step may read."""
from __future__ import annotations

import numpy as np
import torch

from .. import amp
from ..core.executor import raw_data, with_lod_of
from ..core.types import convert_dtype, torch_dtype

__all__ = ["bcast_y_to_x", "constant", "elementwise", "flatten_to_2d", "jax_abs",
           "jax_clip", "np_dtype", "prod", "tdt"]


def np_dtype(attr_val, default="float32"):
    return convert_dtype(attr_val if attr_val is not None else default)


def tdt(attr_val, default="float32"):
    """The torch dtype of a dtype attr."""
    return torch_dtype(np_dtype(attr_val, default))


def bcast_y_to_x(x, y, axis):
    """Paddle elementwise broadcasting: Y's shape is a contiguous
    sub-sequence of X's, placed at ``axis`` (-1 aligns the trailing
    dims)."""
    if x.ndim == y.ndim:
        return y
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > x.ndim - axis:
        yshape = yshape[:-1]
    new_shape = [1] * axis + yshape + [1] * (x.ndim - axis - len(yshape))
    return y.reshape(new_shape)


def flatten_to_2d(x, num_col_dims):
    """The mul op's flattening by ``x_num_col_dims``."""
    return x.reshape(prod(x.shape[:num_col_dims]),
                     prod(x.shape[num_col_dims:]))


def elementwise(ctx, fn):
    """``fn(X, Y)`` under Paddle's broadcasting; Out keeps X's LoD.
    Under pure AMP a bfloat16 operand (either of them: a residual add
    may take the bfloat16 branch as Y) combined with a float32 one
    promotes to float32, and the result is written back in bfloat16,
    so the activation stream stays half-width; float64 stays exact."""
    x_v = ctx.input("X")
    x, y = raw_data(x_v), raw_data(ctx.input("Y"))
    out = fn(x, bcast_y_to_x(x, y, ctx.attr("axis", -1)))
    if (out.dtype != torch.bfloat16
            and torch.bfloat16 in (x.dtype, y.dtype)
            and torch.float64 not in (x.dtype, y.dtype)
            and amp.keep_bf16(ctx)):
        out = out.to(torch.bfloat16)
    ctx.set_output("Out", with_lod_of(x_v, out))


def prod(it):
    p = 1
    for v in it:
        p *= int(v)
    return p


def jax_abs(x):
    """|x| with ``jnp.abs``'s gradient: +1 at 0 (``torch.abs`` gives 0
    there); ``x + 0.0`` makes -0.0 into +0.0, as ``jnp.abs`` does."""
    return torch.where(x >= 0, x + 0.0, -x)


def jax_clip(x, lo=None, hi=None):
    """``jnp.clip``: min(max(x, lo), hi), so that at a bound each side
    takes half the gradient (``torch.clamp`` passes all of it)."""
    # each bound filled on the device (``new_full``): a tensor made from
    # a host value would be a copy, which a CUDA graph capture refuses
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


# device copies of host tables (assign_value's values, index tables),
# made once per (device, values) at a key's eager warm-up: a capture may
# not copy from pageable host memory, so the captured step clones the
# table on the device instead
_CONSTANTS = {}


def constant(vals, device):
    """A fresh device tensor holding the numpy array ``vals``."""
    vals = np.asarray(vals)
    key = (str(device), vals.dtype.str, vals.shape, vals.tobytes())
    t = _CONSTANTS.get(key)
    if t is None:
        if len(_CONSTANTS) > 256:
            _CONSTANTS.clear()
        t = _CONSTANTS[key] = torch.from_numpy(vals.copy()).to(device)
    return t.clone()
