"""Shared lowering helpers (counterpart of ``paddle_tpu/ops/common.py``):
Paddle's elementwise broadcasting and the mul op's 2-D flattening."""
from __future__ import annotations

from ..core.types import convert_dtype, torch_dtype

__all__ = ["bcast_y_to_x", "elementwise", "flatten_to_2d", "np_dtype",
           "prod", "tdt"]


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
    x = ctx.input("X")
    y = ctx.input("Y")
    ctx.set_output("Out", fn(x, bcast_y_to_x(x, y, ctx.attr("axis", -1))))


def prod(it):
    p = 1
    for v in it:
        p *= int(v)
    return p
