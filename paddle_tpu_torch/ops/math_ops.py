"""Math ops (counterparts in ``paddle_tpu/ops/math_ops.py``: ``mul`` :61,
``elementwise_add`` :132, ``sum`` :154, ``scale`` :176, ``cumsum`` :201,
``mean`` :279, ``top_k`` :325).

``mul`` is a ``torch.matmul`` of the flattened operands. The JAX
package's default is ``jnp.matmul`` too: its Pallas matmul runs only for
a cached tune winner (``math_ops.py:27-46``), and the tune cache is not
ported.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import elementwise, flatten_to_2d

__all__ = []


def _infer_mul(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    yv = block._find_var_recursive(op.input("Y")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, yv, ov) or xv.shape is None or yv.shape is None:
        return
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    ov.shape = tuple(xv.shape[:xn]) + tuple(yv.shape[yn:])
    ov.dtype = xv.dtype


@register_op("mul", infer_shape=_infer_mul)
def mul(ctx):
    """Flatten X by ``x_num_col_dims`` and Y by ``y_num_col_dims``, one
    gemm, reshape to X's leading dims + Y's trailing dims."""
    x = ctx.input("X")
    y = ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    out = torch.matmul(flatten_to_2d(x, xn), flatten_to_2d(y, yn))
    ctx.set_output("Out", out.reshape(tuple(x.shape[:xn])
                                      + tuple(y.shape[yn:])))


def _infer_ew(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if xv is not None and ov is not None:
        ov.shape = xv.shape
        ov.dtype = xv.dtype


@register_op("elementwise_add", infer_shape=_infer_ew)
def elementwise_add(ctx):
    elementwise(ctx, torch.add)


@register_op("sum", infer_shape=_infer_ew)
def sum_op(ctx):
    """Multi-input add, the gradient-accumulation op of backward."""
    xs = ctx.inputs("X")
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    ctx.set_output("Out", out)


@register_op("scale", infer_shape=_infer_ew)
def scale(ctx):
    x = ctx.input("X")
    s = ctx.attr("scale", 1.0)
    b = ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    ctx.set_output("Out", out)


@register_op("cumsum")
def cumsum(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", -1)
    if ctx.attr("reverse", False):
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if ctx.attr("exclusive", False):
        out = out - x
    if ctx.attr("reverse", False):
        out = torch.flip(out, (axis,))
    ctx.set_output("Out", out)


def _infer_mean(op, block):
    ov = block._find_var_recursive(op.output("Out")[0])
    xv = block._find_var_recursive(op.input("X")[0])
    if ov is not None:
        ov.shape = (1,)
        if xv is not None:
            ov.dtype = xv.dtype


@register_op("mean", infer_shape=_infer_mean)
def mean(ctx):
    ctx.set_output("Out", torch.mean(ctx.input("X")).reshape((1,)))


@register_op("top_k", no_gradient=True)
def top_k(ctx):
    """The ``k`` largest values of the last axis and their int64
    indices, largest first."""
    vals, idx = torch.topk(ctx.input("X"), ctx.attr("k", 1), dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx)
