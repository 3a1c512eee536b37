"""NN ops of the transformer LM (counterparts in
``paddle_tpu/ops/nn_ops.py``: ``relu`` :48/67, ``layer_norm`` :774)."""
from __future__ import annotations

import torch

from ..core.registry import register_op

__all__ = []


def _infer_same(op, block):
    names = op.input("X")
    if not names:
        return
    xv = block._find_var_recursive(names[0])
    for n in op.output("Out"):
        ov = block._find_var_recursive(n)
        if ov is not None and xv is not None:
            ov.shape = xv.shape
            ov.dtype = xv.dtype
            ov.lod_level = xv.lod_level


@register_op("relu", infer_shape=_infer_same)
def relu(ctx):
    ctx.set_output("Out", torch.relu(ctx.input("X")))


@register_op("layer_norm", infer_shape=_infer_same)
def layer_norm(ctx):
    """Normalise over the dims from ``begin_norm_axis`` on, with the
    population variance, then scale and shift; the JAX lowering's
    formula as written."""
    x = ctx.input("X")
    begin = ctx.attr("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    eps = ctx.attr("epsilon", 1e-5)
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    y = (x - mean) / torch.sqrt(var + eps)
    norm_shape = (1,) * begin + tuple(x.shape[begin:])
    if ctx.has_input("Scale"):
        y = y * ctx.input("Scale").reshape(norm_shape)
    if ctx.has_input("Bias"):
        y = y + ctx.input("Bias").reshape(norm_shape)
    ctx.set_output("Y", y)
    ctx.set_output("Mean", mean.reshape(-1))
    ctx.set_output("Variance", var.reshape(-1))
