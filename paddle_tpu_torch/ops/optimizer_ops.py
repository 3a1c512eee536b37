"""Optimizers as ops (counterparts in ``paddle_tpu/ops/optimizer_ops.py``:
``sgd`` :30, ``momentum`` :43, ``adam`` :60). Each reads Param, Grad,
LearningRate and its accumulators and writes ParamOut (the same var as
Param), so the Executor's write-back carries the update into the scope.
The updates make new tensors; the dense gradients of the ported slices
need no sparse (SelectedRows) branch.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

__all__ = []


def _lr(ctx):
    return ctx.input("LearningRate").reshape(())


@register_op("sgd", no_gradient=True, stateful_outputs=("ParamOut",))
def sgd(ctx):
    ctx.set_output("ParamOut",
                   ctx.input("Param") - _lr(ctx) * ctx.input("Grad"))


@register_op("momentum", no_gradient=True,
             stateful_outputs=("ParamOut", "VelocityOut"))
def momentum(ctx):
    """``v = mu * v + g``; ``p -= lr * v``, or with Nesterov
    ``p -= lr * (g + mu * v)``."""
    p = ctx.input("Param")
    g = ctx.input("Grad")
    mu = ctx.attr("mu")
    lr = _lr(ctx)
    v_new = mu * ctx.input("Velocity") + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("adam", no_gradient=True,
             stateful_outputs=("ParamOut", "Moment1Out", "Moment2Out"))
def adam(ctx):
    p = ctx.input("Param")
    g = ctx.input("Grad")
    m1 = ctx.input("Moment1")
    m2 = ctx.input("Moment2")
    b1p = ctx.input("Beta1Pow").reshape(())
    b2p = ctx.input("Beta2Pow").reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr = _lr(ctx) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    m1n = b1 * m1 + (1.0 - b1) * g
    m2n = b2 * m2 + (1.0 - b2) * g * g
    ctx.set_output("ParamOut", p - lr * m1n / (torch.sqrt(m2n) + eps))
    ctx.set_output("Moment1Out", m1n)
    ctx.set_output("Moment2Out", m2n)
