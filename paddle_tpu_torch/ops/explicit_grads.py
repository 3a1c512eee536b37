"""Explicit grad ops of the transformer LM's backward (counterpart of the
matching part of ``paddle_tpu/ops/explicit_grads.py``: ``relu_grad``,
``mul_grad``, ``elementwise_add_grad``,
``softmax_with_cross_entropy_grad``, ``mean_grad``, ``scale_grad``).

Each forward op here gets a grad maker that emits one closed-form grad
op instead of the generic replay. Imported last by ``ops/__init__.py``,
after the forward ops it attaches to are registered.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..core.ir import grad_var_name
from ..core.registry import register_op
from ..core.types import is_floating
from .common import flatten_to_2d

__all__ = ["simple_grad_maker"]


def _is_diffable(block, name, no_grad):
    var = block._find_var_recursive(name)
    return (name not in no_grad and var is not None
            and not var.stop_gradient
            and (var.dtype is None or is_floating(var.dtype)))


def simple_grad_maker(grad_type, need_inputs=(), need_outputs=(),
                      diff_slots=("X",), out_slot="Out"):
    """Grad maker emitting one ``grad_type`` op: its inputs are the
    listed forward input and output slots and ``<out_slot>@GRAD``; its
    outputs ``<slot>@GRAD`` for each diff slot that wants a gradient.
    When another forward output has a gradient too, the generic maker
    takes over."""

    def maker(op, block, grad_of, no_grad):
        g = grad_of.get(op.output(out_slot)[0]) \
            if op.output(out_slot) else None
        if g is None:
            return None
        for s, names in op.outputs.items():
            if s != out_slot and any(grad_of.get(n) is not None
                                     for n in names):
                from ..core.backward import default_grad_maker
                return default_grad_maker(op, block, grad_of, no_grad)
        inputs = {s: list(op.inputs[s]) for s in need_inputs
                  if s in op.inputs}
        for s in need_outputs:
            if s in op.outputs:
                inputs[s] = list(op.outputs[s])
        inputs[out_slot + "@GRAD"] = [g]
        outputs = {}
        for s in diff_slots:
            names = op.input(s)
            if names and _is_diffable(block, names[0], no_grad):
                outputs[s + "@GRAD"] = [grad_var_name(names[0])]
        if not outputs:
            return None
        return [(grad_type, inputs, outputs, dict(op.attrs))]

    return maker


def _attach(fwd_type, grad_type, **maker_kw):
    registry.lookup_checked(fwd_type).grad_maker = \
        simple_grad_maker(grad_type, **maker_kw)


@register_op("relu_grad", no_gradient=True)
def relu_grad(ctx):
    out = ctx.input("Out")
    ctx.set_output("X@GRAD", ctx.input("Out@GRAD") * (out > 0))


_attach("relu", "relu_grad", need_outputs=("Out",))


@register_op("mul_grad", no_gradient=True)
def mul_grad(ctx):
    """Gemms on the flattened 2-D views: dX = dOut Yᵀ, dY = Xᵀ dOut."""
    x = ctx.input("X")
    y = ctx.input("Y")
    dy = ctx.input("Out@GRAD")
    x2 = flatten_to_2d(x, ctx.attr("x_num_col_dims", 1))
    y2 = flatten_to_2d(y, ctx.attr("y_num_col_dims", 1))
    dy2 = dy.reshape(x2.shape[0], y2.shape[1])
    if ctx.op.output("X@GRAD"):
        ctx.set_output("X@GRAD", torch.matmul(dy2, y2.t()).reshape(x.shape))
    if ctx.op.output("Y@GRAD"):
        ctx.set_output("Y@GRAD", torch.matmul(x2.t(), dy2).reshape(y.shape))


_attach("mul", "mul_grad", need_inputs=("X", "Y"), diff_slots=("X", "Y"))


def _unbcast_to(g, shape, axis):
    """Reduce ``g`` (X's shape) back to Y's ``shape`` under Paddle's
    sub-sequence broadcasting at ``axis``."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    if axis is None or axis == -1:
        axis = g.ndim - len(shape)
    yshape = list(shape)
    while yshape and yshape[-1] == 1 and len(yshape) > g.ndim - axis:
        yshape = yshape[:-1]
    red = tuple(range(axis)) + tuple(range(axis + len(yshape), g.ndim))
    if red:
        g = torch.sum(g, dim=red)
    for i, s in enumerate(yshape):
        if s == 1 and g.shape[i] != 1:
            g = torch.sum(g, dim=i, keepdim=True)
    return g.reshape(shape)


@register_op("elementwise_add_grad", no_gradient=True)
def elementwise_add_grad(ctx):
    x = ctx.input("X")
    y = ctx.input("Y")
    dy = ctx.input("Out@GRAD")
    if ctx.op.output("X@GRAD"):
        ctx.set_output("X@GRAD", dy.to(x.dtype))
    if ctx.op.output("Y@GRAD"):
        ctx.set_output("Y@GRAD", _unbcast_to(dy, y.shape,
                                             ctx.attr("axis", -1))
                       .to(y.dtype))


_attach("elementwise_add", "elementwise_add_grad", need_inputs=("X", "Y"),
        diff_slots=("X", "Y"))


@register_op("softmax_with_cross_entropy_grad", no_gradient=True)
def softmax_with_cross_entropy_grad(ctx):
    """dLogits = dLoss * (Softmax - onehot(Label)); the one-hot is
    subtracted in place on a copy of Softmax, so no [N, C] one-hot is
    made."""
    softmax = ctx.input("Softmax")
    label = ctx.input("Label")
    dy = ctx.input("Loss@GRAD")
    if ctx.attr("soft_label", False):
        lab = label.to(softmax.dtype)
        dlogits = dy * (softmax * torch.sum(lab, dim=-1, keepdim=True) - lab)
    else:
        rows = torch.arange(softmax.shape[0], device=softmax.device)
        dlogits = softmax.clone()
        dlogits[rows, label.long().reshape(-1)] -= 1
        dlogits *= dy
    ctx.set_output("Logits@GRAD", dlogits)


_attach("softmax_with_cross_entropy", "softmax_with_cross_entropy_grad",
        need_inputs=("Label",), need_outputs=("Softmax",), out_slot="Loss",
        diff_slots=("Logits",))


@register_op("mean_grad", no_gradient=True)
def mean_grad(ctx):
    x = ctx.input("X")
    dy = ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD", (dy.reshape(()) / x.numel())
                   .expand(x.shape).to(x.dtype))


_attach("mean", "mean_grad", need_inputs=("X",))


@register_op("scale_grad", no_gradient=True)
def scale_grad(ctx):
    ctx.set_output("X@GRAD", ctx.input("Out@GRAD") * ctx.attr("scale", 1.0))


_attach("scale", "scale_grad", need_inputs=())
