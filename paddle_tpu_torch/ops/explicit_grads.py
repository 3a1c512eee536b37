"""Explicit grad ops of the transformer LM's and ResNet's backward
(counterpart of the matching part of ``paddle_tpu/ops/explicit_grads.py``:
``relu_grad``, ``softmax_grad`` :113, ``mul_grad``,
``elementwise_add_grad``, ``conv2d_grad`` :285, ``pool2d_grad`` :366,
``batch_norm_grad`` :408, ``cross_entropy_grad`` :478,
``softmax_with_cross_entropy_grad``, ``mean_grad``, ``scale_grad``).

Each forward op here gets a grad maker that emits one closed-form grad
op instead of the generic replay. Imported last by ``ops/__init__.py``,
after the forward ops it attaches to are registered.
"""
from __future__ import annotations

import torch

from ..core import registry
from ..kernels import conv3x3
from ..core.executor import raw_data, with_lod_of
from ..core.ir import grad_var_name
from ..core.registry import register_op
from ..core.types import is_floating
from .common import flatten_to_2d
from .nn_ops import _bn_grad_maker, bn_axes, pool2d_apply, uses_conv3x3_kernel

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


@register_op("softmax_grad", no_gradient=True)
def softmax_grad(ctx):
    out = ctx.input("Out")
    dy = ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD",
                   out * (dy - torch.sum(dy * out, dim=-1, keepdim=True)))


_attach("softmax", "softmax_grad", need_outputs=("Out",))


@register_op("mul_grad", no_gradient=True)
def mul_grad(ctx):
    """Gemms on the flattened 2-D views: dX = dOut Yᵀ, dY = Xᵀ dOut.
    dX keeps X's LoD."""
    x_v = ctx.input("X")
    x = raw_data(x_v)
    y = raw_data(ctx.input("Y"))
    dy = raw_data(ctx.input("Out@GRAD"))
    x2 = flatten_to_2d(x, ctx.attr("x_num_col_dims", 1))
    y2 = flatten_to_2d(y, ctx.attr("y_num_col_dims", 1))
    dy2 = dy.reshape(x2.shape[0], y2.shape[1])
    if ctx.op.output("X@GRAD"):
        ctx.set_output("X@GRAD", with_lod_of(
            x_v, torch.matmul(dy2, y2.t()).reshape(x.shape)))
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
    """dX is dOut with X's LoD; dY sums dOut over the broadcast dims."""
    x_v = ctx.input("X")
    x = raw_data(x_v)
    y = raw_data(ctx.input("Y"))
    dy = raw_data(ctx.input("Out@GRAD"))
    if ctx.op.output("X@GRAD"):
        ctx.set_output("X@GRAD", with_lod_of(x_v, dy.to(x.dtype)))
    if ctx.op.output("Y@GRAD"):
        ctx.set_output("Y@GRAD", _unbcast_to(dy, y.shape,
                                             ctx.attr("axis", -1))
                       .to(y.dtype))


_attach("elementwise_add", "elementwise_add_grad", need_inputs=("X", "Y"),
        diff_slots=("X", "Y"))


@register_op("conv2d_grad", no_gradient=True)
def conv2d_grad(ctx):
    """dInput and dFilter without replaying the forward (the JAX grad
    replays it under ``jax.vjp``, where XLA drops the dead primal; here
    it would be a real launch). The conv3x3 kernel's population takes
    that wrapper's backward through the NHWC/HWIO transposes: dx by the
    kernel, dw by the 9 tap contractions. Every other conv takes
    ``convolution_backward``, the backward of torch's conv2d."""
    x = ctx.input("Input")
    w = ctx.input("Filter")
    dy = ctx.input("Output@GRAD")
    s = ctx.attr("strides", [1, 1])
    p = ctx.attr("paddings", [0, 0])
    d = ctx.attr("dilations", [1, 1])
    groups = ctx.attr("groups", 1) or 1
    want_dx = bool(ctx.op.output("Input@GRAD"))
    want_dw = bool(ctx.op.output("Filter@GRAD"))
    if uses_conv3x3_kernel(w.shape, s, p, d, groups, ctx.attr("conv_impl")):
        dx, dw = conv3x3.conv3x3_bwd(
            x.permute(0, 2, 3, 1).contiguous(),
            w.permute(2, 3, 1, 0).contiguous(),
            dy.permute(0, 2, 3, 1).contiguous(), want_dx, want_dw)
        dx = dx.permute(0, 3, 1, 2).contiguous() if want_dx else None
        dw = dw.permute(3, 2, 0, 1).contiguous() if want_dw else None
    else:
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, list(s), list(p), list(d), False, [0, 0],
            groups, [want_dx, want_dw, False])
    ctx.set_output("Input@GRAD", dx)     # each a no-op when not wired
    ctx.set_output("Filter@GRAD", dw)


_attach("conv2d", "conv2d_grad", need_inputs=("Input", "Filter"),
        diff_slots=("Input", "Filter"), out_slot="Output")


@register_op("pool2d_grad", no_gradient=True)
def pool2d_grad(ctx):
    """Global pooling in closed form (a max splits its gradient evenly
    over the tied maxima); windowed pooling by replaying
    ``nn_ops.pool2d_apply`` under autograd, the JAX grad's ``jax.vjp``
    of the same function."""
    x = ctx.input("X")
    dy = ctx.input("Out@GRAD")
    ptype = ctx.attr("pooling_type", "max")
    if ctx.attr("global_pooling", False):
        if ptype == "max":
            mask = (x == torch.amax(x, dim=(2, 3), keepdim=True)).to(x.dtype)
            mask = mask / torch.clamp(torch.sum(mask, dim=(2, 3),
                                                keepdim=True), min=1.0)
            ctx.set_output("X@GRAD", mask * dy)
        else:
            n = x.shape[2] * x.shape[3]
            ctx.set_output("X@GRAD", (dy / n).expand(x.shape).contiguous())
        return
    leaf = x.detach().requires_grad_(True)
    with torch.enable_grad():
        out = pool2d_apply(leaf, ptype, ctx.attr("ksize"),
                           ctx.attr("strides", [1, 1]),
                           ctx.attr("paddings", [0, 0]),
                           bool(ctx.attr("ceil_mode", False)),
                           ctx.attr("exclusive", True))
    dx, = torch.autograd.grad(out, leaf, dy.to(out.dtype))
    ctx.set_output("X@GRAD", dx)


_attach("pool2d", "pool2d_grad", need_inputs=("X",))


@register_op("batch_norm_grad", no_gradient=True)
def batch_norm_grad(ctx):
    """Closed-form dX, dScale and dBias from the saved batch statistics
    (``SavedVariance`` holds the inverse std in training)."""
    x = ctx.input("X")
    scale = ctx.input("Scale")
    dy = ctx.input("Y@GRAD")
    eps = ctx.attr("epsilon", 1e-5)
    is_test = ctx.attr("is_test", False)
    axes, cshape = bn_axes(x, ctx.attr("data_layout", "NCHW"))
    mean = ctx.input("SavedMean")
    saved_var = ctx.input("SavedVariance")
    inv = 1.0 / torch.sqrt(saved_var + eps) if is_test else saved_var
    xhat = (x - mean.reshape(cshape)) * inv.reshape(cshape)
    dscale = torch.sum(dy * xhat, dim=axes)
    dbias = torch.sum(dy, dim=axes)
    if ctx.op.output("Scale@GRAD"):
        ctx.set_output("Scale@GRAD", dscale.to(scale.dtype))
    if ctx.op.output("Bias@GRAD"):
        ctx.set_output("Bias@GRAD", dbias.to(scale.dtype))
    if ctx.op.output("X@GRAD"):
        if is_test:
            dx = dy * (scale * inv).reshape(cshape)
        else:
            n = 1
            for a in axes:
                n *= x.shape[a]
            dx = (scale * inv).reshape(cshape) / n * (
                n * dy - dbias.reshape(cshape)
                - xhat * dscale.reshape(cshape))
        ctx.set_output("X@GRAD", dx.to(x.dtype))


def _bn_explicit_grad_maker(op, block, grad_of, no_grad):
    g = grad_of.get(op.output("Y")[0])
    if g is None:
        return None
    if not (op.output("SavedMean") and op.output("SavedVariance")):
        # saved stats not wired (a bare-op program): the restricted
        # replay, (X, Scale, Bias) -> Y only
        return _bn_grad_maker(op, block, grad_of, no_grad)
    inputs = {"X": list(op.input("X")), "Scale": list(op.input("Scale")),
              "SavedMean": list(op.output("SavedMean")),
              "SavedVariance": list(op.output("SavedVariance")),
              "Y@GRAD": [g]}
    outputs = {}
    for slot in ("X", "Scale", "Bias"):
        n = op.input(slot)[0]
        if _is_diffable(block, n, no_grad):
            outputs[slot + "@GRAD"] = [grad_var_name(n)]
    if not outputs:
        return None
    return [("batch_norm_grad", inputs, outputs, dict(op.attrs))]


registry.lookup_checked("batch_norm").grad_maker = _bn_explicit_grad_maker


@register_op("cross_entropy_grad", no_gradient=True)
def cross_entropy_grad(ctx):
    """X holds probabilities; the forward clips them to [1e-15, 1], so
    the grad is zero where X lies outside that range."""
    x = ctx.input("X")
    label = ctx.input("Label")
    dy = ctx.input("Y@GRAD")
    clipped = torch.clamp(x, 1e-15, 1.0)
    in_range = ((x >= 1e-15) & (x <= 1.0)).to(x.dtype)
    if ctx.attr("soft_label", False):
        dx = -dy * label.to(x.dtype) / clipped * in_range
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        lab = label.long().reshape(-1)
        dx = torch.zeros_like(x)
        dx[rows, lab] = (-dy.reshape(-1) / clipped[rows, lab]
                         * in_range[rows, lab])
    ctx.set_output("X@GRAD", dx)


_attach("cross_entropy", "cross_entropy_grad", need_inputs=("X", "Label"),
        out_slot="Y")


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
    x_v = ctx.input("X")
    x = raw_data(x_v)
    dy = ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD", with_lod_of(x_v, (dy.reshape(()) / x.numel())
                                         .expand(x.shape).to(x.dtype)))


_attach("mean", "mean_grad", need_inputs=("X",))


@register_op("scale_grad", no_gradient=True)
def scale_grad(ctx):
    ctx.set_output("X@GRAD", ctx.input("Out@GRAD") * ctx.attr("scale", 1.0))


_attach("scale", "scale_grad", need_inputs=())
