"""Explicit grad ops of the transformer LM's and ResNet's backward
(counterpart of the matching part of ``paddle_tpu/ops/explicit_grads.py``:
``relu_grad``, the output-form activation grads :90-110 (``tanh``,
``sigmoid``, ``exp``, ``sqrt``, ``reciprocal``), ``softmax_grad`` :113,
``mul_grad``, ``matmul_grad`` :159 with its maker :199,
``elementwise_{add,sub,mul}_grad`` :238-281,
``conv2d_grad`` :285 (also ``depthwise_conv2d``'s, :359-361),
``pool2d_grad`` :366, ``batch_norm_grad`` :408,
``cross_entropy_grad`` :478,
``softmax_with_cross_entropy_grad``, ``mean_grad``, ``scale_grad``).

Each forward op here gets a grad maker that emits one closed-form grad
op instead of the generic replay. Imported last by ``ops/__init__.py``,
after the forward ops it attaches to are registered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp
from ..core import registry
from ..kernels import conv3x3
from ..core.executor import raw_data, with_lod_of
from ..core.ir import grad_var_name
from ..core.registry import register_op
from ..core.types import is_floating
from .common import bcast_y_to_x, flatten_to_2d
from .math_ops import acc_matmul, swap_last
from .nn_ops import _bn_grad_maker, _conv_taps, _in_layout, \
    _native_operands, bn_axes, conv3x3_config, conv_uses_taps, pool2d_apply

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
    ctx.set_output("X@GRAD", with_lod_of(
        out, raw_data(ctx.input("Out@GRAD")) * (raw_data(out) > 0)))


_attach("relu", "relu_grad", need_outputs=("Out",))


# the activations whose grad reads Out (``paddle_tpu/ops/explicit_grads.py:
# 90-110``); the rest take the generic grad, as in the JAX package
_ACT_GRADS = {
    "tanh": lambda dy, out: dy * (1.0 - out * out),
    "sigmoid": lambda dy, out: dy * out * (1.0 - out),
    "exp": lambda dy, out: dy * out,
    "sqrt": lambda dy, out: dy * 0.5 / out,
    "reciprocal": lambda dy, out: -dy * out * out,
}


def _act_grad(ctx, fn):
    out = ctx.input("Out")
    ctx.set_output("X@GRAD", with_lod_of(
        out, fn(raw_data(ctx.input("Out@GRAD")), raw_data(out))))


for _name, _fn in _ACT_GRADS.items():
    register_op(_name + "_grad", no_gradient=True)(
        lambda ctx, f=_fn: _act_grad(ctx, f))
    _attach(_name, _name + "_grad", need_outputs=("Out",))


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
    dX keeps X's LoD. Under AMP X, Y and dOut are cast to bfloat16, the
    gemms sum in float32, and dX / dY are written in X's / Y's dtype."""
    x_v = ctx.input("X")
    x = raw_data(x_v)
    y = raw_data(ctx.input("Y"))
    dy = raw_data(ctx.input("Out@GRAD"))
    xdt, ydt = x.dtype, y.dtype
    x, y, dy = amp.cast_inputs(ctx, x, y, dy)
    x2 = flatten_to_2d(x, ctx.attr("x_num_col_dims", 1))
    y2 = flatten_to_2d(y, ctx.attr("y_num_col_dims", 1))
    dy2 = dy.reshape(x2.shape[0], y2.shape[1])
    if ctx.op.output("X@GRAD"):
        ctx.set_output("X@GRAD", with_lod_of(
            x_v, acc_matmul(dy2, y2.t()).to(xdt).reshape(x.shape)))
    if ctx.op.output("Y@GRAD"):
        ctx.set_output("Y@GRAD",
                       acc_matmul(x2.t(), dy2).to(ydt).reshape(y.shape))


_attach("mul", "mul_grad", need_inputs=("X", "Y"), diff_slots=("X", "Y"))


def _unbcast(g, shape):
    """``g`` summed over the leading dims it has beyond ``shape`` and
    over each dim that ``shape`` broadcast from 1."""
    extra = g.ndim - len(shape)
    if extra > 0:
        g = torch.sum(g, dim=tuple(range(extra)))
    for i, (gs, s) in enumerate(zip(g.shape, shape)):
        if s == 1 and gs != 1:
            g = torch.sum(g, dim=i, keepdim=True)
    return g.reshape(shape)


@register_op("matmul_grad", no_gradient=True)
def matmul_grad(ctx):
    """dX and dY of ``matmul`` with its ``transpose_X`` / ``transpose_Y``
    and ``alpha`` (dOut scaled by ``alpha`` first); the gradient of an
    operand whose batch dims were broadcast is summed over them. Under
    AMP X, Y and dOut are cast to bfloat16 and the products summed in
    float32; dX / dY are written in X's / Y's dtype."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y"))
    dy = raw_data(ctx.input("Out@GRAD"))
    xdt, ydt = x.dtype, y.dtype
    x, y, dy = amp.cast_inputs(ctx, x, y, dy)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        dy = dy * alpha
    tx = ctx.attr("transpose_X", False)
    ty = ctx.attr("transpose_Y", False)
    xo = swap_last(x) if tx else x
    yo = swap_last(y) if ty else y
    if ctx.op.output("X@GRAD"):
        dxo = acc_matmul(dy, swap_last(yo))
        dx = swap_last(dxo) if tx else dxo
        ctx.set_output("X@GRAD", _unbcast(dx, x.shape).to(xdt))
    if ctx.op.output("Y@GRAD"):
        dyo = acc_matmul(swap_last(xo), dy)
        dw = swap_last(dyo) if ty else dyo
        ctx.set_output("Y@GRAD", _unbcast(dw, y.shape).to(ydt))


def _matmul_grad_maker(op, block, grad_of, no_grad):
    """``matmul_grad`` for operands of 2 dims or more; a 1-D operand
    (``jnp.matmul``'s vector rules) takes the generic grad."""
    xv = block._find_var_recursive(op.input("X")[0])
    yv = block._find_var_recursive(op.input("Y")[0])
    if (xv is None or yv is None or xv.shape is None or yv.shape is None
            or len(xv.shape) < 2 or len(yv.shape) < 2):
        from ..core.backward import default_grad_maker
        return default_grad_maker(op, block, grad_of, no_grad)
    return simple_grad_maker("matmul_grad", need_inputs=("X", "Y"),
                             diff_slots=("X", "Y"))(op, block, grad_of,
                                                    no_grad)


registry.lookup_checked("matmul").grad_maker = _matmul_grad_maker


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


@register_op("elementwise_sub_grad", no_gradient=True)
def elementwise_sub_grad(ctx):
    """dX is dOut; dY is -dOut summed over the broadcast dims."""
    x_v = ctx.input("X")
    y = raw_data(ctx.input("Y"))
    dy = raw_data(ctx.input("Out@GRAD"))
    if ctx.op.output("X@GRAD"):
        ctx.set_output("X@GRAD", with_lod_of(x_v, dy))
    if ctx.op.output("Y@GRAD"):
        ctx.set_output("Y@GRAD", -_unbcast_to(dy, y.shape,
                                              ctx.attr("axis", -1)))


@register_op("elementwise_mul_grad", no_gradient=True)
def elementwise_mul_grad(ctx):
    """dX = dOut * Y (broadcast); dY = dOut * X summed over the broadcast
    dims."""
    x_v = ctx.input("X")
    x = raw_data(x_v)
    y = raw_data(ctx.input("Y"))
    dy = raw_data(ctx.input("Out@GRAD"))
    axis = ctx.attr("axis", -1)
    if ctx.op.output("X@GRAD"):
        ctx.set_output("X@GRAD",
                       with_lod_of(x_v, dy * bcast_y_to_x(x, y, axis)))
    if ctx.op.output("Y@GRAD"):
        ctx.set_output("Y@GRAD", _unbcast_to(dy * x, y.shape, axis))


for _n in ("elementwise_add", "elementwise_sub", "elementwise_mul"):
    _attach(_n, _n + "_grad", need_inputs=("X", "Y"),
            diff_slots=("X", "Y"))


@register_op("conv2d_grad", no_gradient=True)
def conv2d_grad(ctx):
    """dInput and dFilter without replaying the forward (the JAX grad
    replays it under ``jax.vjp``, where XLA drops the dead primal; here
    it would be a real launch), on the forward dispatch's path:
    - under ``conv_impl=matmul``, groups 1 without dilation and off the
      s2d stem (``nn_ops.conv_uses_taps``), the per-tap products of the
      JAX grad's ``use_taps`` path, summed in float32;
    - a conv whose tune dispatch decision (``nn_ops.conv3x3_config``,
      asked again as the JAX grad's replay asks it) runs the conv3x3
      kernel: that wrapper's backward through the NHWC/HWIO transposes,
      dx by the kernel, dw by the 9 tap contractions;
    - every other conv: ``convolution_backward``, the backward of
      torch's conv2d, on the operands the forward conv ran on (the s2d
      stem's rewrite, the layout's memory format), and the cheap
      reshapes between those and Input / Filter taken back by autograd.
    ``groups`` is the attr, else Input's channels over Filter's (a
    ``depthwise_conv2d`` without the attr is one group a channel).
    Under AMP Input, Filter and the output gradient are cast to bfloat16
    (the kernel's bfloat16 face writes dx in bfloat16, the dw taps are
    rounded to bfloat16), and dInput / dFilter are written in their
    declared dtypes."""
    x = ctx.input("Input")
    w = ctx.input("Filter")
    dy = ctx.input("Output@GRAD")
    xdt, wdt = x.dtype, w.dtype
    x, w, dy = amp.cast_inputs(ctx, x, w, dy)
    s = ctx.attr("strides", [1, 1])
    p = ctx.attr("paddings", [0, 0])
    d = ctx.attr("dilations", [1, 1])
    groups = ctx.attr("groups") or x.shape[1] // w.shape[1]
    choice = ctx.attr("conv_impl")
    want_dx = bool(ctx.op.output("Input@GRAD"))
    want_dw = bool(ctx.op.output("Filter@GRAD"))
    if conv_uses_taps(x, w, s, p, d, groups, choice):
        dx, dw = _conv_taps_grad(x, w, dy, s, p, want_dx, want_dw)
    elif conv3x3_config(x.shape, w.shape, s, p, d, groups, x.dtype,
                        choice) is not None:
        dx, dw = conv3x3.conv3x3_bwd(
            x.permute(0, 2, 3, 1).contiguous(),
            w.permute(2, 3, 1, 0).contiguous(),
            dy.permute(0, 2, 3, 1).contiguous(), want_dx, want_dw)
        dx = dx.permute(0, 3, 1, 2).contiguous() if want_dx else None
        dw = dw.permute(3, 2, 0, 1).contiguous() if want_dw else None
    else:
        dx, dw = _conv_native_grad(x, w, dy, s, p, d, groups, want_dx,
                                   want_dw)
    # each a no-op when not wired
    ctx.set_output("Input@GRAD", dx.to(xdt) if want_dx else None)
    ctx.set_output("Filter@GRAD", dw.to(wdt) if want_dw else None)


def _conv_taps_grad(x, w, dy, s, p, want_dx, want_dw):
    """The JAX grad's per-tap path (``paddle_tpu/ops/explicit_grads.py:
    329-357``): dW one [O, C] product a tap, dX one product a tap added
    into the strided window of the padded input's gradient; float32
    sums (float64 for float64)."""
    _, C, H, W = x.shape
    O, _, KH, KW = w.shape
    xp, wins = _conv_taps(x, w, s, p, dy.shape[2], dy.shape[3])
    wa, g = w.to(xp.dtype), dy.to(xp.dtype)
    dxp = torch.zeros_like(xp) if want_dx else None
    dw_taps = []
    for ky, kx, win in wins:
        if want_dw:
            dw_taps.append(torch.einsum("bohw,bchw->oc", g, xp[win]))
        if want_dx:
            dxp[win] += torch.einsum("bohw,oc->bchw", g, wa[:, :, ky, kx])
    dw = torch.stack(dw_taps, dim=-1).reshape(O, C, KH, KW) \
        if want_dw else None
    dx = dxp[:, :, p[0]:p[0] + H, p[1]:p[1] + W] if want_dx else None
    return dx, dw


def _conv_native_grad(x, w, dy, s, p, d, groups, want_dx, want_dw):
    """dx and dw of ``nn_ops._conv_native`` by ``convolution_backward``
    on the operands it convolves; where those are not Input and Filter
    themselves (the s2d stem, the nhwc layout), autograd carries the
    gradients back through the reshapes, pads and copies."""
    with torch.enable_grad():
        xl = x.detach().requires_grad_(want_dx)
        wl = w.detach().requires_grad_(want_dw)
        xo, wo, so, po, do, go = _native_operands(xl, wl, s, p, d, groups)
        dxo, dwo, _ = torch.ops.aten.convolution_backward(
            _in_layout(dy.to(x.dtype)), xo.detach(), wo.detach(), None,
            list(so), list(po), list(do), False, [0, 0], go,
            [want_dx, want_dw, False])
        if xo is xl and wo is wl:
            return (dxo.contiguous() if want_dx else None,
                    dwo.contiguous() if want_dw else None)
        outs = [(t, gt) for t, gt, want in ((xo, dxo, want_dx),
                                           (wo, dwo, want_dw)) if want]
        leaves = [t for t, want in ((xl, want_dx), (wl, want_dw)) if want]
        got = list(torch.autograd.grad([o for o, _ in outs], leaves,
                                       [gt for _, gt in outs]))
    return (got.pop(0).contiguous() if want_dx else None,
            got.pop(0).contiguous() if want_dw else None)


for _conv in ("conv2d", "depthwise_conv2d"):
    _attach(_conv, "conv2d_grad", need_inputs=("Input", "Filter"),
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
    x_v = ctx.input("X")
    x, label = raw_data(x_v), raw_data(ctx.input("Label"))
    dy = raw_data(ctx.input("Y@GRAD"))
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
    ctx.set_output("X@GRAD", with_lod_of(x_v, dx))


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
    g = ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD", with_lod_of(g, raw_data(g)
                                         * ctx.attr("scale", 1.0)))


_attach("scale", "scale_grad", need_inputs=())
