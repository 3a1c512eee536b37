"""NN ops (counterparts in ``paddle_tpu/ops/nn_ops.py``: the
activation table :44-134, ``softmax`` :147, ``conv2d`` :387 with ``conv2d_apply`` :345,
``pool2d`` :614 with ``pool2d_apply`` :584, ``batch_norm`` :697 with
``_bn_grad_maker`` :744, ``layer_norm`` :774).

Convolutions are NCHW with OIHW filters. The 3x3 / s1 / p1 population
is routed through ``paddle_tpu_torch.tune`` as in the JAX op
(``conv2d_apply`` :363-381): a cached per-(device, shape) winner runs
the hand-written kernel (``kernels/conv3x3.py``, through NHWC/HWIO
transposes) when it is ``{}`` and ``F.conv2d`` when it is ``use: xla``;
with no winner, ``conv_impl=pallas3x3`` runs the kernel (a tune miss)
and ``conv`` runs ``F.conv2d`` (a fallback). Every other conv is
``torch.nn.functional.conv2d`` with a recorded fallback, as the JAX
package computes it with ``lax.conv`` outside any Pallas kernel.

Under AMP (``paddle_tpu_torch.amp``) ``conv2d`` casts its operands to
bfloat16 and the conv is bfloat16 throughout: the kernel's bfloat16 face
writes bfloat16, as ``F.conv2d`` does for the other convs; plain AMP
casts the output back to the declared dtype, pure AMP keeps it.
``batch_norm`` takes its statistics and normalises in float32 for a
bfloat16 input and writes Y in the input's dtype.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .. import amp, tune
from ..core.executor import raw_data, with_lod_of
from ..core.registry import register_op
from ..flags import FLAGS
from ..kernels import conv3x3
from .common import jax_abs, jax_clip

__all__ = ["conv2d_apply", "conv3x3_config", "conv_impl", "pool2d_apply"]

_NOT_PORTED = ("is not ported to paddle_tpu_torch (ROADMAP.md, Queue 1: "
               "the rest of the training path)")


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


@register_op("tanh", infer_shape=_infer_same)
def tanh(ctx):
    ctx.set_output("Out", torch.tanh(ctx.input("X")))


# -- the activation table (``paddle_tpu/ops/nn_ops.py:44-134``) --------------
# each formula as the JAX lowering writes it; Out keeps X's LoD

def _act(ctx, fn):
    x = ctx.input("X")
    ctx.set_output("Out", with_lod_of(x, fn(raw_data(x))))


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "relu6": lambda x: jax_clip(x, 0.0, 6.0),
    "exp": torch.exp,
    "abs": jax_abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "round": torch.round,  # half to even, as jnp.round
    "log": torch.log,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "reciprocal": lambda x: 1.0 / x,
    "softplus": _softplus,
    "softsign": lambda x: x / (1.0 + torch.abs(x)),
    "sin": torch.sin,
    "cos": torch.cos,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    # the JAX lowering's fixed threshold 0.5 (it reads no attr)
    "softshrink": lambda x: torch.sign(x) * jax_clip(
        jax_abs(x) - 0.5, 0.0),
    "sign": torch.sign,
}
for _name, _fn in _ACTIVATIONS.items():
    register_op(_name, infer_shape=_infer_same)(
        lambda ctx, f=_fn: _act(ctx, f))


@register_op("hard_shrink", infer_shape=_infer_same)
def hard_shrink(ctx):
    """X outside [-threshold, threshold], 0 inside."""
    t = ctx.attr("threshold", 0.5)
    _act(ctx, lambda x: torch.where((x > t) | (x < -t), x,
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device)))


@register_op("leaky_relu", infer_shape=_infer_same)
def leaky_relu(ctx):
    a = ctx.attr("alpha", 0.02)
    _act(ctx, lambda x: torch.where(x > 0, x, a * x))


@register_op("elu", infer_shape=_infer_same)
def elu(ctx):
    a = ctx.attr("alpha", 1.0)
    _act(ctx, lambda x: torch.where(x > 0, x, a * (torch.exp(x) - 1.0)))


@register_op("brelu", infer_shape=_infer_same)
def brelu(ctx):
    lo, hi = ctx.attr("t_min", 0.0), ctx.attr("t_max", 24.0)
    _act(ctx, lambda x: jax_clip(x, lo, hi))


@register_op("soft_relu", infer_shape=_infer_same)
def soft_relu(ctx):
    t = ctx.attr("threshold", 40.0)
    _act(ctx, lambda x: torch.log1p(torch.exp(jax_clip(x, -t, t))))


@register_op("hard_sigmoid", infer_shape=_infer_same)
def hard_sigmoid(ctx):
    s = ctx.attr("slope", 0.2)
    o = ctx.attr("offset", 0.5)
    _act(ctx, lambda x: jax_clip(s * x + o, 0.0, 1.0))


@register_op("swish", infer_shape=_infer_same)
def swish(ctx):
    b = ctx.attr("beta", 1.0)
    _act(ctx, lambda x: x * torch.sigmoid(b * x))


@register_op("thresholded_relu", infer_shape=_infer_same)
def thresholded_relu(ctx):
    t = ctx.attr("threshold", 1.0)
    _act(ctx, lambda x: torch.where(x > t, x, torch.zeros(
        (), dtype=x.dtype, device=x.device)))


@register_op("stanh", infer_shape=_infer_same)
def stanh(ctx):
    a = ctx.attr("scale_a", 0.67)
    b = ctx.attr("scale_b", 1.7159)
    _act(ctx, lambda x: b * torch.tanh(a * x))


@register_op("pow", infer_shape=_infer_same)
def pow_op(ctx):
    f = ctx.attr("factor", 1.0)
    _act(ctx, lambda x: torch.pow(x, f))


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


@register_op("softmax", infer_shape=_infer_same)
def softmax(ctx):
    ctx.set_output("Out", torch.softmax(ctx.input("X"), dim=-1))


# -- conv / pool --------------------------------------------------------------

def _conv_out_dim(i, k, p, s, d=1):
    ke = (k - 1) * d + 1
    return (i + 2 * p - ke) // s + 1


def _infer_conv2d(op, block):
    xv = block._find_var_recursive(op.input("Input")[0])
    fv = block._find_var_recursive(op.input("Filter")[0])
    ov = block._find_var_recursive(op.output("Output")[0])
    if None in (xv, fv, ov) or xv.shape is None or fv.shape is None:
        return
    s = op.attr("strides", [1, 1])
    p = op.attr("paddings", [0, 0])
    d = op.attr("dilations", [1, 1])
    n, _, h, w = xv.shape
    oc, _, kh, kw = fv.shape
    ov.shape = (n, oc, _conv_out_dim(h, kh, p[0], s[0], d[0]),
                _conv_out_dim(w, kw, p[1], s[1], d[1]))
    ov.dtype = xv.dtype


def conv_impl(program_choice=None):
    """The dense-conv lowering, 'conv' (default) or 'pallas3x3':
    ``PADDLE_TPU_CONV_IMPL``, else the op's ``conv_impl`` attr (set by a
    config that opts its program in), else ``FLAGS.conv_impl``."""
    impl = (os.environ.get("PADDLE_TPU_CONV_IMPL") or program_choice
            or FLAGS.conv_impl)
    if impl == "matmul":
        raise NotImplementedError("conv_impl='matmul' " + _NOT_PORTED)
    return impl


def _refuse_unported_knobs():
    """Raise for the JAX package's other conv knobs
    (``PADDLE_TPU_CONV_LAYOUT=nhwc``, ``PADDLE_TPU_CONV_S2D``), which the
    port does not have."""
    layout = os.environ.get("PADDLE_TPU_CONV_LAYOUT", "nchw")
    if layout != "nchw":
        raise NotImplementedError("conv_layout=%r %s" % (layout, _NOT_PORTED))
    if os.environ.get("PADDLE_TPU_CONV_S2D", "0") not in ("0", "false",
                                                          "False", ""):
        raise NotImplementedError("conv_first_s2d " + _NOT_PORTED)


def conv3x3_config(x_shape, w_shape, s, p, d, groups, dtype,
                   program_choice=None):
    """The tune dispatch decision of one conv (``x`` NCHW, ``w`` OIHW): a
    config dict (``{}``, the kernel's one tiling) to run the conv3x3
    kernel, or None for ``F.conv2d``. Inside the population the cache
    decides, enabled by ``pallas3x3``; outside it a fallback is
    recorded. Raises for the conv knobs the port does not have. The grad
    op asks again, as the JAX grad replays the forward's dispatch."""
    _refuse_unported_knobs()
    if not conv3x3.supports_conv3x3(w_shape, s, p, d, groups):
        tune.record_fallback("conv3x3")
        return None
    N, C, H, W = (int(v) for v in x_shape)
    return tune.lookup(
        "conv3x3", {"n": N, "h": H, "w": W, "c": C, "o": int(w_shape[0]),
                    "dtype": str(dtype).replace("torch.", "")},
        enabled=conv_impl(program_choice) == "pallas3x3")


def conv2d_apply(x, w, s, p, d, groups, program_choice=None, pe=None):
    """conv2d forward, ``x`` NCHW and ``w`` OIHW: the conv3x3 kernel when
    :func:`conv3x3_config` gives a config, else torch's conv2d. ``pe``
    (float32 or None) is the JAX lowering's ``preferred_element_type``:
    float32 sums bfloat16 operands into a float32 output; None writes
    the operands' dtype."""
    if conv3x3_config(x.shape, w.shape, s, p, d, groups, x.dtype,
                      program_choice) is not None:
        out = conv3x3.conv3x3_s1_nhwc(x.permute(0, 2, 3, 1).contiguous(),
                                      w.permute(2, 3, 1, 0).contiguous(),
                                      pe)
        return out.permute(0, 3, 1, 2).contiguous()
    if pe is not None and x.dtype != pe:
        x, w = x.to(pe), w.to(pe)
    return F.conv2d(x, w, None, tuple(s), tuple(p), tuple(d), groups)


@register_op("conv2d", infer_shape=_infer_conv2d)
def conv2d(ctx):
    """NCHW input, OIHW filter. Under AMP the operands are cast to
    bfloat16 and the conv stays bfloat16 (the kernel or ``F.conv2d``
    writes bfloat16); outside AMP, bfloat16 operands get float32 sums
    and output. Output is written back in Input's dtype, or kept
    bfloat16 under pure AMP."""
    x = ctx.input("Input")
    w = ctx.input("Filter")
    out_dtype = x.dtype
    amp_on = getattr(ctx.block.program, "_amp", False)
    x, w = amp.cast_inputs(ctx, x, w)
    pe = torch.float32 if (not amp_on and x.dtype == torch.bfloat16) \
        else None
    out = conv2d_apply(
        x, w, ctx.attr("strides", [1, 1]), ctx.attr("paddings", [0, 0]),
        ctx.attr("dilations", [1, 1]), ctx.attr("groups", 1) or 1,
        ctx.attr("conv_impl"), pe)
    ctx.set_output("Output", out.to(
        torch.bfloat16 if amp.keep_bf16(ctx, out_dtype) else out_dtype))


def _infer_pool2d(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    if op.attr("global_pooling", False):
        ov.shape = (xv.shape[0], xv.shape[1], 1, 1)
        ov.dtype = xv.dtype
        return
    k = op.attr("ksize")
    s = op.attr("strides", [1, 1])
    p = op.attr("paddings", [0, 0])
    ceil = op.attr("ceil_mode", False)

    def od(i, kk, pp, ss):
        num = i + 2 * pp - kk
        return (num + ss - 1) // ss + 1 if ceil else num // ss + 1

    n, c, h, w = xv.shape
    ov.shape = (n, c, od(h, k[0], p[0], s[0]), od(w, k[1], p[1], s[1]))
    ov.dtype = xv.dtype


def pool2d_apply(x, ptype, k, s, p, ceil, exclusive):
    """pool2d forward over NCHW ``x``, shared by the lowering and the
    replay of ``pool2d_grad``. The input is padded explicitly (with -inf
    for max, zeros for avg; ``ceil_mode`` adds the right/bottom padding
    that covers the partial trailing window), then pooled without
    padding: the JAX package's ``reduce_window`` semantics. An exclusive
    average divides by the count of real pixels in each window."""
    extra = [0, 0]
    if ceil:
        for a, i in ((0, x.shape[2]), (1, x.shape[3])):
            num = i + 2 * p[a] - k[a]
            out_d = (num + s[a] - 1) // s[a] + 1
            extra[a] = max((out_d - 1) * s[a] + k[a] - (i + 2 * p[a]), 0)
    pads = (p[1], p[1] + extra[1], p[0], p[0] + extra[0])
    if ptype == "max":
        xp = F.pad(x, pads, value=float("-inf")) if any(pads) else x
        return F.max_pool2d(xp, tuple(k), tuple(s))
    xp = F.pad(x, pads) if any(pads) else x
    summed = F.avg_pool2d(xp, tuple(k), tuple(s), divisor_override=1)
    if exclusive and any(pads):
        ones = F.pad(torch.ones_like(x[:1, :1]), pads)
        return summed / F.avg_pool2d(ones, tuple(k), tuple(s),
                                     divisor_override=1)
    return summed / float(k[0] * k[1])


@register_op("pool2d", infer_shape=_infer_pool2d)
def pool2d(ctx):
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    if ctx.attr("global_pooling", False):
        red = torch.amax if ptype == "max" else torch.mean
        ctx.set_output("Out", red(x, dim=(2, 3), keepdim=True))
        return
    ctx.set_output("Out", pool2d_apply(
        x, ptype, ctx.attr("ksize"), ctx.attr("strides", [1, 1]),
        ctx.attr("paddings", [0, 0]), bool(ctx.attr("ceil_mode", False)),
        ctx.attr("exclusive", True)))


# -- normalization ------------------------------------------------------------

def bn_axes(x, layout):
    """(reduction axes, channel-broadcast shape) of batch norm over ``x``."""
    nchw = x.ndim == 4 and layout == "NCHW"
    axes = (0, 2, 3) if nchw else (0, 1, 2) if x.ndim == 4 else (0,)
    cshape = [1] * x.ndim
    caxis = 1 if nchw else x.ndim - 1
    cshape[caxis] = x.shape[caxis]
    return axes, cshape


@register_op("batch_norm", infer_shape=_infer_same)
def batch_norm(ctx):
    """Batch norm with the running statistics updated in the program:
    ``MeanOut``/``VarianceOut`` are the persistable ``Mean``/``Variance``
    vars, so the Executor's write-back carries them across steps. Paddle's
    convention: ``new = momentum * old + (1 - momentum) * batch``, with the
    biased batch variance; ``SavedVariance`` holds the inverse std.
    (``F.batch_norm`` updates running stats with the unbiased variance and
    the opposite momentum, so it is not used.) A bfloat16 input (pure
    AMP) is widened to float32 for the statistics and the normalisation,
    and Y written back in bfloat16."""
    x_in = ctx.input("X")
    x = x_in.float() if x_in.dtype in (torch.bfloat16, torch.float16) \
        else x_in
    scale = ctx.input("Scale")
    bias = ctx.input("Bias")
    mean = ctx.input("Mean")
    var = ctx.input("Variance")
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    axes, cshape = bn_axes(x, ctx.attr("data_layout", "NCHW"))
    if ctx.attr("is_test", False):
        use_mean, use_var = mean, var
        saved_mean, saved_var = mean, var
        new_mean, new_var = mean, var
    else:
        bm = torch.mean(x, dim=axes)
        bv = torch.var(x, dim=axes, unbiased=False)
        use_mean, use_var = bm, bv
        saved_mean = bm
        saved_var = 1.0 / torch.sqrt(bv + eps)
        new_mean = momentum * mean + (1.0 - momentum) * bm
        new_var = momentum * var + (1.0 - momentum) * bv
    inv = 1.0 / torch.sqrt(use_var + eps)
    y = (x - use_mean.reshape(cshape)) * (inv * scale).reshape(cshape) \
        + bias.reshape(cshape)
    ctx.set_output("Y", y.to(x_in.dtype))
    ctx.set_output("MeanOut", new_mean)
    ctx.set_output("VarianceOut", new_var)
    ctx.set_output("SavedMean", saved_mean)
    ctx.set_output("SavedVariance", saved_var)


def _bn_grad_maker(op, block, grad_of, no_grad):
    """The generic replay restricted to (X, Scale, Bias) -> Y, so the
    running-stat update is never differentiated: what batch_norm's grad
    maker (``explicit_grads._bn_explicit_grad_maker``) falls back to
    when the op's saved statistics are not wired."""
    g = grad_of.get(op.output("Y")[0])
    if g is None:
        return None
    inputs = {"X": list(op.input("X")), "Scale": list(op.input("Scale")),
              "Bias": list(op.input("Bias")), "Mean": list(op.input("Mean")),
              "Variance": list(op.input("Variance")),
              "Y": list(op.output("Y")), "Y@GRAD": [g]}
    outputs, diff = {}, {}
    for slot in ("X", "Scale", "Bias"):
        n = op.input(slot)[0]
        if n not in no_grad:
            outputs[slot + "@GRAD"] = [n + "@GRAD"]
            diff[slot] = [True]
    if not outputs:
        return None
    attrs = dict(op.attrs)
    attrs["__fwd_type__"] = "batch_norm"
    attrs["__fwd_input_slots__"] = ["X", "Scale", "Bias", "Mean", "Variance"]
    attrs["__fwd_output_slots__"] = ["Y"]
    attrs["__diff_slots__"] = diff
    return [("generic_grad", inputs, outputs, attrs)]
