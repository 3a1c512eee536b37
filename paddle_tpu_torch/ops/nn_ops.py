"""NN ops (counterparts in ``paddle_tpu/ops/nn_ops.py``: the
activation table :44-134, ``prelu`` :137, ``softmax`` :147,
``log_softmax`` :153, ``maxout`` :159, ``dropout`` :182 with
``dropout_grad`` :198, the conv knobs ``conv_impl`` :228,
``conv_layout`` :242 and ``conv_first_s2d`` :257 with ``_conv_native``
:266, ``_conv_stem_s2d`` :283, ``_conv_shifted_matmul`` :316 and
``conv2d_apply`` :345, ``conv2d`` :387, ``depthwise_conv2d`` :413,
``conv2d_transpose`` :444, ``conv3d_transpose`` :506, ``conv3d`` :546,
``pool2d`` :614 with ``pool2d_apply`` :584, ``pool3d`` :657,
``batch_norm`` :697 with ``_bn_grad_maker`` :744, ``layer_norm`` :774,
``lrn`` :792, ``l2_normalize`` :809, ``im2sequence`` :818,
``scale_sub_region`` :836).

Convolutions are NCHW with OIHW filters. ``conv2d_apply`` keeps the
JAX dispatch's order: the ImageNet stem's space-to-depth rewrite when
``conv_first_s2d`` is on and its gate holds; then the 3x3 / s1 / p1
population, routed through ``paddle_tpu_torch.tune`` as in the JAX op
(``conv2d_apply`` :363-381): a cached per-(device, shape) winner runs
the hand-written kernel (``kernels/conv3x3.py``, through NHWC/HWIO
transposes) when it is ``{}`` and another lowering when it is ``use:
xla``; with no winner, ``conv_impl=pallas3x3`` runs the kernel (a tune
miss); then, under ``conv_impl=matmul``, the KH*KW shifted matmuls for
groups 1 without dilation; else ``torch.nn.functional.conv2d``, on
``channels_last`` tensors under ``conv_layout=nhwc``, as the JAX package
computes it with ``lax.conv`` outside any Pallas kernel. The transposed,
3-D and depthwise convs are torch's convolutions, the counterparts of
``lax.conv_general_dilated``.

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

__all__ = ["conv2d_apply", "conv3x3_config", "conv_first_s2d", "conv_impl",
           "conv_layout", "conv_uses_taps", "pool2d_apply"]

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
    x = ctx.input("X")
    ctx.set_output("Out", with_lod_of(x, torch.relu(raw_data(x))))


@register_op("tanh", infer_shape=_infer_same)
def tanh(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", with_lod_of(x, torch.tanh(raw_data(x))))


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
    x = ctx.input("X")
    ctx.set_output("Out", with_lod_of(x, torch.softmax(raw_data(x), dim=-1)))


@register_op("log_softmax", infer_shape=_infer_same)
def log_softmax(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", with_lod_of(x, torch.log_softmax(raw_data(x),
                                                           dim=-1)))


@register_op("prelu", infer_shape=_infer_same)
def prelu(ctx):
    """X where positive, Alpha * X elsewhere; under ``mode="channel"`` a
    1-D Alpha is one slope a channel (dim 1), and ``element``'s Alpha
    has X's shape past the batch dim (the layer makes it so)."""
    x = raw_data(ctx.input("X"))
    alpha = raw_data(ctx.input("Alpha"))
    if ctx.attr("mode", "all") == "channel" and alpha.ndim == 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    ctx.set_output("Out", torch.where(x > 0, x, alpha * x))


@register_op("maxout")
def maxout(ctx):
    """The max over each run of ``groups`` channels: [N, C, H, W] ->
    [N, C / groups, H, W]. Tied maxima share the gradient evenly, as
    ``jnp.max``'s do (``torch.amax``)."""
    x = raw_data(ctx.input("X"))
    g = ctx.attr("groups")
    n, c, h, w = x.shape
    ctx.set_output("Out", torch.amax(x.reshape(n, c // g, g, h, w), dim=2))


def _dropout_grad_maker(op, block, grad_of, no_grad):
    """``dropout_grad`` on the saved Mask (the JAX maker :169)."""
    gout = grad_of.get(op.output("Out")[0])
    if gout is None:
        return None
    xname = op.input("X")[0]
    if xname in no_grad:
        return None
    return [("dropout_grad",
             {"Mask": op.output("Mask"), "Out@GRAD": [gout]},
             {"X@GRAD": [xname + "@GRAD"]},
             dict(op.attrs))]


@register_op("dropout", grad_maker=_dropout_grad_maker,
             infer_shape=_infer_same)
def dropout(ctx):
    """Training: Out = X * Mask, Mask = (uniform [0, 1) >= p) in X's
    dtype, drawn from the scope's generator (the JAX lowering draws from
    its own key, so the two packages' masks agree in distribution only:
    ROADMAP.md Queue 3 #28). A captured step draws a new mask at each
    replay. ``is_test``: Out = X * (1 - p), Mask all ones. The ``seed``
    attr is not read, as in the JAX lowering."""
    x = ctx.input("X")
    xd = raw_data(x)
    p = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False):
        ctx.set_output("Out", with_lod_of(x, xd * (1.0 - p)))
        ctx.set_output("Mask", torch.ones_like(xd))
        return
    u = torch.empty(xd.shape, dtype=torch.float32, device=xd.device)
    u.uniform_(0.0, 1.0, generator=ctx.next_generator())
    mask = (u >= p).to(xd.dtype)
    ctx.set_output("Out", with_lod_of(x, xd * mask))
    ctx.set_output("Mask", mask)


@register_op("dropout_grad")
def dropout_grad(ctx):
    ctx.set_output("X@GRAD", raw_data(ctx.input("Out@GRAD"))
                   * raw_data(ctx.input("Mask")))


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
    """The dense-conv lowering, 'conv' (default), 'matmul' or
    'pallas3x3': ``PADDLE_TPU_CONV_IMPL``, else the op's ``conv_impl``
    attr (set by a config that opts its program in), else
    ``FLAGS.conv_impl``."""
    return (os.environ.get("PADDLE_TPU_CONV_IMPL") or program_choice
            or FLAGS.conv_impl)


def conv_layout():
    """The conv's internal layout, 'nchw' (passed through) or 'nhwc'
    (the conv runs on ``channels_last`` tensors; the op's inputs and
    outputs stay NCHW): ``PADDLE_TPU_CONV_LAYOUT``, else
    ``FLAGS.conv_layout``."""
    return os.environ.get("PADDLE_TPU_CONV_LAYOUT") or FLAGS.conv_layout


def conv_first_s2d():
    """Whether the ImageNet stem conv runs as its space-to-depth rewrite:
    ``PADDLE_TPU_CONV_S2D``, else ``FLAGS.conv_first_s2d``."""
    env = os.environ.get("PADDLE_TPU_CONV_S2D")
    if env is not None:
        return env not in ("0", "false", "False", "")
    return FLAGS.conv_first_s2d


def _in_layout(t):
    """``t`` (4-D) in the conv layout's memory format: the same NCHW
    tensor, ``channels_last`` under 'nhwc'."""
    if conv_layout() == "nhwc":
        return t.contiguous(memory_format=torch.channels_last)
    return t


def _conv_stem_s2d(x, w):
    """The ImageNet stem conv (7x7 / s2 / p3) rewritten as space-to-depth
    (2) and a 4x4 / s1 conv, numerically exact, 4x the input channels:
    (the s2d input padded (2, 1) on each side, the 4x4 filter).

    out[h'] = sum_ky k[ky] x[2h' + ky - 3]: with the filter padded to 8
    taps in front (m = ky + 1 = 2a + dy) that is the s2d plane dy sampled
    at h' - 2 + a, a 4-tap stride-1 conv padded (2, 1)."""
    B, C, H, W = x.shape
    O = w.shape[0]
    xs = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(
        0, 1, 3, 5, 2, 4).reshape(B, C * 4, H // 2, W // 2)
    k4 = F.pad(w, (1, 0, 1, 0)).reshape(O, C, 4, 2, 4, 2).permute(
        0, 1, 3, 5, 2, 4).reshape(O, C * 4, 4, 4)
    return F.pad(xs, (2, 1, 2, 1)), k4


def _native_operands(x, w, s, p, d, groups):
    """The operands and geometry of the torch conv that runs a conv off
    the kernel and the taps: the stem's rewrite (:func:`_conv_stem_s2d`)
    where its gate holds, else the conv itself, each operand in the
    layout's memory format."""
    if _conv2d_is_s2d_stem(x, w, s, p, d, groups):
        xs, k4 = _conv_stem_s2d(x, w)
        return (_in_layout(xs), _in_layout(k4), (1, 1), (0, 0), (1, 1), 1)
    return (_in_layout(x), _in_layout(w), tuple(s), tuple(p), tuple(d),
            groups)


def _conv_native(x, w, s, p, d, groups, pe=None):
    """torch's conv2d in the selected layout (x NCHW, w OIHW in, the
    output NCHW); ``pe`` float32 widens bfloat16 operands."""
    if pe is not None and x.dtype != pe:
        x, w = x.to(pe), w.to(pe)
    xo, wo, so, po, do, go = _native_operands(x, w, s, p, d, groups)
    return F.conv2d(xo, wo, None, so, po, do, go).contiguous()


def _acc_dtype(dtype):
    """The dtype a conv's taps sum in: float32, float64 for float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _conv_taps(x, w, s, p, OH, OW):
    """The per-tap operands of the shifted-matmul conv and its grad: the
    input padded, in its sum dtype (:func:`_acc_dtype`), and for each
    tap (ky, kx) of ``w`` the index of its strided [OH, OW] window in
    that padded input."""
    xp = F.pad(x, (p[1], p[1], p[0], p[0])).to(_acc_dtype(x.dtype))
    KH, KW = w.shape[2:]
    wins = [(ky, kx, (slice(None), slice(None),
                      slice(ky, ky + (OH - 1) * s[0] + 1, s[0]),
                      slice(kx, kx + (OW - 1) * s[1] + 1, s[1])))
            for ky in range(KH) for kx in range(KW)]
    return xp, wins


def _conv_shifted_matmul(x, w, s, p):
    """The conv as KH*KW shifted matmuls (the JAX lowering's einsums
    with float32 sums): each tap's strided window of the padded input
    times that tap's [O, C] filter slice, summed."""
    _, _, H, W = x.shape
    _, _, KH, KW = w.shape
    OH = (H + 2 * p[0] - KH) // s[0] + 1
    OW = (W + 2 * p[1] - KW) // s[1] + 1
    xp, wins = _conv_taps(x, w, s, p, OH, OW)
    wa = w.to(xp.dtype)
    out = None
    for ky, kx, win in wins:
        t = torch.einsum("bchw,oc->bohw", xp[win], wa[:, :, ky, kx])
        out = t if out is None else out + t
    return out


def _conv2d_is_s2d_stem(x, w, s, p, d, groups):
    return (conv_first_s2d() and groups == 1 and tuple(d) == (1, 1)
            and x.shape[1] <= 4 and tuple(w.shape[2:]) == (7, 7)
            and tuple(s) == (2, 2) and tuple(p) == (3, 3)
            and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)


def conv3x3_config(x_shape, w_shape, s, p, d, groups, dtype,
                   program_choice=None):
    """The tune dispatch decision of one conv (``x`` NCHW, ``w`` OIHW): a
    config dict (``{}``, the kernel's one tiling) to run the conv3x3
    kernel, or None for another lowering. Inside the population the
    cache decides, enabled by ``pallas3x3``; outside it a fallback is
    recorded."""
    if not conv3x3.supports_conv3x3(w_shape, s, p, d, groups):
        tune.record_fallback("conv3x3")
        return None
    N, C, H, W = (int(v) for v in x_shape)
    return tune.lookup(
        "conv3x3", {"n": N, "h": H, "w": W, "c": C, "o": int(w_shape[0]),
                    "dtype": str(dtype).replace("torch.", "")},
        enabled=conv_impl(program_choice) == "pallas3x3")


def conv_uses_taps(x, w, s, p, d, groups, program_choice=None):
    """Whether ``conv2d_grad`` takes the per-tap path: ``matmul``,
    groups 1, no dilation, not the s2d stem (``paddle_tpu/ops/
    explicit_grads.py:306``)."""
    return (groups == 1 and tuple(d) == (1, 1)
            and conv_impl(program_choice) == "matmul"
            and not _conv2d_is_s2d_stem(x, w, s, p, d, groups))


def conv2d_apply(x, w, s, p, d, groups, program_choice=None, pe=None):
    """conv2d forward, ``x`` NCHW and ``w`` OIHW, in the JAX dispatch's
    order: the s2d stem rewrite when its gate holds; then the conv3x3
    kernel when :func:`conv3x3_config` gives a config; then the shifted
    matmuls under ``matmul`` for groups 1 without dilation (their float32
    sums returned as they are, as the JAX einsums'); else torch's conv2d
    in the layout. ``pe`` (float32 or None) is the JAX lowering's
    ``preferred_element_type``: float32 sums bfloat16 operands into a
    float32 output; None writes the operands' dtype."""
    if _conv2d_is_s2d_stem(x, w, s, p, d, groups):
        return _conv_native(x, w, s, p, d, groups, pe)
    if conv3x3_config(x.shape, w.shape, s, p, d, groups, x.dtype,
                      program_choice) is not None:
        out = conv3x3.conv3x3_s1_nhwc(x.permute(0, 2, 3, 1).contiguous(),
                                      w.permute(2, 3, 1, 0).contiguous(),
                                      pe)
        return out.permute(0, 3, 1, 2).contiguous()
    if (groups == 1 and tuple(d) == (1, 1)
            and conv_impl(program_choice) == "matmul"):
        return _conv_shifted_matmul(x, w, s, p)
    return _conv_native(x, w, s, p, d, groups, pe)


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


@register_op("depthwise_conv2d", infer_shape=_infer_conv2d)
def depthwise_conv2d(ctx):
    """A grouped conv, one group a channel unless ``groups`` says
    otherwise, in the conv layout (no kernel, no taps: the JAX lowering's
    ``_conv_native``). Its grad is ``conv2d_grad``."""
    x = ctx.input("Input")
    w = ctx.input("Filter")
    groups = ctx.attr("groups") or x.shape[1]
    ctx.set_output("Output", _conv_native(
        x, w, ctx.attr("strides", [1, 1]), ctx.attr("paddings", [0, 0]),
        ctx.attr("dilations", [1, 1]), groups))


def _infer_conv2d_transpose(op, block):
    xv = block._find_var_recursive(op.input("Input")[0])
    fv = block._find_var_recursive(op.input("Filter")[0])
    ov = block._find_var_recursive(op.output("Output")[0])
    if None in (xv, fv, ov) or xv.shape is None or fv.shape is None:
        return
    s = op.attr("strides", [1, 1])
    p = op.attr("paddings", [0, 0])
    d = op.attr("dilations", [1, 1])
    n, _, h, w = xv.shape
    _, oc, kh, kw = fv.shape
    oc *= int(op.attr("groups", 1) or 1)
    ov.shape = (n, oc,
                (h - 1) * s[0] - 2 * p[0] + (kh - 1) * d[0] + 1,
                (w - 1) * s[1] - 2 * p[1] + (kw - 1) * d[1] + 1)
    ov.dtype = xv.dtype


def _conv_transpose(ctx, fn, nd):
    s = ctx.attr("strides", [1] * nd)
    p = ctx.attr("paddings", [0] * nd)
    d = ctx.attr("dilations", [1] * nd)
    g = int(ctx.attr("groups", 1) or 1)
    ctx.set_output("Output", fn(ctx.input("Input"), ctx.input("Filter"),
                                None, tuple(s), tuple(p), 0, g, tuple(d)))


@register_op("conv2d_transpose", infer_shape=_infer_conv2d_transpose)
def conv2d_transpose(ctx):
    """The deconv: output size (H - 1) s - 2p + d (k - 1) + 1. The filter
    is IOHW, [C_in, F / G, kh, kw], the layout ``conv_transpose2d``
    takes, grouped the same way (input channel group g makes output
    chunk g), so the JAX lowering's regroup of it for ``lax``
    (``_regroup_transpose_filter``) has no counterpart here."""
    _conv_transpose(ctx, F.conv_transpose2d, 2)


def _infer_conv3d_transpose(op, block):
    xv = block._find_var_recursive(op.input("Input")[0])
    fv = block._find_var_recursive(op.input("Filter")[0])
    ov = block._find_var_recursive(op.output("Output")[0])
    if None in (xv, fv, ov) or xv.shape is None or fv.shape is None:
        return
    s = op.attr("strides", [1, 1, 1])
    p = op.attr("paddings", [0, 0, 0])
    d = op.attr("dilations", [1, 1, 1])
    oc = fv.shape[1] * int(op.attr("groups", 1) or 1)
    ov.shape = (xv.shape[0], oc) + tuple(
        (xv.shape[2 + i] - 1) * s[i] - 2 * p[i]
        + (fv.shape[2 + i] - 1) * d[i] + 1 for i in range(3))
    ov.dtype = xv.dtype


@register_op("conv3d_transpose", infer_shape=_infer_conv3d_transpose)
def conv3d_transpose(ctx):
    """conv2d_transpose one spatial dim up: NCDHW, filter IODHW."""
    _conv_transpose(ctx, F.conv_transpose3d, 3)


def _infer_conv3d(op, block):
    xv = block._find_var_recursive(op.input("Input")[0])
    fv = block._find_var_recursive(op.input("Filter")[0])
    ov = block._find_var_recursive(op.output("Output")[0])
    if None in (xv, fv, ov) or xv.shape is None or fv.shape is None:
        return
    s = op.attr("strides", [1, 1, 1])
    p = op.attr("paddings", [0, 0, 0])
    d = op.attr("dilations", [1, 1, 1])
    ov.shape = (xv.shape[0], fv.shape[0]) + tuple(
        _conv_out_dim(xv.shape[2 + i], fv.shape[2 + i], p[i], s[i], d[i])
        for i in range(3))
    ov.dtype = xv.dtype


@register_op("conv3d", infer_shape=_infer_conv3d)
def conv3d(ctx):
    """NCDHW input, OIDHW filter."""
    ctx.set_output("Output", F.conv3d(
        ctx.input("Input"), ctx.input("Filter"), None,
        tuple(ctx.attr("strides", [1, 1, 1])),
        tuple(ctx.attr("paddings", [0, 0, 0])),
        tuple(ctx.attr("dilations", [1, 1, 1])),
        ctx.attr("groups", 1) or 1))


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


def _infer_pool3d(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    if op.attr("global_pooling", False):
        ov.shape = tuple(xv.shape[:2]) + (1, 1, 1)
        ov.dtype = xv.dtype
        return
    k = op.attr("ksize")
    s = op.attr("strides", [1, 1, 1])
    p = op.attr("paddings", [0, 0, 0])
    ceil = op.attr("ceil_mode", False)

    def od(i, kk, pp, ss):
        num = i + 2 * pp - kk
        return (num + ss - 1) // ss + 1 if ceil else num // ss + 1

    ov.shape = tuple(xv.shape[:2]) + tuple(
        od(xv.shape[2 + i], k[i], p[i], s[i]) for i in range(3))
    ov.dtype = xv.dtype


@register_op("pool3d", infer_shape=_infer_pool3d)
def pool3d(ctx):
    """pool2d's explicit-padding semantics one dim up, NCDHW: ``ceil_mode``
    pads the far side to cover the partial trailing window; an average
    divides by the count of real cells whenever there is padding (no
    ``exclusive`` attr), else by the window's size."""
    x = ctx.input("X")
    ptype = ctx.attr("pooling_type", "max")
    if ctx.attr("global_pooling", False):
        red = torch.amax if ptype == "max" else torch.mean
        ctx.set_output("Out", red(x, dim=(2, 3, 4), keepdim=True))
        return
    k = ctx.attr("ksize")
    s = ctx.attr("strides", [1, 1, 1])
    p = ctx.attr("paddings", [0, 0, 0])
    extra = [0, 0, 0]
    if ctx.attr("ceil_mode", False):
        for a in range(3):
            i = x.shape[2 + a]
            num = i + 2 * p[a] - k[a]
            out_d = (num + s[a] - 1) // s[a] + 1
            extra[a] = max((out_d - 1) * s[a] + k[a] - (i + 2 * p[a]), 0)
    # F.pad's order: the last dim first
    pads = []
    for a in (2, 1, 0):
        pads += [p[a], p[a] + extra[a]]
    if ptype == "max":
        xp = F.pad(x, pads, value=float("-inf")) if any(pads) else x
        ctx.set_output("Out", F.max_pool3d(xp, tuple(k), tuple(s)))
        return
    summed = F.avg_pool3d(F.pad(x, pads) if any(pads) else x, tuple(k),
                          tuple(s), divisor_override=1)
    if any(pads):
        ones = F.pad(torch.ones_like(x[:1, :1]), pads)
        out = summed / F.avg_pool3d(ones, tuple(k), tuple(s),
                                    divisor_override=1)
    else:
        out = summed / float(k[0] * k[1] * k[2])
    ctx.set_output("Out", out)


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


@register_op("lrn", infer_shape=_infer_same)
def lrn(ctx):
    """Cross-channel local response norm: MidOut = k + alpha * (the sum
    of x^2 over the n channels centred on each), Out = X / MidOut^beta.
    The op's k defaults to 2.0 (the layer's to 1.0)."""
    x = ctx.input("X")
    n = ctx.attr("n", 5)
    half = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = sq[:, 0:x.shape[1]]
    for i in range(1, n):
        acc = acc + sq[:, i:i + x.shape[1]]
    mid = ctx.attr("k", 2.0) + ctx.attr("alpha", 1e-4) * acc
    ctx.set_output("Out", x / torch.pow(mid, ctx.attr("beta", 0.75)))
    ctx.set_output("MidOut", mid)


@register_op("l2_normalize", infer_shape=_infer_same)
def l2_normalize(ctx):
    """X over sqrt(max(sum of squares along ``axis``, epsilon))."""
    x = ctx.input("X")
    ss = torch.sum(x * x, dim=ctx.attr("axis", 1), keepdim=True)
    ctx.set_output("Out", x / torch.sqrt(torch.maximum(
        ss, ss.new_full((), ctx.attr("epsilon", 1e-12)))))


@register_op("im2sequence")
def im2sequence(ctx):
    """Each ``kernels`` window of the padded image becomes a row: X
    ``[N, C, H, W]`` -> ``[N * oh * ow, C * kh * kw]``, the windows of an
    image in row-major order, a row's features channel-major
    (``F.unfold``, the counterpart of
    ``lax.conv_general_dilated_patches``)."""
    x = raw_data(ctx.input("X"))
    k = [int(v) for v in ctx.attr("kernels")]
    s = [int(v) for v in ctx.attr("strides", [1, 1])]
    p = [int(v) for v in ctx.attr("paddings", [0, 0, 0, 0])]
    n, c = x.shape[0], x.shape[1]
    xp = F.pad(x, (p[1], p[3], p[0], p[2]))
    patches = F.unfold(xp, kernel_size=k, stride=s)   # [N, C*kh*kw, L]
    ctx.set_output("Out", patches.transpose(1, 2).reshape(
        -1, c * k[0] * k[1]))


@register_op("scale_sub_region", infer_shape=_infer_same)
def scale_sub_region(ctx):
    """Multiply the [c1..c2, h1..h2, w1..w2] region of each [C, H, W]
    image by ``value``; Indices is [N, 6], one-based and inclusive. A
    mask from index comparisons, no branch, differentiable in X."""
    x = ctx.input("X")
    idx = ctx.input("Indices").to(torch.int32)
    n = x.shape[0]
    mask = None
    for a in range(3):
        dim = x.shape[a + 1]
        shape = [1, 1, 1, 1]
        shape[a + 1] = dim
        r = torch.arange(dim, dtype=torch.int32,
                         device=x.device).reshape(shape)
        lo = (idx[:, 2 * a] - 1).reshape(n, 1, 1, 1)
        hi = (idx[:, 2 * a + 1] - 1).reshape(n, 1, 1, 1)
        m = (r >= lo) & (r <= hi)
        mask = m if mask is None else mask & m
    ctx.set_output("Out", torch.where(mask, x * ctx.attr("value", 1.0), x))
