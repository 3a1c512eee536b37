"""Losses (counterparts in ``paddle_tpu/ops/loss_ops.py``:
``cross_entropy`` :28, ``softmax_with_cross_entropy`` :49,
``sigmoid_cross_entropy_with_logits`` :68, ``square_error_cost`` :76,
``squared_l2_distance`` :83, ``squared_l2_norm`` :92 (the global-norm
clip's per-gradient term), ``label_smooth`` :98, ``l1_norm`` :111,
``modified_huber_loss`` :118, ``hinge_loss`` :134, ``huber_loss`` :141,
``smooth_l1_loss`` :153, ``log_loss`` :170, ``rank_loss`` :178,
``margin_rank_loss`` :187, ``cos_sim`` :198). All but the two cross
entropies take the generic grad, as in the JAX package; |x| is
``jax_abs``, whose gradient at 0 is JAX's.

Each formula is the JAX lowering's, kept as it is: ``rank_loss`` takes
``log1p(exp(d))`` (inf past d of about 88 in float32) and ``cos_sim``
adds 1e-12 to its denominator. A ``max(0, v)`` is ``torch.maximum``
against a zero, which at a tie gives half the gradient, as
``jnp.maximum`` does (``torch.clamp`` would give all of it)."""
from __future__ import annotations

import torch

from ..core.executor import raw_data, with_lod_of
from ..core.registry import register_op
from .common import jax_abs

__all__ = []


def _infer_loss_rowwise(op, block):
    names = op.input("X") or op.input("Logits")
    if not names:
        return
    xv = block._find_var_recursive(names[0])
    for slot in ("Y", "Out", "Loss"):
        for n in op.output(slot):
            ov = block._find_var_recursive(n)
            if ov is not None and xv is not None and xv.shape is not None:
                ov.shape = (xv.shape[0], 1)
                ov.dtype = xv.dtype


@register_op("cross_entropy", infer_shape=_infer_loss_rowwise)
def cross_entropy(ctx):
    """X holds probabilities (after a softmax); hard labels [N, 1] int or
    soft labels [N, D]. The log is taken in float32 of X clipped to
    [1e-15, 1]; Y [N, 1] is in X's dtype."""
    x_v = ctx.input("X")
    x, label = raw_data(x_v), raw_data(ctx.input("Label"))
    logx = torch.log(torch.clamp(x.float(), 1e-15, 1.0))
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label.float() * logx, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logx, 1, label.long().reshape(-1, 1))
    # a LoD X (a DynamicRNN's outputs) keeps its LoD, as in the JAX op
    ctx.set_output("Y", with_lod_of(x_v, loss.to(x.dtype)))


@register_op("softmax_with_cross_entropy", infer_shape=_infer_loss_rowwise)
def softmax_with_cross_entropy(ctx):
    """Logits [N, C], Label [N, 1] int (or [N, C] soft) -> Softmax [N, C],
    Loss [N, 1]; the log-softmax in float32."""
    logits = ctx.input("Logits")
    label = ctx.input("Label")
    logp = torch.log_softmax(logits.float(), dim=-1)
    ctx.set_output("Softmax", torch.exp(logp).to(logits.dtype))
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label.float() * logp, dim=-1, keepdim=True)
    else:
        lab = label.long().reshape(label.shape[0], 1)
        loss = -torch.gather(logp, 1, lab)
    ctx.set_output("Loss", loss.to(logits.dtype))


def _relu0(v):
    """max(v, 0) with ``jnp.maximum``'s gradient at the tie."""
    return torch.maximum(v, torch.zeros((), dtype=v.dtype, device=v.device))


@register_op("sigmoid_cross_entropy_with_logits", infer_shape=None)
def sigmoid_cross_entropy_with_logits(ctx):
    """max(X, 0) - X * Label + log1p(exp(-|X|)), elementwise."""
    x = raw_data(ctx.input("X"))
    label = raw_data(ctx.input("Label")).to(x.dtype)
    ctx.set_output("Out", _relu0(x) - x * label
                   + torch.log1p(torch.exp(-jax_abs(x))))


@register_op("square_error_cost")
def square_error_cost(ctx):
    """(X - Y) ** 2, elementwise."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y"))
    ctx.set_output("Out", torch.square(x - y))


@register_op("squared_l2_distance")
def squared_l2_distance(ctx):
    """sub_result = X - Y; Out = its squares summed over the last dim,
    kept as a dim of 1."""
    d = raw_data(ctx.input("X")) - raw_data(ctx.input("Y"))
    ctx.set_output("sub_result", d)
    ctx.set_output("Out", torch.sum(d * d, dim=-1, keepdim=True))


@register_op("squared_l2_norm")
def squared_l2_norm(ctx):
    """sum(X * X) as a [1] tensor."""
    x = raw_data(ctx.input("X"))
    ctx.set_output("Out", torch.sum(x * x).reshape((1,)))


@register_op("label_smooth")
def label_smooth(ctx):
    """(1 - epsilon) * X + epsilon * mu, mu the PriorDist row when given,
    else 1 / the number of classes."""
    x = raw_data(ctx.input("X"))
    eps = ctx.attr("epsilon", 0.0)
    if ctx.has_input("PriorDist"):
        mu = raw_data(ctx.input("PriorDist")).reshape(1, -1)
    else:
        mu = 1.0 / x.shape[-1]
    ctx.set_output("Out", (1.0 - eps) * x + eps * mu)


@register_op("l1_norm")
def l1_norm(ctx):
    """sum(|X|) as a [1] tensor."""
    x = raw_data(ctx.input("X"))
    ctx.set_output("Out", torch.sum(jax_abs(x)).reshape((1,)))


@register_op("modified_huber_loss")
def modified_huber_loss(ctx):
    """Labels Y in {0, 1}; v = X * (2Y - 1) (IntermediateVal); Out = -4v
    for v < -1, (1 - v)^2 for -1 <= v < 1, else 0."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y")).to(x.dtype)
    v = x * (2.0 * y - 1.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ctx.set_output("IntermediateVal", v)
    ctx.set_output("Out", torch.where(
        v < -1.0, -4.0 * v, torch.where(v < 1.0, (1.0 - v) ** 2, zero)))


@register_op("hinge_loss")
def hinge_loss(ctx):
    """max(0, 1 - (2 Labels - 1) Logits)."""
    logits = raw_data(ctx.input("Logits"))
    labels = raw_data(ctx.input("Labels")).to(logits.dtype)
    ctx.set_output("Loss", _relu0(1.0 - (2.0 * labels - 1.0) * logits))


@register_op("huber_loss")
def huber_loss(ctx):
    """Residual r = Y - X; Out = r^2 / 2 where |r| <= delta, else
    delta (|r| - delta / 2)."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y"))
    d = ctx.attr("delta", 1.0)
    r = y - x
    a = jax_abs(r)
    ctx.set_output("Residual", r)
    ctx.set_output("Out", torch.where(a <= d, 0.5 * r * r,
                                      d * (a - 0.5 * d)))


@register_op("smooth_l1_loss")
def smooth_l1_loss(ctx):
    """Diff = (X - Y) * InsideWeight; per element 0.5 sigma^2 Diff^2
    where |Diff| < 1 / sigma^2, else |Diff| - 0.5 / sigma^2, times
    OutsideWeight, summed over each row: Out [N, 1]."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y"))
    sigma = ctx.attr("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    if ctx.has_input("InsideWeight"):
        d = d * raw_data(ctx.input("InsideWeight"))
    a = jax_abs(d)
    per = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    if ctx.has_input("OutsideWeight"):
        per = per * raw_data(ctx.input("OutsideWeight"))
    ctx.set_output("Diff", d)
    ctx.set_output("Out", torch.sum(per.reshape(per.shape[0], -1), dim=1,
                                    keepdim=True))


@register_op("log_loss")
def log_loss(ctx):
    """-Labels log(Predicted + eps) - (1 - Labels) log(1 - Predicted +
    eps)."""
    p = raw_data(ctx.input("Predicted"))
    y = raw_data(ctx.input("Labels")).to(p.dtype)
    e = ctx.attr("epsilon", 1e-4)
    ctx.set_output("Loss", -y * torch.log(p + e)
                   - (1.0 - y) * torch.log(1.0 - p + e))


@register_op("rank_loss")
def rank_loss(ctx):
    """log1p(exp(Left - Right)) - Label (Left - Right)."""
    label = raw_data(ctx.input("Label"))
    d = raw_data(ctx.input("Left")) - raw_data(ctx.input("Right"))
    ctx.set_output("Out", torch.log1p(torch.exp(d)) - label.to(d.dtype) * d)


@register_op("margin_rank_loss")
def margin_rank_loss(ctx):
    """Out = max(0, -Label (X1 - X2) + margin); Activated = (Out > 0) in
    X1's dtype."""
    label = raw_data(ctx.input("Label"))
    x1 = raw_data(ctx.input("X1"))
    x2 = raw_data(ctx.input("X2"))
    out = _relu0(-label.to(x1.dtype) * (x1 - x2) + ctx.attr("margin", 0.0))
    ctx.set_output("Out", out)
    ctx.set_output("Activated", (out > 0).to(x1.dtype))


@register_op("cos_sim")
def cos_sim(ctx):
    """Row-wise cosine of X and Y over the last dim: XNorm and YNorm the
    row norms, Out = X.Y / (XNorm YNorm + 1e-12), each [N, 1]."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y"))
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    ctx.set_output("XNorm", xn)
    ctx.set_output("YNorm", yn)
    ctx.set_output("Out", torch.sum(x * y, dim=-1, keepdim=True)
                   / (xn * yn + 1e-12))
