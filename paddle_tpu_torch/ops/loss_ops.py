"""Losses (counterparts in ``paddle_tpu/ops/loss_ops.py``:
``cross_entropy`` :28, ``softmax_with_cross_entropy`` :49,
``square_error_cost`` :76, whose grad is the generic one)."""
from __future__ import annotations

import torch

from ..core.executor import raw_data
from ..core.registry import register_op

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
    x = ctx.input("X")
    label = ctx.input("Label")
    logx = torch.log(torch.clamp(x.float(), 1e-15, 1.0))
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label.float() * logx, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logx, 1, label.long().reshape(-1, 1))
    ctx.set_output("Y", loss.to(x.dtype))


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


def _infer_same_as_x(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if xv is not None and ov is not None and xv.shape is not None:
        ov.shape = xv.shape
        ov.dtype = xv.dtype


@register_op("square_error_cost", infer_shape=_infer_same_as_x)
def square_error_cost(ctx):
    """(X - Y) ** 2, elementwise."""
    x = raw_data(ctx.input("X"))
    y = raw_data(ctx.input("Y"))
    ctx.set_output("Out", torch.square(x - y))
