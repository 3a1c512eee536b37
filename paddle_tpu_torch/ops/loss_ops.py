"""The loss of the transformer LM (counterpart of
``paddle_tpu/ops/loss_ops.py``: ``softmax_with_cross_entropy`` :49)."""
from __future__ import annotations

import torch

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
