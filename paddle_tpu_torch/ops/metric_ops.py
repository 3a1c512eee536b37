"""Metric ops (counterpart of ``paddle_tpu/ops/metric_ops.py``:
``accuracy`` :11; ``auc`` and ``precision_recall`` are not ported)."""
from __future__ import annotations

import torch

from ..core.registry import register_op

__all__ = []


@register_op("accuracy", no_gradient=True)
def accuracy(ctx):
    """The top-k hit ratio from the ``Indices`` of a ``top_k`` op and the
    int label column: Accuracy float32 [1], Correct and Total int32
    [1]."""
    indices = ctx.input("Indices").long()
    label = ctx.input("Label").long().reshape(-1, 1)
    correct = torch.any(indices == label, dim=1).sum()
    total = indices.shape[0]
    ctx.set_output("Accuracy", (correct.float() / total).reshape(1))
    ctx.set_output("Correct", correct.reshape(1).to(torch.int32))
    ctx.set_output("Total", torch.full((1,), total, dtype=torch.int32,
                                       device=indices.device))
