"""Metric ops (counterpart of ``paddle_tpu/ops/metric_ops.py``:
``accuracy`` :11, ``auc`` :27, ``precision_recall`` :48,
``edit_distance`` :74, ``positive_negative_pair`` :112). None has a
gradient. Each stays on the device and reads no value back to the host,
so a step that holds one is captured whole."""
from __future__ import annotations

import torch

from ..core.executor import raw_data
from ..core.registry import register_op
from .sequence_ops import segment_ids, seq_offsets

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


@register_op("auc", no_gradient=True)
def auc(ctx):
    """The batch's ROC AUC, a scalar: the positive-class probability
    (column 1 of a two-column Out, else Out flattened) against
    ``num_thresholds`` thresholds i / (num_thresholds - 1) (the grid
    ``jnp.linspace(0, 1)`` gives), the true and false positive rates at
    each, and |the trapezoid rule| over the curve."""
    probs = raw_data(ctx.input("Out"))
    label = raw_data(ctx.input("Label")).reshape(-1).to(torch.float32)
    num_t = ctx.attr("num_thresholds", 200)
    pos_prob = probs[:, 1] if probs.ndim == 2 and probs.shape[1] > 1 \
        else probs.reshape(-1)
    th = torch.arange(num_t, dtype=torch.float32,
                      device=probs.device) / (num_t - 1)
    pred_pos = (pos_prob[None, :] >= th[:, None]).to(torch.float32)
    tp = torch.sum(pred_pos * label[None, :], dim=1)
    fp = torch.sum(pred_pos * (1.0 - label[None, :]), dim=1)
    tpr = tp / torch.clamp(torch.sum(label), min=1e-6)
    fpr = fp / torch.clamp(torch.sum(1.0 - label), min=1e-6)
    area = 0.5 * torch.sum(torch.diff(fpr) * (tpr[1:] + tpr[:-1]))
    ctx.set_output("AUC", torch.abs(area).reshape(()))


@register_op("precision_recall", no_gradient=True)
def precision_recall(ctx):
    """BatchMetrics, float32 [6]: the macro precision, recall and F1 (the
    mean over ``class_number`` classes), then the micro ones, from the
    predicted ``Indices`` against ``Labels``. A class id outside
    [0, class_number) is read as JAX's gather reads it: a negative one
    from the end, then clamped into range (a torch gather would stop
    the card with a device assert)."""
    cls = ctx.attr("class_number")

    def ids(v):
        v = raw_data(v).reshape(-1).long()
        return torch.clamp(torch.where(v < 0, v + cls, v), 0, cls - 1)

    eye = torch.eye(cls, dtype=torch.float32,
                    device=raw_data(ctx.input("Indices")).device)
    onehot_p = eye[ids(ctx.input("Indices"))]
    onehot_l = eye[ids(ctx.input("Labels"))]
    tp = torch.sum(onehot_p * onehot_l, dim=0)
    fp = torch.sum(onehot_p * (1 - onehot_l), dim=0)
    fn = torch.sum((1 - onehot_p) * onehot_l, dim=0)

    def ratio(a, b):
        return a / torch.clamp(b, min=1e-6)

    prec, rec = ratio(tp, tp + fp), ratio(tp, tp + fn)
    f1 = ratio(2 * prec * rec, prec + rec)
    micro_p = ratio(torch.sum(tp), torch.sum(tp + fp))
    micro_r = ratio(torch.sum(tp), torch.sum(tp + fn))
    micro_f1 = ratio(2 * micro_p * micro_r, micro_p + micro_r)
    ctx.set_output("BatchMetrics", torch.stack([
        torch.mean(prec), torch.mean(rec), torch.mean(f1), micro_p, micro_r,
        micro_f1]))


@register_op("edit_distance", no_gradient=True)
def edit_distance(ctx):
    """The Levenshtein distance of each row of Hyps [N, T1] to the same
    row of Refs [N, T2] (dense ints; a 1-D pair is one row), float32
    [N, 1], divided by T2 under ``normalized``; SequenceNum int64 [1] is
    N (int64 as declared: ROADMAP.md Queue 3 #26). The JAX lowering's two
    nested scans as a loop over T1 x T2 on [N] tensors: one dynamic-
    programming row a hypothesis token, every row of the batch at
    once."""
    hyp = raw_data(ctx.input("Hyps")).to(torch.int32)
    ref = raw_data(ctx.input("Refs")).to(torch.int32)
    if hyp.ndim == 1:
        hyp, ref = hyp[None, :], ref[None, :]
    N, n = hyp.shape[0], ref.shape[1]
    row = [torch.full((N,), float(j), dtype=torch.float32,
                      device=hyp.device) for j in range(n + 1)]
    for i in range(hyp.shape[1]):
        hi = hyp[:, i]
        prev_diag, last = row[0], row[0] + 1.0
        new = [last]
        for j in range(1, n + 1):
            cost = (hi != ref[:, j - 1]).to(torch.float32)
            last = torch.minimum(torch.minimum(row[j] + 1.0, last + 1.0),
                                 prev_diag + cost)
            prev_diag = row[j]
            new.append(last)
        row = new
    d = row[n] / n if ctx.attr("normalized", False) else row[n]
    ctx.set_output("Out", d.reshape(-1, 1))
    ctx.set_output("SequenceNum", torch.full((1,), N, dtype=torch.int64,
                                             device=hyp.device))


@register_op("positive_negative_pair", no_gradient=True)
def positive_negative_pair(ctx):
    """Over the item pairs of one query with different labels (each
    unordered pair once, label_i > label_j), the count of score orders
    that agree (PositivePair), disagree (NegativePair) and tie
    (NeutralPair), float32 [1] each. The queries are QueryID when given,
    else the LoD sequences of Score."""
    s_in = ctx.input("Score")
    score = raw_data(s_in).reshape(-1)
    label = raw_data(ctx.input("Label")).reshape(-1)
    if ctx.has_input("QueryID"):
        qid = raw_data(ctx.input("QueryID")).reshape(-1)
    else:
        qid = segment_ids(seq_offsets(s_in), score.shape[0])
    cand = (qid[:, None] == qid[None, :]) & (label[:, None]
                                             - label[None, :] > 0)
    sdiff = score[:, None] - score[None, :]
    for slot, hit in (("PositivePair", sdiff > 0),
                      ("NegativePair", sdiff < 0),
                      ("NeutralPair", sdiff == 0)):
        ctx.set_output(slot, torch.sum(cand & hit, dtype=torch.float32)
                       .reshape(1))
