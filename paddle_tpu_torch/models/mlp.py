"""The book's multilayer perceptron (counterpart of
``paddle_tpu/models/mlp.py``): fc layers with ``act``, then an fc
classifier."""
from __future__ import annotations

from .. import layers

__all__ = ["mlp"]


def mlp(x, label=None, hidden_sizes=(200, 200), class_num=10,
        act="relu", pred_act="softmax"):
    """(prediction, avg_cost, acc); cost and acc are None without
    ``label``."""
    h = x
    for size in hidden_sizes:
        h = layers.fc(h, size=size, act=act)
    prediction = layers.fc(h, size=class_num, act=pred_act)
    if label is None:
        return prediction, None, None
    cost = layers.cross_entropy(prediction, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(prediction, label)
    return prediction, avg_cost, acc
