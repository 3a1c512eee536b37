"""LeNet-5 for MNIST (counterpart of ``paddle_tpu/models/lenet.py``):
two conv-pool stages and an fc softmax, the book's digit recognizer.
Its 5 x 5 convs run on cuDNN (``F.conv2d``), as the JAX package leaves
them to ``lax.conv``: the hand-written conv kernel takes 3 x 3 only."""
from __future__ import annotations

from .. import layers

__all__ = ["lenet5"]


def _conv_pool(input, num_filters, filter_size, pool_size, pool_stride, act):
    conv = layers.conv2d(input, num_filters=num_filters,
                         filter_size=filter_size, act=act)
    return layers.pool2d(conv, pool_size=pool_size, pool_stride=pool_stride,
                         pool_type="max")


def lenet5(img, label=None, class_num=10):
    """(prediction, avg_cost, acc); cost and acc are None without
    ``label``."""
    c1 = _conv_pool(img, num_filters=20, filter_size=5, pool_size=2,
                    pool_stride=2, act="relu")
    c2 = _conv_pool(c1, num_filters=50, filter_size=5, pool_size=2,
                    pool_stride=2, act="relu")
    prediction = layers.fc(c2, size=class_num, act="softmax")
    if label is None:
        return prediction, None, None
    cost = layers.cross_entropy(prediction, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(prediction, label)
    return prediction, avg_cost, acc
