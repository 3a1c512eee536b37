"""AlexNet (counterpart of ``paddle_tpu/models/alexnet.py``): convs of
11 / 5 / 3 / 3 / 3, local response norm after the first two, max pools,
and two dropout fc 4096 layers before the softmax classifier. Its three
3x3 convs are stride 1, pad 1: the conv3x3 kernel's population."""
from __future__ import annotations

from .. import layers

__all__ = ["alexnet"]


def alexnet(input, class_dim=1000, is_test=False, use_lrn=True):
    net = layers.conv2d(input, num_filters=96, filter_size=11, stride=4,
                        padding=1, act="relu")
    if use_lrn:
        net = layers.lrn(net, n=5, alpha=1e-4, beta=0.75)
    net = layers.pool2d(net, pool_size=3, pool_stride=2, pool_type="max")

    net = layers.conv2d(net, num_filters=256, filter_size=5, padding=2,
                        groups=1, act="relu")
    if use_lrn:
        net = layers.lrn(net, n=5, alpha=1e-4, beta=0.75)
    net = layers.pool2d(net, pool_size=3, pool_stride=2, pool_type="max")

    net = layers.conv2d(net, num_filters=384, filter_size=3, padding=1,
                        act="relu")
    net = layers.conv2d(net, num_filters=384, filter_size=3, padding=1,
                        act="relu")
    net = layers.conv2d(net, num_filters=256, filter_size=3, padding=1,
                        act="relu")
    net = layers.pool2d(net, pool_size=3, pool_stride=2, pool_type="max")

    net = layers.fc(net, size=4096, act="relu")
    net = layers.dropout(net, dropout_prob=0.5, is_test=is_test)
    net = layers.fc(net, size=4096, act="relu")
    net = layers.dropout(net, dropout_prob=0.5, is_test=is_test)
    return layers.fc(net, size=class_dim, act="softmax")
