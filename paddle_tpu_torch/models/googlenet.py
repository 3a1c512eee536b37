"""GoogLeNet, Inception v1 without the auxiliary heads (counterpart of
``paddle_tpu/models/googlenet.py``): a 7x7 / s2 stem, and nine inception
modules, each the concat of 1x1, 1x1 -> 3x3, 1x1 -> 5x5 and pool -> 1x1
towers; global average pool, dropout, the softmax classifier. Its 3x3
convs (the stem's second and one a module) are stride 1, pad 1: the
conv3x3 kernel's population."""
from __future__ import annotations

from .. import layers

__all__ = ["googlenet"]


def _inception(input, c1, c3r, c3, c5r, c5, proj):
    t1 = layers.conv2d(input, num_filters=c1, filter_size=1, act="relu")
    t3 = layers.conv2d(input, num_filters=c3r, filter_size=1, act="relu")
    t3 = layers.conv2d(t3, num_filters=c3, filter_size=3, padding=1,
                       act="relu")
    t5 = layers.conv2d(input, num_filters=c5r, filter_size=1, act="relu")
    t5 = layers.conv2d(t5, num_filters=c5, filter_size=5, padding=2,
                       act="relu")
    tp = layers.pool2d(input, pool_size=3, pool_stride=1, pool_padding=1,
                       pool_type="max")
    tp = layers.conv2d(tp, num_filters=proj, filter_size=1, act="relu")
    return layers.concat_nn([t1, t3, t5, tp], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    net = layers.conv2d(input, num_filters=64, filter_size=7, stride=2,
                        padding=3, act="relu")
    net = layers.pool2d(net, pool_size=3, pool_stride=2, pool_type="max")
    net = layers.conv2d(net, num_filters=64, filter_size=1, act="relu")
    net = layers.conv2d(net, num_filters=192, filter_size=3, padding=1,
                        act="relu")
    net = layers.pool2d(net, pool_size=3, pool_stride=2, pool_type="max")

    net = _inception(net, 64, 96, 128, 16, 32, 32)    # 3a
    net = _inception(net, 128, 128, 192, 32, 96, 64)  # 3b
    net = layers.pool2d(net, pool_size=3, pool_stride=2, pool_type="max")

    net = _inception(net, 192, 96, 208, 16, 48, 64)   # 4a
    net = _inception(net, 160, 112, 224, 24, 64, 64)  # 4b
    net = _inception(net, 128, 128, 256, 24, 64, 64)  # 4c
    net = _inception(net, 112, 144, 288, 32, 64, 64)  # 4d
    net = _inception(net, 256, 160, 320, 32, 128, 128)  # 4e
    net = layers.pool2d(net, pool_size=3, pool_stride=2, pool_type="max")

    net = _inception(net, 256, 160, 320, 32, 128, 128)  # 5a
    net = _inception(net, 384, 192, 384, 48, 128, 128)  # 5b
    net = layers.pool2d(net, pool_size=7, pool_stride=1, pool_type="avg",
                        global_pooling=True)
    net = layers.dropout(net, dropout_prob=0.4, is_test=is_test)
    return layers.fc(net, size=class_dim, act="softmax")
