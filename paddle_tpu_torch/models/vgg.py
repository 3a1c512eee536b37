"""VGG-16 (counterpart of ``paddle_tpu/models/vgg.py``): five blocks of
3x3 / s1 / p1 convs, each followed by batch norm and relu (or a relu
conv without BN), ending in a 2x2 max pool; then dropout, fc 4096 with
batch norm over the fc's features (``data_layout="NHWC"`` on a 2-D
tensor: the channel is the last dim), dropout, fc 4096, and the softmax
classifier. ``vgg_cifar`` is the book's CIFAR net with its per-conv
dropouts and 512-wide fcs.

All 13 convs of ``vgg16`` are the conv3x3 kernel's population, so under
``conv_impl=pallas3x3`` each runs the kernel, the first (C = 3) too."""
from __future__ import annotations

from .. import layers

__all__ = ["vgg16", "vgg_cifar"]


def _conv_block(input, num_filter, groups, dropouts=None, is_test=False,
                with_bn=True):
    tmp = input
    for i in range(groups):
        if with_bn:
            tmp = layers.conv2d(tmp, num_filters=num_filter, filter_size=3,
                                stride=1, padding=1, act=None,
                                bias_attr=False)
            tmp = layers.batch_norm(tmp, act="relu", is_test=is_test)
        else:
            tmp = layers.conv2d(tmp, num_filters=num_filter, filter_size=3,
                                stride=1, padding=1, act="relu")
        if dropouts and dropouts[i]:
            tmp = layers.dropout(tmp, dropout_prob=dropouts[i],
                                 is_test=is_test)
    return layers.pool2d(tmp, pool_size=2, pool_stride=2, pool_type="max")


def vgg16(input, class_dim=1000, is_test=False, with_bn=True):
    """VGG-16, the BN variant by default (the image benchmark's)."""
    c1 = _conv_block(input, 64, 2, is_test=is_test, with_bn=with_bn)
    c2 = _conv_block(c1, 128, 2, is_test=is_test, with_bn=with_bn)
    c3 = _conv_block(c2, 256, 3, is_test=is_test, with_bn=with_bn)
    c4 = _conv_block(c3, 512, 3, is_test=is_test, with_bn=with_bn)
    c5 = _conv_block(c4, 512, 3, is_test=is_test, with_bn=with_bn)
    d1 = layers.dropout(c5, dropout_prob=0.5, is_test=is_test)
    if with_bn:
        fc1 = layers.fc(d1, size=4096, act=None)
        fc1 = layers.batch_norm(fc1, act="relu", is_test=is_test,
                                data_layout="NHWC")
    else:
        fc1 = layers.fc(d1, size=4096, act="relu")
    d2 = layers.dropout(fc1, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(d2, size=4096, act="relu")
    return layers.fc(fc2, size=class_dim, act="softmax")


def vgg_cifar(input, class_dim=10, is_test=False):
    """The book's CIFAR VGG (vgg16_bn_drop, per-conv dropouts)."""
    c1 = _conv_block(input, 64, 2, dropouts=[0.3, 0], is_test=is_test)
    c2 = _conv_block(c1, 128, 2, dropouts=[0.4, 0], is_test=is_test)
    c3 = _conv_block(c2, 256, 3, dropouts=[0.4, 0.4, 0], is_test=is_test)
    c4 = _conv_block(c3, 512, 3, dropouts=[0.4, 0.4, 0], is_test=is_test)
    c5 = _conv_block(c4, 512, 3, dropouts=[0.4, 0.4, 0], is_test=is_test)
    d1 = layers.dropout(c5, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(d1, size=512, act=None)
    bn = layers.batch_norm(fc1, act="relu", is_test=is_test,
                           data_layout="NHWC")
    d2 = layers.dropout(bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(d2, size=512, act=None)
    return layers.fc(fc2, size=class_dim, act="softmax")
