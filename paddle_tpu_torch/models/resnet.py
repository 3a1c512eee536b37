"""ResNet family (counterpart of ``paddle_tpu/models/resnet.py``, block
for block): ImageNet ResNet-18/34 with basic blocks and 50/101/152 with
bottleneck blocks, and the CIFAR ResNet with (depth - 2) / 6 basic
blocks a stage. Every conv is bias-free and followed by a batch norm.

The bottleneck puts its stride on the first 1x1 conv, so every 3x3 conv
of ResNet-50 is stride 1, pad 1: the population of the conv3x3 kernel
under ``conv_impl=pallas3x3``.

The residual adds pass ``act="relu"`` to ``layers.elementwise_add``,
which, in both packages, builds its ``LayerHelper`` without the act and
so appends no relu: the programs match op for op (``ROADMAP.md``,
faults of the reference).
"""
from __future__ import annotations

from .. import layers

__all__ = ["resnet", "resnet_cifar10", "resnet_imagenet"]


def _conv_bn(input, ch_out, filter_size, stride, padding, act="relu",
             is_test=False):
    conv = layers.conv2d(input, num_filters=ch_out, filter_size=filter_size,
                         stride=stride, padding=padding, act=None,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def _shortcut(input, ch_in, ch_out, stride, is_test=False):
    if ch_in != ch_out or stride != 1:
        return _conv_bn(input, ch_out, 1, stride, 0, act=None,
                        is_test=is_test)
    return input


def _basicblock(input, ch_in, ch_out, stride, is_test=False):
    """Two 3x3 convs (CIFAR, ResNet-18/34)."""
    short = _shortcut(input, ch_in, ch_out, stride, is_test=is_test)
    conv1 = _conv_bn(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = _conv_bn(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def _bottleneck(input, ch_in, ch_out, stride, is_test=False):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck (ResNet-50 and deeper)."""
    short = _shortcut(input, ch_in, ch_out * 4, stride, is_test=is_test)
    conv1 = _conv_bn(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = _conv_bn(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = _conv_bn(conv2, ch_out * 4, 1, 1, 0, act=None, is_test=is_test)
    return layers.elementwise_add(short, conv3, act="relu")


def _layer_warp(block_func, input, ch_in, ch_out, count, stride,
                is_test=False):
    res = block_func(input, ch_in, ch_out, stride, is_test=is_test)
    ch_in = ch_out * (4 if block_func is _bottleneck else 1)
    for _ in range(1, count):
        res = block_func(res, ch_in, ch_out, 1, is_test=is_test)
    return res


_IMAGENET_CFG = {
    18: (_basicblock, [2, 2, 2, 2]),
    34: (_basicblock, [3, 4, 6, 3]),
    50: (_bottleneck, [3, 4, 6, 3]),
    101: (_bottleneck, [3, 4, 23, 3]),
    152: (_bottleneck, [3, 8, 36, 3]),
}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False):
    """ImageNet ResNet: 7x7/s2 stem, 3x3/s2 max pool, four stages,
    global average pool, fc with softmax; returns the probabilities."""
    block_func, stages = _IMAGENET_CFG[depth]
    conv1 = _conv_bn(input, 64, 7, 2, 3, is_test=is_test)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2, pool_padding=1,
                          pool_type="max")
    res = pool1
    ch_in = 64
    for i, (count, ch_out) in enumerate(zip(stages, [64, 128, 256, 512])):
        stride = 1 if i == 0 else 2
        res = _layer_warp(block_func, res, ch_in, ch_out, count, stride,
                          is_test=is_test)
        ch_in = ch_out * (4 if block_func is _bottleneck else 1)
    pool2 = layers.pool2d(res, pool_size=7, pool_stride=1, pool_type="avg",
                          global_pooling=True)
    return layers.fc(pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    """CIFAR ResNet with (depth - 2) / 6 basic blocks a stage."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = _conv_bn(input, 16, 3, 1, 1, is_test=is_test)
    res1 = _layer_warp(_basicblock, conv1, 16, 16, n, 1, is_test=is_test)
    res2 = _layer_warp(_basicblock, res1, 16, 32, n, 2, is_test=is_test)
    res3 = _layer_warp(_basicblock, res2, 32, 64, n, 2, is_test=is_test)
    pool = layers.pool2d(res3, pool_size=8, pool_stride=1, pool_type="avg",
                         global_pooling=True)
    return layers.fc(pool, size=class_dim, act="softmax")


def resnet(input, class_dim=1000, depth=50, variant="imagenet",
           is_test=False):
    if variant == "imagenet":
        return resnet_imagenet(input, class_dim, depth, is_test=is_test)
    return resnet_cifar10(input, class_dim, depth, is_test=is_test)
