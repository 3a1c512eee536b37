"""Composite network building blocks (counterpart of
``paddle_tpu/nets.py``: ``simple_img_conv_pool`` :14, ``img_conv_group``
:25, ``sequence_conv_pool`` :64, ``glu`` :74,
``scaled_dot_product_attention`` :80). Each is a composition of layer
calls, so a block built in both packages under ``unique_name.guard()``
has the same ops and variables."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max", use_cudnn=True):
    """conv2d then pool2d."""
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """A stack of convs, each optionally followed by batch norm (which
    then takes the act) and dropout, ending in one pool: the VGG block.
    A per-conv argument is one value for all or a list of one a conv."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(obj):
        if not hasattr(obj, "__len__"):
            return [obj] * len(conv_num_filter)
        assert len(obj) == len(conv_num_filter)
        return list(obj)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)

    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv then sequence_pool: the text-CNN block."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """The gated linear unit: a * sigmoid(b) over the two halves of
    ``input`` along ``dim``."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [batch, seq, dim]
    inputs, as layer ops: the heads split off by a reshape and a
    transpose, q scaled by 1 / sqrt(the head width), q kᵀ, softmax,
    optional dropout, the product with v, the heads joined again. (The
    transformer models' fused attention is ``flash_attention``, a
    kernel; this composition reaches none, as in the JAX package.)"""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if keys.shape[-1] % num_heads != 0:
        raise ValueError("hidden size must divide num_heads")

    def _split_heads(x, seq, hidden):
        if num_heads == 1:
            return x
        reshaped = layers.reshape(
            x, shape=[-1, seq, num_heads, hidden // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def _combine_heads(x, seq, hidden):
        if num_heads == 1:
            return x
        trans = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(trans, shape=[-1, seq, hidden])

    q_seq, hidden = queries.shape[-2], queries.shape[-1]
    q = _split_heads(queries, q_seq, hidden)
    k = _split_heads(keys, keys.shape[-2], hidden)
    v = _split_heads(values, values.shape[-2], values.shape[-1])
    key_dim = float(hidden // num_heads)
    scaled_q = layers.scale(x=q, scale=key_dim ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    return _combine_heads(ctx_multiheads, q_seq,
                          num_heads * (values.shape[-1] // num_heads))
