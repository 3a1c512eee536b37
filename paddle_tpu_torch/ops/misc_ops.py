"""The sampler and tree-softmax ops of the sequence layers (counterpart
of part of ``paddle_tpu/ops/misc_ops.py``: ``_tree_codes`` :25,
``hierarchical_sigmoid`` :47, ``log_uniform_random_int`` :322,
``log_uniform_prob`` :334 and ``custom_dist_random_int`` :341), which
the ``nce`` and ``hsigmoid`` layers append.

The other 10 ops of the JAX module (``factorization_machine``,
``multiplex``, ``spp``, ``max_pool2d_with_index``,
``max_pool3d_with_index``, ``bilinear_tensor_product``, ``unpool``,
``mdlstm``, ``bilinear_interp``, ``conv_shift``) are ROADMAP.md Queue 1
item 6's legacy surfaces.

The two samplers draw from the Executor's generator, as the port's
random ops do, so they agree with the JAX ops (threefry keys) in
distribution only (ROADMAP.md Queue 3 #30).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.executor import raw_data
from ..core.registry import register_op
from .common import constant

__all__ = ["log_uniform_prob"]


def _tree_codes(num_classes):
    """(node, bit, mask) tables ``[num_classes, L]`` of every class's
    root-to-leaf path under the complete-binary-tree code of the
    reference's SimpleCode: c = class + num_classes, length
    bit_length(c) - 1, node i = (c >> (length - i)) - 1, bit i =
    (c >> (length - i - 1)) & 1; padded to the longest code with mask
    0."""
    max_len = int(math.floor(math.log2(2 * num_classes - 1)))
    nodes = np.zeros((num_classes, max_len), np.int64)
    bits = np.zeros((num_classes, max_len), np.float32)
    mask = np.zeros((num_classes, max_len), np.float32)
    for c in range(num_classes):
        code = c + num_classes
        length = code.bit_length() - 1
        for i in range(length):
            nodes[c, i] = (code >> (length - i)) - 1
            bits[c, i] = float((code >> (length - i - 1)) & 1)
            mask[c, i] = 1.0
    return nodes, bits, mask


@register_op("hierarchical_sigmoid")
def hierarchical_sigmoid(ctx):
    """Out[n] = sum over the label's path of softplus(-(1 - 2 bit_i)
    (x_n . W[node_i] + Bias[node_i])): one gather of the path's rows of
    W and one batched product, the code tables device constants."""
    x = raw_data(ctx.input("X"))                        # [N, D]
    w = raw_data(ctx.input("W"))                        # [C - 1, D]
    label = raw_data(ctx.input("Label")).reshape(-1).to(torch.int64)
    bias = ctx.input("Bias")
    nodes, bits, mask = (constant(t, x.device) for t in _tree_codes(
        int(ctx.attr("num_classes"))))
    n_idx = nodes[label]                                # [N, L]
    logits = torch.einsum("nd,nld->nl", x, w[n_idx])
    if bias is not None:
        logits = logits + raw_data(bias).reshape(-1)[n_idx]
    sign = 1.0 - 2.0 * bits[label].to(x.dtype)
    # -log sigmoid(sign * z) = softplus(-sign * z) = logaddexp(., 0)
    cost = torch.logaddexp(-sign * logits, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
    ctx.set_output("Out", (cost * mask[label].to(x.dtype)).sum(dim=1)[:, None])


@register_op("log_uniform_random_int", no_gradient=True)
def log_uniform_random_int(ctx):
    """int64 draws of the log-uniform (Zipfian) law P(k) = log((k + 2) /
    (k + 1)) / log(range + 1) on [0, range), by its inverse CDF:
    floor(exp(u log(range + 1))) - 1."""
    shape = [int(d) for d in ctx.attr("shape")]
    rng_range = int(ctx.attr("range"))
    u = torch.rand(shape, dtype=torch.float32, device=ctx.device,
                   generator=ctx.next_generator())
    k = torch.exp(u * math.log(rng_range + 1.0)) - 1.0
    ctx.set_output("Out", torch.clamp(k.to(torch.int64), 0, rng_range - 1))


def log_uniform_prob(samples, rng_range):
    """log P(k) of the log-uniform sampler (for NCE's correction)."""
    k = samples.to(torch.float32)
    return torch.log(torch.log((k + 2.0) / (k + 1.0))
                     / math.log(rng_range + 1.0))


@register_op("custom_dist_random_int", no_gradient=True)
def custom_dist_random_int(ctx):
    """int64 draws of the categorical law Probs (normalized), by its
    inverse CDF: the first class whose cumulative share is at least a
    uniform draw."""
    shape = [int(d) for d in ctx.attr("shape")]
    probs = raw_data(ctx.input("Probs")).reshape(-1)
    cdf = torch.cumsum(probs / probs.sum(), dim=0)
    u = torch.rand(shape, dtype=cdf.dtype, device=cdf.device,
                   generator=ctx.next_generator())
    out = torch.searchsorted(cdf, u.reshape(-1)).reshape(shape)
    ctx.set_output("Out", torch.clamp(out, 0, probs.shape[0] - 1))
