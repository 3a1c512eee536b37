"""Creation and shaping ops (counterparts in
``paddle_tpu/ops/tensor_ops.py``: ``fill_constant`` :34,
``fill_constant_batch_size_like`` :63, ``uniform_random`` :106,
``gaussian_random`` :115, ``assign`` :132, ``cast`` :143, ``reshape``
:198, ``lookup_table`` :376).

Random ops draw from the Executor's ``torch.Generator`` (seeded from
``Program.random_seed``), so they differ from the JAX package's threefry
draws and agree with them in distribution only; the ``seed`` attr is
ignored, as the JAX package ignores it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import registry
from ..core.executor import raw_data, with_lod_of
from ..core.registry import register_op
from .common import prod, tdt

__all__ = []


def _shape_attr(ctx):
    return [int(d) for d in ctx.attr("shape")]


def _infer_from_shape_attr(op, block):
    for n in op.output("Out"):
        v = block._find_var_recursive(n)
        if v is not None and op.attr("shape") is not None:
            v.shape = tuple(int(d) for d in op.attr("shape"))


@register_op("fill_constant", infer_shape=_infer_from_shape_attr)
def fill_constant(ctx):
    ctx.set_output("Out", torch.full(_shape_attr(ctx), ctx.attr("value", 0.0),
                                     dtype=tdt(ctx.attr("dtype")),
                                     device=ctx.device))


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ctx):
    ref = ctx.input("Input")
    shape = _shape_attr(ctx)
    shape[ctx.attr("output_dim_idx", 0)] = ref.shape[
        ctx.attr("input_dim_idx", 0)]
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=tdt(ctx.attr("dtype")),
                                     device=ctx.device))


@register_op("uniform_random", infer_shape=_infer_from_shape_attr,
             no_gradient=True)
def uniform_random(ctx):
    out = torch.empty(_shape_attr(ctx), dtype=tdt(ctx.attr("dtype")),
                      device=ctx.device)
    out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                 generator=ctx.next_generator())
    ctx.set_output("Out", out)


@register_op("gaussian_random", infer_shape=_infer_from_shape_attr,
             no_gradient=True)
def gaussian_random(ctx):
    out = torch.empty(_shape_attr(ctx), dtype=tdt(ctx.attr("dtype")),
                      device=ctx.device)
    out.normal_(ctx.attr("mean", 0.0), ctx.attr("std", 1.0),
                generator=ctx.next_generator())
    ctx.set_output("Out", out)


@register_op("assign")
def assign(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("cast")
def cast(ctx):
    ctx.set_output("Out", ctx.input("X").to(tdt(ctx.attr("out_dtype"))))


def _infer_elem_like(op, block, in_slot="X"):
    names = op.input(in_slot)
    if not names:
        return
    iv = block._find_var_recursive(names[0])
    for n in op.output("Out"):
        ov = block._find_var_recursive(n)
        if ov is not None and iv is not None:
            ov.shape = iv.shape
            if ov.dtype is None:
                ov.dtype = iv.dtype


registry.set_infer_shape("assign", _infer_elem_like)


def _resolve_shape(shape, in_shape):
    """The reshape attr against the input's shape: 0 copies the input's
    dim, -1 takes what is left."""
    shape = [int(d) for d in shape]
    total = prod(in_shape)
    if 0 in shape:
        shape = [in_shape[i] if d == 0 else d for i, d in enumerate(shape)]
    if -1 in shape:
        known = prod(d for d in shape if d != -1)
        shape[shape.index(-1)] = total // max(known, 1)
    return shape


def _infer_reshape(op, block):
    iv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if iv is None or ov is None or iv.shape is None:
        return
    shape = list(op.attr("shape"))
    if -1 not in iv.shape:
        ov.shape = tuple(_resolve_shape(shape, iv.shape))
    else:
        ov.shape = tuple(shape)
    ov.dtype = iv.dtype


@register_op("reshape", infer_shape=_infer_reshape)
def reshape(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x.reshape(_resolve_shape(ctx.attr("shape"),
                                                   x.shape)))


@register_op("lookup_table")
def lookup_table(ctx):
    """Embedding lookup: rows of W gathered by Ids (a trailing dim of 1 is
    dropped); rows at ``padding_idx`` read as zeros. Ragged Ids give a
    ragged Out with their LoD."""
    w = ctx.input("W")
    ids_v = ctx.input("Ids")
    ids = raw_data(ids_v).long()
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.reshape(ids.shape[:-1])
    out = F.embedding(ids, w)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    ctx.set_output("Out", with_lod_of(ids_v, out))
