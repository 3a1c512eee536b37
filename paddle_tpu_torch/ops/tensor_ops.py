"""Creation, shaping and index ops (counterparts in
``paddle_tpu/ops/tensor_ops.py``: ``fill_constant`` :34, ``fill`` :52,
``fill_constant_batch_size_like`` :63, the ``*_batch_size_like`` random
ops :74-97, ``fill_zeros_like`` :100, ``uniform_random`` :106,
``gaussian_random`` :115, ``truncated_gaussian_random`` :123, ``assign``
:132, ``shape`` :137, ``cast`` :143, ``reshape`` :198, ``squeeze`` :204,
``unsqueeze`` :223, ``transpose`` :240, ``expand`` :246, ``concat`` :266,
``split`` :276, ``gather`` :290, ``scatter`` :297, ``one_hot`` :305,
``pad`` :314, ``slice`` :347, ``crop`` :365, ``lookup_table`` :376,
``increment`` :395, ``is_empty`` :411, ``arg_max`` :417, ``arg_min``
:423, ``argsort`` :429, ``range`` :438, ``assign_value`` :447,
``reverse`` :455, ``sampling_id`` :470).

Random ops draw from the Executor's ``torch.Generator`` (seeded from
``Program.random_seed``), so they differ from the JAX package's threefry
draws and agree with them in distribution only; the ``seed`` attr is
ignored, as the JAX package ignores it.

Index outputs (``arg_max``, ``arg_min``, ``argsort``'s Indices, ``shape``,
``range``) are int64, the dtype each JAX lowering asks for; JAX, with
64-bit types off, holds them in int32 (the values agree). Tensors made
from host values (``fill``, ``shape``, ``is_empty``, ``range``) come from
:func:`.common.constant`, so a captured step copies nothing from host
memory.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core import registry
from ..core.executor import (ConcreteScalar, concrete_value, raw_data,
                             with_lod_of)
from ..core.registry import register_op
from .common import constant, np_dtype, prod, tdt

__all__ = []


def _shape_attr(ctx):
    return [int(d) for d in ctx.attr("shape")]


def _infer_from_shape_attr(op, block):
    for n in op.output("Out"):
        v = block._find_var_recursive(n)
        if v is not None and op.attr("shape") is not None:
            v.shape = tuple(int(d) for d in op.attr("shape"))


def _is_integer(dtype):
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


@register_op("fill_constant", infer_shape=_infer_from_shape_attr)
def fill_constant(ctx):
    """A scalar integer fill (a loop counter, an array bound) keeps its
    host value (``paddle_tpu/ops/tensor_ops.py:34-49``): the reference's
    ``force_cpu`` fill that ``while_op.cc`` reads on the host."""
    shape, dt = _shape_attr(ctx), tdt(ctx.attr("dtype"))
    value = ctx.attr("value", 0.0)
    out = torch.full(shape, value, dtype=dt, device=ctx.device)
    if prod(shape) == 1 and _is_integer(dt):
        out = ConcreteScalar(int(value), out)
    ctx.set_output("Out", out)


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
    ctx.set_output("Out", ctx.concrete_input("X"))


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


@register_op("gather")
def gather(ctx):
    """Rows of X at Index (any shape, read as a flat list)."""
    x = raw_data(ctx.input("X"))
    idx = raw_data(ctx.input("Index")).reshape(-1).long()
    ctx.set_output("Out", torch.index_select(x, 0, idx))


@register_op("increment", stateful_outputs=("Out",))
def increment(ctx):
    """X + step in X's dtype: an int64 step counter stays int64 (the JAX
    lowering adds ``jnp.asarray(step, x.dtype)``; in PyTorch an int64
    tensor plus a Python float would be float32). A concrete counter
    stays concrete (``paddle_tpu/ops/tensor_ops.py:395-408``), so that a
    While condition on it is known while the step is traced."""
    xv = ctx.concrete_input("X")
    x = raw_data(xv)
    step = ctx.attr("step", 1.0)
    if not (x.is_floating_point() or x.is_complex()):
        step = int(step)  # truncates toward zero, as the cast to X's type
    out = x + step
    cv = concrete_value(xv)
    if cv is not None:
        out = ConcreteScalar(cv + (int(step) if isinstance(cv, int)
                                   else step), out)
    ctx.set_output("Out", out)


@register_op("assign_value", no_gradient=True,
             infer_shape=_infer_from_shape_attr)
def assign_value(ctx):
    """Out = the ``values`` attr in the ``dtype`` attr (the values' own
    dtype by default)."""
    vals = np.asarray(ctx.attr("values"))
    vals = vals.astype(np_dtype(ctx.attr("dtype"), str(vals.dtype)))
    ctx.set_output("Out", constant(vals, ctx.device))


# -- creation from host values, and the random ops ----------------------------

@register_op("fill", infer_shape=_infer_from_shape_attr)
def fill(ctx):
    """The float ``value`` list attr as a tensor of ``shape`` in
    ``dtype``."""
    vals = np.asarray(ctx.attr("value", []),
                      dtype=np_dtype(ctx.attr("dtype")))
    ctx.set_output("Out", constant(vals.reshape(_shape_attr(ctx)),
                                   ctx.device))


@register_op("fill_zeros_like", infer_shape=_infer_elem_like)
def fill_zeros_like(ctx):
    """Zeros of X's shape and dtype; Out keeps X's LoD."""
    x = ctx.input("X")
    ctx.set_output("Out", with_lod_of(x, torch.zeros_like(raw_data(x))))


def _rand_batch_size_like(ctx, fill_):
    """``shape`` with dim ``output_dim_idx`` taken from Input's dim
    ``input_dim_idx``, filled in place by ``fill_(out, generator)``."""
    ref = raw_data(ctx.input("Input"))
    shape = _shape_attr(ctx)
    shape[ctx.attr("output_dim_idx", 0)] = ref.shape[
        ctx.attr("input_dim_idx", 0)]
    out = torch.empty(shape, dtype=tdt(ctx.attr("dtype")),
                      device=ctx.device)
    fill_(out, ctx.next_generator())
    ctx.set_output("Out", out)


@register_op("uniform_random_batch_size_like", no_gradient=True)
def uniform_random_batch_size_like(ctx):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    _rand_batch_size_like(ctx, lambda t, g: t.uniform_(lo, hi, generator=g))


@register_op("gaussian_random_batch_size_like", no_gradient=True)
def gaussian_random_batch_size_like(ctx):
    mean, std = ctx.attr("mean", 0.0), ctx.attr("std", 1.0)
    _rand_batch_size_like(ctx, lambda t, g: t.normal_(mean, std,
                                                      generator=g))


_SQRT2 = math.sqrt(2.0)


@register_op("truncated_gaussian_random", infer_shape=_infer_from_shape_attr,
             no_gradient=True)
def truncated_gaussian_random(ctx):
    """Standard normal draws cut at +-2 (by the inverse CDF of a uniform
    draw between the two cut points, as ``jax.random.truncated_normal(-2,
    2)`` draws), then ``* std + mean``."""
    dt = tdt(ctx.attr("dtype"))
    work = dt if dt in (torch.float32, torch.float64) else torch.float32
    u = torch.empty(_shape_attr(ctx), dtype=work, device=ctx.device)
    u.uniform_(math.erf(-2.0 / _SQRT2), math.erf(2.0 / _SQRT2),
               generator=ctx.next_generator())
    z = torch.clamp(torch.erfinv(u) * _SQRT2, -2.0, 2.0)
    ctx.set_output("Out", (z * ctx.attr("std", 1.0)
                           + ctx.attr("mean", 0.0)).to(dt))


def _infer_sampling_id(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    ov.shape = (xv.shape[0],)
    ov.dtype = "int64"


@register_op("sampling_id", infer_shape=_infer_sampling_id,
             no_gradient=True)
def sampling_id(ctx):
    """One class id a row of the [N, C] weights X by the inverse CDF of
    a uniform draw u: id = #{j : cdf_j < u * total}, at most C - 1."""
    x = raw_data(ctx.input("X"))
    u = torch.rand((x.shape[0], 1), dtype=torch.float32, device=ctx.device,
                   generator=ctx.next_generator())
    cdf = torch.cumsum(x.float(), dim=1)
    ids = torch.sum(cdf < u * cdf[:, -1:], dim=1)
    ctx.set_output("Out", torch.clamp(ids, max=x.shape[1] - 1))


# -- shaping -----------------------------------------------------------------

@register_op("shape", no_gradient=True)
def shape_op(ctx):
    """The int64 shape of Input (or X)."""
    x = raw_data(ctx.input("Input") if ctx.has_input("Input")
                 else ctx.input("X"))
    ctx.set_output("Out", constant(np.asarray(x.shape, np.int64),
                                   ctx.device))


@register_op("squeeze")
def squeeze(ctx):
    """X without the dims ``axes`` (every dim of 1 when ``axes`` is
    empty); a listed dim that is not 1 is refused, as ``jnp.squeeze``
    refuses it."""
    x = raw_data(ctx.input("X"))
    axes = ctx.attr("axes") or [i for i, d in enumerate(x.shape) if d == 1]
    axes = {a % x.ndim for a in axes}
    for a in axes:
        if x.shape[a] != 1:
            raise ValueError("squeeze: dim %d of %s is not 1"
                             % (a, tuple(x.shape)))
    ctx.set_output("Out", x.reshape([d for i, d in enumerate(x.shape)
                                     if i not in axes]))


def _infer_unsqueeze(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    shape = list(xv.shape)
    for a in sorted(op.attr("axes")):
        shape.insert(a, 1)
    ov.shape = tuple(shape)
    ov.dtype = xv.dtype


@register_op("unsqueeze", infer_shape=_infer_unsqueeze)
def unsqueeze(ctx):
    out = raw_data(ctx.input("X"))
    for a in sorted(ctx.attr("axes")):
        out = out.unsqueeze(a)
    ctx.set_output("Out", out)


def _infer_transpose(op, block):
    iv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if iv is not None and ov is not None and iv.shape is not None:
        ov.shape = tuple(iv.shape[a] for a in op.attr("axis"))
        ov.dtype = iv.dtype


@register_op("transpose", infer_shape=_infer_transpose)
def transpose(ctx):
    ctx.set_output("Out", raw_data(ctx.input("X")).permute(
        *ctx.attr("axis")))


@register_op("expand")
def expand(ctx):
    """X tiled ``expand_times`` times along each dim (``jnp.tile``)."""
    ctx.set_output("Out", torch.tile(raw_data(ctx.input("X")),
                                     tuple(ctx.attr("expand_times"))))


def _infer_concat(op, block):
    vs = [block._find_var_recursive(n) for n in op.input("X")]
    ov = block._find_var_recursive(op.output("Out")[0])
    if ov is None or any(v is None or v.shape is None for v in vs):
        return
    axis = op.attr("axis", 0)
    shape = list(vs[0].shape)
    if all(v.shape[axis] != -1 for v in vs):
        shape[axis] = sum(v.shape[axis] for v in vs)
    ov.shape = tuple(shape)
    ov.dtype = vs[0].dtype


@register_op("concat", infer_shape=_infer_concat)
def concat(ctx):
    """The X list joined along ``axis``; Out keeps the first input's LoD
    unless ``axis`` is 0 (a feature-axis concat of sequences is still
    the same sequences)."""
    ins = ctx.inputs("X")
    axis = ctx.attr("axis", 0)
    out = torch.cat([raw_data(v) for v in ins], dim=axis)
    ctx.set_output("Out", with_lod_of(ins[0], out) if axis != 0 else out)


@register_op("split")
def split(ctx):
    """X cut along ``axis`` into pieces of ``sections``, or into ``num``
    (else one per output) equal pieces; ``np.split``'s rules."""
    x = raw_data(ctx.input("X"))
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections")
    if sections:
        outs = torch.tensor_split(
            x, np.cumsum(sections)[:-1].tolist(), dim=axis)
    else:
        num = ctx.attr("num", 0) or len(ctx.output_names("Out"))
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of %s does not divide into %d "
                             "equal pieces" % (axis, tuple(x.shape), num))
        outs = torch.tensor_split(x, num, dim=axis)
    ctx.set_outputs("Out", outs)


@register_op("scatter")
def scatter(ctx):
    """X with the rows at Ids ([N] or [N, 1]) replaced by Updates. A
    negative id counts from the end and an id out of range is dropped,
    as a JAX scatter drops it (it lands in a spare row that is cut off,
    so nothing is read back to the host). Which update wins at a
    repeated id is undefined, here as in JAX."""
    x = raw_data(ctx.input("X"))
    ids = raw_data(ctx.input("Ids")).reshape(-1).long()
    upd = raw_data(ctx.input("Updates"))
    n = x.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    ids = torch.where((ids >= 0) & (ids < n), ids, torch.full_like(ids, n))
    spare = torch.cat([x, torch.zeros_like(x[:1])])
    ctx.set_output("Out", spare.index_put((ids,), upd.to(x.dtype))[:n])


@register_op("one_hot", no_gradient=True)
def one_hot(ctx):
    """X's ids (a trailing dim of 1 dropped) against ``arange(depth)``:
    an id outside [0, depth) gives a row of zeros, as ``jax.nn.one_hot``
    does (``F.one_hot`` would raise, on the card by a device assert)."""
    x = raw_data(ctx.input("X")).long()
    if x.ndim and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    depth = ctx.attr("depth")
    out = x.unsqueeze(-1) == torch.arange(depth, device=x.device)
    ctx.set_output("Out", out.to(tdt(ctx.attr("dtype"), "float32")))


@register_op("pad")
def pad(ctx):
    """X padded by ``paddings`` (before, after of each dim) with
    ``pad_value``."""
    x = raw_data(ctx.input("X"))
    p = ctx.attr("paddings")
    flat = []
    for i in reversed(range(x.ndim)):
        flat += [p[2 * i], p[2 * i + 1]]
    ctx.set_output("Out", F.pad(x, flat, mode="constant",
                                value=ctx.attr("pad_value", 0.0)))


def _infer_slice(op, block):
    xv = block._find_var_recursive(op.input("Input")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    shape = list(xv.shape)
    for a, s, e in zip(op.attr("axes"), op.attr("starts"),
                       op.attr("ends")):
        dim = shape[a]
        if dim is not None and dim >= 0:
            # Python slice semantics, as the lowering slices: negative
            # indices wrap, bounds clamp
            s_ = s + dim if s < 0 else s
            e_ = e + dim if e < 0 else e
            s_ = min(max(s_, 0), dim)
            e_ = min(max(e_, 0), dim)
            shape[a] = max(e_ - s_, 0)
        elif s >= 0 and e >= 0:
            shape[a] = e - s
        else:
            return  # a negative index on an unknown dim
    ov.shape = tuple(shape)
    ov.dtype = xv.dtype


@register_op("slice", infer_shape=_infer_slice)
def slice_op(ctx):
    """Input[starts:ends] along ``axes`` (Python slices: negative bounds
    wrap, bounds past a dim clamp). Out keeps Input's LoD unless dim 0
    is sliced."""
    xv = ctx.input("Input")
    x = raw_data(xv)
    idx = [slice(None)] * x.ndim
    axes = ctx.attr("axes")
    for a, s, e in zip(axes, ctx.attr("starts"), ctx.attr("ends")):
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    if 0 not in {a % x.ndim for a in axes}:
        out = with_lod_of(xv, out)
    ctx.set_output("Out", out)


@register_op("crop")
def crop(ctx):
    """X[offsets : offsets + shape], the shape that of Y when Y is
    given, else the ``shape`` attr."""
    x = raw_data(ctx.input("X"))
    shape = ctx.attr("shape")
    if ctx.has_input("Y"):
        shape = raw_data(ctx.input("Y")).shape
    ctx.set_output("Out", x[tuple(slice(o, o + s) for o, s in
                                  zip(ctx.attr("offsets"), shape))])


@register_op("reverse")
def reverse(ctx):
    ctx.set_output("Out", torch.flip(raw_data(ctx.input("X")),
                                     tuple(ctx.attr("axis"))))


# -- index ops -------------------------------------------------------------------

@register_op("is_empty", no_gradient=True)
def is_empty(ctx):
    """A 0-d bool: whether X has no element."""
    x = raw_data(ctx.input("X"))
    ctx.set_output("Out", constant(np.asarray(prod(x.shape) == 0),
                                   ctx.device))


@register_op("arg_max", no_gradient=True)
def arg_max(ctx):
    """int64 index of the largest element along ``axis`` (the first at
    a tie)."""
    ctx.set_output("Out", torch.argmax(raw_data(ctx.input("X")),
                                       dim=ctx.attr("axis", -1)))


@register_op("arg_min", no_gradient=True)
def arg_min(ctx):
    ctx.set_output("Out", torch.argmin(raw_data(ctx.input("X")),
                                       dim=ctx.attr("axis", -1)))


@register_op("argsort", no_gradient=True)
def argsort(ctx):
    """X sorted ascending along ``axis`` (Out) and the int64 indices
    that sort it (Indices); stable, as ``jnp.argsort`` is: ties keep
    their order."""
    out, idx = torch.sort(raw_data(ctx.input("X")),
                          dim=ctx.attr("axis", -1), stable=True)
    ctx.set_output("Indices", idx)
    ctx.set_output("Out", out)


@register_op("range", no_gradient=True, host=True)
def range_op(ctx):
    """int64 ``arange(Start, End, Step)``, each bound truncated to an
    int. The bounds are read on the host (a host op: a program holding
    it runs on the hybrid path), since they set the output's shape."""
    start, end, step = (int(raw_data(ctx.input(s)).reshape(()))
                        for s in ("Start", "End", "Step"))
    ctx.set_output("Out", constant(np.arange(start, end, step,
                                             dtype=np.int64), ctx.device))
