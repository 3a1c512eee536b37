"""Control flow ops (counterpart of ``paddle_tpu/ops/control_flow_ops.py``):
the LoDTensorArray ops (:76-185), the rank table (:188-240), the
dynamic-RNN layout ops and their grads (:242-528), ``while`` and
``while_grad`` (:530-688), ``conditional_block`` (:691), ``recurrent``
(:707), ``beam_search`` and ``beam_search_decode`` (:759-891), and
``split_lod_tensor`` / ``merge_lod_tensor`` with their grads
(:893-1136). The comparisons and logicals that carry a host value live
in ``math_ops.py``.

A While unrolls while the step is traced, as in the JAX package: its
counters and condition are :class:`ConcreteScalar` values, so the
condition is read on the host at the step's warm-up and capture, and a
captured graph replays the unrolled loop. The trip count is the rank
table's ``max_len``, the feed's ``max_lens``, which is part of the step's
key. A condition that is no concrete scalar (computed from fed data) is
read back (``read_on_host``), which a compiled step refuses: such a
program runs on the per-op path from its first run.

Every path keeps the fixed-capacity layout of the JAX package's jit
path: each time step of ``lod_tensor_to_array`` keeps all n rank-ordered
rows, the live rows a prefix (stable descending-length order), the dead
rows masked zeros that ``array_to_lod_tensor`` never gathers, and
``shrink_rnn_memory`` is the identity. Values and gradients of the real
rows equal the reference's shrinking ``[k_t, F]`` steps, which the JAX
package's per-op path keeps (ROADMAP Queue 3 #34). Selection whose
output size depends on the data (``beam_search``, the LoD split and
merge) stays on the host.

The backward of a While replays the step block once per iteration, from
the latest, over the environment the forward saved before it, and takes
``torch.autograd.grad`` of the block's writes against its reads (the JAX
package's ``jax.vjp``). The forward saves those snapshots only where the
block holds the ``while_grad`` that reads them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.executor import (ConcreteScalar, LoDValue, concrete_value,
                             raw_data, read_on_host, trace_ops, with_lod_of)
from ..core import registry
from ..core.ir import grad_var_name
from ..core.registry import register_op

__all__ = ["LoDTensorArrayVal", "RankTableVal"]


class LoDTensorArrayVal(list):
    """The runtime value of a LOD_TENSOR_ARRAY variable: a list of
    values (tensors or LoD values; None at a slot never written)."""


def _array_of(ctx, slot):
    names = (ctx.op.output(slot) if slot in ctx.op.outputs
             else ctx.op.input(slot))
    name = names[0]
    arr = ctx.env.get(name)
    if arr is None:
        arr = ctx.env[name] = LoDTensorArrayVal()
    return arr, name


def _index_of(ctx, slot="I"):
    """The host index of an array op's ``I``: a concrete counter's value,
    else read back (which a compiled step refuses)."""
    v = ctx.concrete_input(slot)
    cv = concrete_value(v)
    if cv is not None:
        return int(cv)
    return int(read_on_host(v).reshape(-1)[0])


def _zeros_like(v):
    if isinstance(v, LoDValue):
        return LoDValue(torch.zeros_like(v.data), v.lod, max_lens=v.max_lens)
    return torch.zeros_like(raw_data(v))


def _host_offsets(lod_level):
    return [int(o) for o in read_on_host(lod_level)]


def _lod_value(data, host_lod, device):
    """``data`` with host offsets ``host_lod`` (one list a level) as a
    LoD value on ``device``, each level's longest sequence counted."""
    lod = [torch.as_tensor(np.asarray(l, np.int64), device=device)
           for l in host_lod]
    max_lens = [max((b - a for a, b in zip(l, l[1:])), default=0)
                for l in host_lod]
    return LoDValue(data, lod, max_lens=max_lens)


# ---------------------------------------------------------------------------
# LoDTensorArray read / write (reference: tensor_array_read_write_op.cc)

def _write_to_array_grad_maker(op, block, grad_of, no_grad):
    g = grad_of.get(op.output("Out")[0])
    x_name = op.input("X")[0]
    if g is None or x_name in no_grad:
        return None
    return [("write_to_array_grad",
             {"I": list(op.input("I")), "Out@GRAD": [g]},
             {"X@GRAD": [grad_var_name(x_name)]}, {})]


@register_op("write_to_array", grad_maker=_write_to_array_grad_maker,
             stateful_outputs=("Out",))
def write_to_array(ctx):
    x = ctx.input("X")
    i = _index_of(ctx)
    arr, name = _array_of(ctx, "Out")  # Out may be the array X read
    while len(arr) <= i:
        arr.append(None)
    arr[i] = x


@register_op("write_to_array_grad", no_gradient=True)
def write_to_array_grad(ctx):
    arr_g = ctx.input("Out@GRAD")
    i = _index_of(ctx)
    if isinstance(arr_g, list) and i < len(arr_g) and arr_g[i] is not None:
        ctx.set_output("X@GRAD", arr_g[i])


def _read_from_array_grad_maker(op, block, grad_of, no_grad):
    g = grad_of.get(op.output("Out")[0])
    x_name = op.input("X")[0]
    if g is None or x_name in no_grad:
        return None
    return [("read_from_array_grad",
             {"X": [x_name], "I": list(op.input("I")), "Out@GRAD": [g]},
             {"X@GRAD": [grad_var_name(x_name)]}, {})]


@register_op("read_from_array", grad_maker=_read_from_array_grad_maker)
def read_from_array(ctx):
    ctx.set_output("Out", ctx.input("X")[_index_of(ctx)])


@register_op("read_from_array_grad", no_gradient=True)
def read_from_array_grad(ctx):
    """The grad of reading slot i: zeros at every other slot."""
    arr = ctx.input("X")
    out = LoDTensorArrayVal(_zeros_like(e) if e is not None else None
                            for e in arr)
    out[_index_of(ctx)] = ctx.input("Out@GRAD")
    ctx.set_output("X@GRAD", out)


@register_op("lod_array_length", no_gradient=True)
def lod_array_length(ctx):
    n = len(ctx.input("X"))
    ctx.set_output("Out", ConcreteScalar(n, torch.full(
        (1,), n, dtype=torch.int64, device=ctx.device)))


# ---------------------------------------------------------------------------
# the rank table (reference: lod_rank_table_op.cc, lod_rank_table.h)

class RankTableVal(object):
    """A rank table on the device: each sequence's length (original
    order) and the stable descending-length order; the trip count
    ``max_len`` and the token count ``total`` are host ints from the
    feed's LoD signature."""

    __slots__ = ("lengths", "order", "max_len", "total")

    def __init__(self, lengths, order, max_len, total=None):
        self.lengths = lengths
        self.order = order
        self.max_len = int(max_len)
        self.total = total

    def __len__(self):
        return int(self.order.shape[0])


@register_op("lod_rank_table", no_gradient=True)
def lod_rank_table(ctx):
    x = ctx.input("X")
    level = int(ctx.attr("level", 0))
    offs = x.lod[level]
    lengths = offs[1:] - offs[:-1]
    # stable: equal lengths keep their order, as jnp.argsort does
    order = torch.argsort(-lengths, stable=True)
    ml = x.max_lens[level] if level < len(x.max_lens) else None
    if ml is None:
        # offsets the feed did not count: read back (per-op path only)
        ml = int(read_on_host(lengths).max()) if len(lengths) else 0
    total = int(x.data.shape[0]) if level == len(x.lod) - 1 else None
    ctx.set_output("Out", RankTableVal(lengths, order, ml, total=total))


@register_op("max_sequence_len", no_gradient=True)
def max_sequence_len(ctx):
    ml = ctx.input("RankTable").max_len
    ctx.set_output("Out", ConcreteScalar(ml, torch.full(
        (1,), ml, dtype=torch.int64, device=ctx.device)))


def _lod_array_conv_grad_maker(grad_type):
    def maker(op, block, grad_of, no_grad):
        g = grad_of.get(op.output("Out")[0])
        x_name = op.input("X")[0]
        if g is None or x_name in no_grad:
            return None
        return [(grad_type,
                 {"X": [x_name], "RankTable": list(op.input("RankTable")),
                  "Out@GRAD": [g]},
                 {"X@GRAD": [grad_var_name(x_name)]}, {})]
    return maker


def _step_plan(x, table):
    """([T, n] token index, [T, n] alive) of the fixed-capacity steps:
    rank-ordered row r at step t reads token start(order[r]) + t while
    its sequence lasts; a dead row's index is clamped in range."""
    offs = x.lod[-1]
    lengths = offs[1:] - offs[:-1]
    starts = offs[:-1][table.order]
    lens_sorted = lengths[table.order]
    t = torch.arange(table.max_len, device=offs.device)[:, None]
    hi = max(int(x.data.shape[0]) - 1, 0)
    return (starts[None, :] + t).clamp(0, hi), lens_sorted[None, :] > t


def _masked(alive, rows):
    return torch.where(alive.reshape(alive.shape + (1,) * (
        rows.ndim - alive.ndim)), rows, rows.new_zeros(()))


@register_op("lod_tensor_to_array",
             grad_maker=_lod_array_conv_grad_maker("lod_tensor_to_array_grad"))
def lod_tensor_to_array(ctx):
    """Ragged x -> ``max_len`` steps of [n, F] in rank order, dead rows
    zero (one gather for all the steps)."""
    x = ctx.input("X")
    table = ctx.input("RankTable")
    steps = LoDTensorArrayVal()
    if table.max_len:
        idx, alive = _step_plan(x, table)
        steps.extend(_masked(alive, x.data[idx]).unbind(0))
    arr, _ = _array_of(ctx, "Out")
    arr[:] = steps


@register_op("lod_tensor_to_array_grad", no_gradient=True)
def lod_tensor_to_array_grad(ctx):
    """The steps' cotangents added back at their tokens (a dead row adds
    zero at its clamped index)."""
    x = ctx.input("X")
    table = ctx.input("RankTable")
    arr_g = ctx.input("Out@GRAD")
    data = raw_data(x)
    out = torch.zeros_like(data)
    if table.max_len:
        idx, alive = _step_plan(x, table)
        gs = torch.stack([raw_data(g).to(data.dtype) if g is not None
                          else data.new_zeros((len(table),) + data.shape[1:])
                          for g in list(arr_g)[:table.max_len]])
        T = gs.shape[0]
        out.index_add_(0, idx[:T].reshape(-1), _masked(alive[:T], gs)
                       .reshape((-1,) + data.shape[1:]))
    ctx.set_output("X@GRAD", with_lod_of(x, out))


def _token_plan(table, total):
    """For each output token j (original order): its step t_j and its
    rank-ordered row r_j, and the offsets."""
    lengths = table.lengths
    offs = torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])
    j = torch.arange(total, device=lengths.device)
    s = torch.searchsorted(offs, j, right=True) - 1
    inv = torch.argsort(table.order)
    return j - offs[s], inv[s], offs


def _total_tokens(table):
    if table.total is not None:
        return table.total
    return int(read_on_host(table.lengths).sum())


@register_op("array_to_lod_tensor",
             grad_maker=_lod_array_conv_grad_maker("array_to_lod_tensor_grad"))
def array_to_lod_tensor(ctx):
    """[T, n, F] steps back to the ragged layout in the original order."""
    arr = ctx.input("X")
    table = ctx.input("RankTable")
    if not arr:  # every sequence empty: a zero-token output
        offs = torch.zeros((len(table) + 1,), dtype=torch.int64,
                           device=ctx.device)
        ctx.set_output("Out", LoDValue(torch.zeros(
            (0,), device=ctx.device), (offs,), max_lens=(0,)))
        return
    stacked = torch.stack([raw_data(v) for v in arr])
    t_idx, r_idx, offs = _token_plan(table, _total_tokens(table))
    ctx.set_output("Out", LoDValue(stacked[t_idx, r_idx], (offs,),
                                   max_lens=(table.max_len,)))


@register_op("array_to_lod_tensor_grad", no_gradient=True)
def array_to_lod_tensor_grad(ctx):
    """The ragged cotangent scattered into [n, F] steps."""
    x_arr = ctx.input("X")
    table = ctx.input("RankTable")
    g = raw_data(ctx.input("Out@GRAD"))
    t_idx, r_idx, _ = _token_plan(table, int(g.shape[0]))
    buf = g.new_zeros((len(x_arr), len(table)) + tuple(g.shape[1:]))
    buf.index_put_((t_idx, r_idx), g)  # each (t, r) once
    ctx.set_output("X@GRAD", LoDTensorArrayVal(buf.unbind(0)))


def _shrink_memory_grad_maker(op, block, grad_of, no_grad):
    g = grad_of.get(op.output("Out")[0])
    x_name = op.input("X")[0]
    if g is None or x_name in no_grad:
        return None
    return [("shrink_rnn_memory_grad", {"X": [x_name], "Out@GRAD": [g]},
             {"X@GRAD": [grad_var_name(x_name)]}, {})]


@register_op("shrink_rnn_memory", grad_maker=_shrink_memory_grad_maker)
def shrink_rnn_memory(ctx):
    """The reference keeps the first k rows (the sequences alive at step
    i). In the fixed-capacity layout the live rows are the prefix of all
    n, so the shrink is the identity: the rows past k hold memory no
    later op gathers, and their cotangents are zero. A body op that mixes
    rows (a batch mean of the state) would see them: the JAX package's
    per-op path shrinks for real (Queue 3 #34)."""
    ctx.set_output("Out", ctx.input("X"))


@register_op("shrink_rnn_memory_grad", no_gradient=True)
def shrink_rnn_memory_grad(ctx):
    x = raw_data(ctx.input("X"))
    g = raw_data(ctx.input("Out@GRAD"))
    k = g.shape[0]
    if k < x.shape[0]:
        g = torch.cat([g, g.new_zeros((x.shape[0] - k,) + g.shape[1:])])
    ctx.set_output("X@GRAD", g)


@register_op("reorder_lod_tensor_by_rank")
def reorder_lod_tensor_by_rank(ctx):
    """Sequences (rows of a plain tensor) in rank-table order, a gather
    on the device."""
    x = ctx.input("X")
    table = ctx.input("RankTable")
    order = table.order
    if isinstance(x, LoDValue) and x.lod:
        offs = x.lod[-1]
        lens_sorted = (offs[1:] - offs[:-1])[order]
        new_offs = torch.cat([offs.new_zeros(1), torch.cumsum(lens_sorted,
                                                              0)])
        j = torch.arange(int(x.data.shape[0]), device=offs.device)
        r = torch.searchsorted(new_offs, j, right=True) - 1
        src = offs[order[r]] + (j - new_offs[r])
        ml = x.max_lens[-1]
        ctx.set_output("Out", LoDValue(
            x.data[src], (new_offs,),
            max_lens=(ml if ml is not None else table.max_len,)))
    else:
        ctx.set_output("Out", raw_data(x)[order])


# ---------------------------------------------------------------------------
# While (reference: while_op.cc). The condition is read on the host each
# iteration: a concrete scalar while a step is traced, so the loop
# unrolls into the step.

def _sub_reads_writes(sub):
    written, read = [], []
    for op in sub.ops:
        for n in op.output_arg_names:
            if n not in written:
                written.append(n)
        for n in op.input_arg_names:
            if n not in read:
                read.append(n)
    # loop-carried: everything read, then what is only written
    return read + [n for n in written if n not in read], written


def _snap_env(env):
    return {k: (LoDTensorArrayVal(v) if isinstance(v, LoDTensorArrayVal)
                else v) for k, v in env.items()}


def _snap_key(sub_block):
    """Where the forward leaves its snapshots for ``while_grad``: named by
    the body's block index, which survives a clone and a save (the JAX
    package names them by the op's ``id``)."""
    if not isinstance(sub_block, int):
        sub_block = sub_block.idx
    return "@WHILE_SNAP@%d" % sub_block


def _snapshots_read(ctx):
    """Whether the block holding this While holds its ``while_grad``: a
    forward-only program (``clone(for_test)``, a decode) keeps no
    snapshot it never reads."""
    me = ctx.sub_block().idx
    for op in ctx.block.ops:
        if op.type == "while_grad":
            sub = op.attr("sub_block")
            if (sub if isinstance(sub, int) else sub.idx) == me:
                return True
    return False


def _cond_true(env, cond_name):
    v = env[cond_name]
    cv = concrete_value(v)
    if cv is not None:
        return bool(cv)
    return bool(read_on_host(v).reshape(-1)[0])


@register_op("while")
def while_op(ctx):
    sub = ctx.sub_block()
    cond_name = ctx.op.input("Condition")[0]
    max_iters = int(ctx.attr("max_iters", 10000))
    keep = _snapshots_read(ctx)
    snaps, it = [], 0
    while _cond_true(ctx.env, cond_name):
        if keep:
            snaps.append(_snap_env(ctx.env))
        trace_ops(sub, ctx.env, ctx.generator, ctx.device, ctx.value_hook)
        it += 1
        if it >= max_iters:
            raise RuntimeError("while op exceeded max_iters=%d" % max_iters)
    if keep:
        ctx.env[_snap_key(sub)] = snaps


def _is_float_val(v):
    if isinstance(v, LoDTensorArrayVal):
        return len(v) > 0 and all(e is not None and _is_float_val(e)
                                  for e in v)
    data = raw_data(v)
    return isinstance(data, torch.Tensor) and data.is_floating_point()


def _while_grad_maker(op, block, grad_of, no_grad):
    sub = op.attr("sub_block")
    sub = block.program.blocks[sub] if isinstance(sub, int) else sub
    carried, written = _sub_reads_writes(sub)
    outg = [grad_of.get(n) or "" for n in written]
    if not any(outg):
        return None
    gout = []
    for n in carried:
        var = block._find_var_recursive(n)
        ok = (n not in no_grad and var is not None
              and not getattr(var, "stop_gradient", False))
        gout.append(grad_var_name(n) if ok else "")
    if not any(gout):
        return None
    return [("while_grad",
             {"Read": list(carried), "Out": list(written),
              "Out@GRAD": outg},
             {"Read@GRAD": gout},
             {"sub_block": op.attr("sub_block"), "carried": list(carried),
              "written": list(written), "snap_key": _snap_key(sub)})]


registry.lookup_checked("while").grad_maker = _while_grad_maker


def _leaves(v):
    """The floating tensors of a value, one a slot (None where none): a
    tensor or a LoD value's data, an array's elements."""
    if isinstance(v, list):
        return [_leaf(e) for e in v]
    return [_leaf(v)]


def _leaf(v):
    if v is None or isinstance(v, list):
        return None
    data = raw_data(v)
    if isinstance(data, torch.Tensor) and data.is_floating_point():
        return data
    return None


def _rebuild(v, leaves):
    """``v`` with its leaves replaced (a LoD value keeps its offsets)."""
    if isinstance(v, list):
        return LoDTensorArrayVal(
            e if l is None else with_lod_of(e, l) for e, l in zip(v, leaves))
    return v if leaves[0] is None else with_lod_of(v, leaves[0])


def _cot_of(v, leaves):
    """The cotangent of value ``v`` from its leaves' gradients (None where
    a slot got none); None when no slot got one."""
    if all(l is None for l in leaves):
        return None
    if isinstance(v, list):
        return LoDTensorArrayVal(None if l is None else with_lod_of(e, l)
                                 for e, l in zip(v, leaves))
    return with_lod_of(v, leaves[0])


def _add_cot(prev, g):
    """Two cotangents of one value, None meaning zero, summed slot by
    slot."""
    if prev is None:
        return g
    if g is None:
        return prev
    if isinstance(prev, list) or isinstance(g, list):
        prev, g = list(prev), list(g)
        n = max(len(prev), len(g))
        prev += [None] * (n - len(prev))
        g += [None] * (n - len(g))
        return LoDTensorArrayVal(_add_cot(a, b) for a, b in zip(prev, g))
    return with_lod_of(prev, raw_data(prev) + raw_data(g))


@register_op("while_grad", no_gradient=True)
def while_grad(ctx):
    """The reverse sweep: per forward iteration, the latest first, the
    step block replayed on the iteration's snapshot with autograd on, and
    ``torch.autograd.grad`` of its writes against its floating reads at
    the cotangents of the writes (``paddle_tpu/ops/control_flow_ops.py
    :620-688``). A read's cotangent is the sum over the iterations that
    read it; a write's is replaced by what the iteration before sees."""
    sub = ctx.sub_block()
    carried = list(ctx.attr("carried"))
    written = list(ctx.attr("written"))
    snaps = ctx.env.pop(_snap_key(sub), [])
    w_set = set(written)
    cot = {}
    for n, gname in zip(written, ctx.op.input("Out@GRAD")):
        if gname and gname in ctx.env:
            cot[n] = ctx.env[gname]
    for env_t in reversed(snaps):
        env2 = _snap_env(env_t)
        prims = {}
        for n in carried:
            if n not in env_t:
                continue
            leaves = [None if l is None else l.detach().requires_grad_(True)
                      for l in _leaves(env_t[n])]
            if any(l is not None for l in leaves):
                prims[n] = leaves
                env2[n] = _rebuild(env_t[n], leaves)
        with torch.enable_grad():
            trace_ops(sub, env2, None, ctx.device)
        outs, cots = [], []
        for n in written:
            if n not in cot or n not in env2:
                continue
            for o, c in zip(_leaves(env2[n]), _leaves(cot[n])):
                if o is not None and c is not None and o.requires_grad:
                    outs.append(o)
                    cots.append(c.to(o.dtype).reshape(o.shape))
        flat = [l for ls in prims.values() for l in ls if l is not None]
        grads = (torch.autograd.grad(outs, flat, grad_outputs=cots,
                                     allow_unused=True)
                 if outs else [None] * len(flat))
        it = iter(grads)
        new_cot = {}
        for n, ls in prims.items():
            g = _cot_of(env_t[n], [None if l is None else next(it)
                                   for l in ls])
            new_cot[n] = g if n in w_set else _add_cot(cot.get(n), g)
        # a write that no earlier iteration reads has no cotangent there
        cot = {n: g for n, g in new_cot.items() if g is not None}
    for n, gname in zip(carried, ctx.op.output("Read@GRAD")):
        base = ctx.env.get(n)
        if not gname or base is None:
            continue
        g = cot.get(n)
        if isinstance(base, list):
            # zeros at the slots no iteration read, as jax.vjp gives
            g = list(g or [])
            g += [None] * (len(base) - len(g))
            if all(e is None for e in g) and not _is_float_val(base):
                continue
            g = LoDTensorArrayVal(
                e if e is not None or b is None else _zeros_like(b)
                for e, b in zip(g, base))
        elif g is None:
            if not _is_float_val(base):
                continue
            g = _zeros_like(base)
        ctx.env[gname] = g


@register_op("conditional_block", host=True, no_gradient=True)
def conditional_block(ctx):
    """Run the sub-block iff every condition holds
    (reference: conditional_block_op.cc); a host op."""
    conds = ctx.inputs("Cond") if ctx.has_input("Cond") else ctx.inputs("X")
    if all(bool(read_on_host(c).reshape(-1)[0]) for c in conds):
        trace_ops(ctx.sub_block(), ctx.env, ctx.generator, ctx.device,
                  ctx.value_hook)


# ---------------------------------------------------------------------------
# StaticRNN (reference: recurrent_op.cc): the step block run once a time
# step. The steps are taken by ``unbind``: indexing xs[t] in the loop
# would cost O(T^2) in the backward pass (Queue 3 #32).

@register_op("recurrent")
def recurrent(ctx):
    """Slots as set up by ``layers.StaticRNN``: X the sequences (time on
    axis 0), Boot the initial memories, P the outer vars the block reads;
    Out the stacked step outputs, FinalMems the last memories. Everything
    flows through slots, so the generic grad replays the whole loop under
    autograd."""
    sub = ctx.sub_block()
    x_inner = list(ctx.attr("x_inner", []))
    mem_pre = list(ctx.attr("mem_pre", []))
    mem_post = list(ctx.attr("mem_post", []))
    p_names = list(ctx.attr("p_names", []))
    out_inner = list(ctx.attr("out_inner", []))
    is_reverse = bool(ctx.attr("is_reverse", False))
    xs = [raw_data(ctx.input("X", i)) for i in range(len(x_inner))]
    steps = [x.flip(0).unbind(0) if is_reverse else x.unbind(0) for x in xs]
    mems = [raw_data(ctx.input("Boot", i)) for i in range(len(mem_pre))]
    params = {p_names[i]: ctx.concrete_input("P", i)
              for i in range(len(p_names))}
    outs = [[] for _ in out_inner]
    for t in range(len(steps[0]) if steps else 0):
        env = dict(params)
        env.update(zip(x_inner, (s[t] for s in steps)))
        env.update(zip(mem_pre, mems))
        trace_ops(sub, env, ctx.generator, ctx.device)
        mems = [raw_data(env[p]) for p in mem_post]
        for o, n in zip(outs, out_inner):
            o.append(raw_data(env[n]))
    for i, o in enumerate(outs):
        v = torch.stack(o)
        ctx.set_output("Out", v.flip(0) if is_reverse else v, idx=i)
    for i, m in enumerate(mems):
        ctx.set_output("FinalMems", m, idx=i)


# ---------------------------------------------------------------------------
# beam search, on the host (reference: beam_search_op.cc,
# beam_search_decode_op.cc)

@register_op("beam_search", host=True, no_gradient=True)
def beam_search(ctx):
    """One step of beam expansion. pre_ids: [num_prefixes, 1], the last
    token of each live prefix, with LoD [[source -> prefix], [prefix ->
    1]]; ids / scores: [num_prefixes, K] candidates. Keeps the best
    ``beam_size`` of each source (Python's stable sort by score, then by
    parent); level 1 of the output LoD counts the items each prefix gave,
    the parent links ``beam_search_decode`` walks back."""
    pre_ids_v = ctx.input("pre_ids")
    ids = read_on_host(ctx.input("ids"))
    scores = read_on_host(ctx.input("scores"))
    beam_size = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    src_offs = _host_offsets(pre_ids_v.lod[0])
    pre_ids = read_on_host(pre_ids_v).reshape(-1)
    sel_ids, sel_scores, sel_parent = [], [], []
    for s in range(len(src_offs) - 1):
        cands = []
        for p in range(src_offs[s], src_offs[s + 1]):
            if pre_ids[p] == end_id:
                # an ended prefix carries itself on once
                cands.append((float(scores[p, 0]), end_id, p))
                continue
            for k in range(ids.shape[1]):
                cands.append((float(scores[p, k]), int(ids[p, k]), p))
        cands.sort(key=lambda c: -c[0])
        chosen = sorted(cands[:beam_size], key=lambda c: c[2])
        for sc, tid, p in chosen:
            sel_scores.append(sc)
            sel_ids.append(tid)
            sel_parent.append(p)
    counts = np.bincount(np.asarray(sel_parent, np.int64),
                         minlength=ids.shape[0])[:ids.shape[0]]
    lvl1 = [0] + [int(c) for c in np.cumsum(counts)]
    lvl0 = [0] + [lvl1[src_offs[s + 1]] for s in range(len(src_offs) - 1)]
    dev = ctx.device
    ctx.set_output("selected_ids", _lod_value(torch.as_tensor(
        np.asarray(sel_ids, np.int64).reshape(-1, 1), device=dev),
        [lvl0, lvl1], dev))
    ctx.set_output("selected_scores", _lod_value(torch.as_tensor(
        np.asarray(sel_scores, np.float32).reshape(-1, 1), device=dev),
        [lvl0, lvl1], dev))


@register_op("beam_search_decode", host=True, no_gradient=True)
def beam_search_decode(ctx):
    """The per-step beam arrays walked back into whole sentences: for
    each source, each item of the last step, its tokens from the first
    step on; every token of a sentence carries the sentence's last
    score."""
    ids_arr = ctx.input("Ids")
    scores_arr = ctx.input("Scores")
    if not ids_arr:
        raise ValueError("beam_search_decode: empty Ids array")
    steps = []
    for v, sc in zip(ids_arr, scores_arr):
        steps.append((read_on_host(v).reshape(-1),
                      read_on_host(sc).reshape(-1),
                      _host_offsets(v.lod[0]),
                      _host_offsets(v.lod[1]) if len(v.lod) > 1 else None))
    last_ids, last_sc, last_lvl0, _ = steps[-1]
    sentences, sent_scores, per_src = [], [], []
    for s in range(len(steps[0][2]) - 1):
        for item in range(last_lvl0[s], last_lvl0[s + 1]):
            toks, it = [], item
            for t in range(len(steps) - 1, -1, -1):
                toks.append(int(steps[t][0][it]))
                if t > 0 and steps[t][3] is not None:
                    # the parent: the prefix of step t - 1 whose level-1
                    # range holds the item
                    it = int(np.searchsorted(steps[t][3], it,
                                             side="right") - 1)
            sentences.append(toks[::-1])
            sent_scores.append(float(last_sc[item]))
        per_src.append(last_lvl0[s + 1] - last_lvl0[s])
    lens = [len(t) for t in sentences]
    lvl1 = [0] + [int(c) for c in np.cumsum(lens)]
    lvl0 = [0] + [int(c) for c in np.cumsum(per_src)]
    flat = np.asarray([w for t in sentences for w in t], np.int64)
    flat_sc = np.asarray([sc for n, sc in zip(lens, sent_scores)
                          for _ in range(n)], np.float32)
    dev = ctx.device
    ctx.set_output("SentenceIds", _lod_value(torch.as_tensor(
        flat.reshape(-1, 1), device=dev), [lvl0, lvl1], dev))
    ctx.set_output("SentenceScores", _lod_value(torch.as_tensor(
        flat_sc.reshape(-1, 1), device=dev), [lvl0, lvl1], dev))


# ---------------------------------------------------------------------------
# split_lod_tensor / merge_lod_tensor, the row-masked IfElse (reference:
# split_lod_tensor_op.cc, merge_lod_tensor_op.cc). The dense outputs keep
# X's row capacity: the chosen rows stably compacted to the front, zeros
# after; merge inverts by mask position. A LoD input splits whole
# sequences on the host's copy of its offsets (the per-op path).

def _mask_bool(v):
    return raw_data(v).reshape(-1) != 0


def _compact_rows(x, keep):
    """The rows of ``x`` where ``keep``, stably first; a zero tail."""
    keep_i = keep.to(torch.int64)
    order = torch.argsort(1 - keep_i, stable=True)
    alive = torch.arange(x.shape[0], device=x.device) < keep_i.sum()
    return _masked(alive, x[order])


def _check_lod_level(op_name, x, level):
    """Only level 0 of a one-level LoD is implemented; a wrong split at
    another level would route sequences wrongly, so refuse."""
    if int(level or 0) != 0 or len(x.lod) > 1:
        raise NotImplementedError(
            "%s: only level=0 on single-level LoD is implemented "
            "(got level=%r, lod depth %d). reference: "
            "operators/split_lod_tensor_op.cc GetSubLoDAndAbsoluteOffset "
            "handles nested levels." % (op_name, level, len(x.lod)))


def _seq_rows(offs, mask):
    """(rows, host LoD) of the true and of the false sequences."""
    parts = {True: ([], [0]), False: ([], [0])}
    for i in range(len(offs) - 1):
        rows, lod = parts[bool(mask[i])]
        rows.extend(range(offs[i], offs[i + 1]))
        lod.append(lod[-1] + offs[i + 1] - offs[i])
    return parts[True], parts[False]


def _split_lod_host(x, mask, device):
    offs = _host_offsets(x.lod[0])
    data = raw_data(x)
    outs = []
    for rows, lod in _seq_rows(offs, read_on_host(mask)):
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=data.device)
        outs.append(_lod_value(data[idx], [lod], device))
    return outs


def _merge_lod_host(x, mask, t, f):
    """Whole sequences put back in order by the mask (the inverse of
    :func:`_split_lod_host`)."""
    offs = _host_offsets(x.lod[0])
    m = read_on_host(mask)
    td, fd = raw_data(t), raw_data(f)
    src, ti, fi = [], 0, 0
    for i in range(len(offs) - 1):
        n = offs[i + 1] - offs[i]
        if m[i]:
            src.append((True, ti, n))
            ti += n
        else:
            src.append((False, fi, n))
            fi += n
    parts = [(td if side else fd)[a:a + n] for side, a, n in src]
    data = (torch.cat(parts) if parts
            else td.new_zeros((0,) + tuple(td.shape[1:])))
    return LoDValue(data, x.lod, max_lens=x.max_lens)


def _infer_split_lod(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    for slot in ("OutTrue", "OutFalse"):
        ov = block._find_var_recursive(op.output(slot)[0])
        if None in (xv, ov) or xv.shape is None:
            continue
        ov.shape = tuple(xv.shape)
        ov.dtype = xv.dtype
        ov.lod_level = getattr(xv, "lod_level", 0)


def _split_lod_grad_maker(op, block, grad_of, no_grad):
    gt = grad_of.get(op.output("OutTrue")[0])
    gf = grad_of.get(op.output("OutFalse")[0])
    x_name = op.input("X")[0]
    if (gt is None and gf is None) or x_name in no_grad:
        return None
    inputs = {"Mask": list(op.input("Mask")), "X": [x_name]}
    if gt is not None:
        inputs["OutTrue@GRAD"] = [gt]
    if gf is not None:
        inputs["OutFalse@GRAD"] = [gf]
    return [("split_lod_tensor_grad", inputs,
             {"X@GRAD": [grad_var_name(x_name)]}, dict(op.attrs))]


@register_op("split_lod_tensor", infer_shape=_infer_split_lod,
             grad_maker=_split_lod_grad_maker)
def split_lod_tensor(ctx):
    x = ctx.input("X")
    mask = _mask_bool(ctx.input("Mask"))
    if isinstance(x, LoDValue) and x.lod:
        _check_lod_level("split_lod_tensor", x, ctx.attr("level", 0))
        out_t, out_f = _split_lod_host(x, mask, ctx.device)
        ctx.set_output("OutTrue", out_t)
        ctx.set_output("OutFalse", out_f)
        return
    data = raw_data(x)
    if mask.shape[0] == 1 and data.shape[0] != 1:
        # one condition over many rows (the classic if / else): both
        # branches see all of X, and merge takes one of them whole
        ctx.set_output("OutTrue", data)
        ctx.set_output("OutFalse", data)
        return
    if mask.shape[0] != data.shape[0]:
        raise ValueError(
            "split_lod_tensor: mask has %d rows but X has %d — the mask "
            "must be a per-row boolean column (or a single scalar)"
            % (mask.shape[0], data.shape[0]))
    ctx.set_output("OutTrue", _compact_rows(data, mask))
    ctx.set_output("OutFalse", _compact_rows(data, ~mask))


@register_op("split_lod_tensor_grad", no_gradient=True)
def split_lod_tensor_grad(ctx):
    mask = _mask_bool(ctx.input("Mask"))
    x = ctx.input("X")
    gt = ctx.input("OutTrue@GRAD") if ctx.has_input("OutTrue@GRAD") else None
    gf = (ctx.input("OutFalse@GRAD") if ctx.has_input("OutFalse@GRAD")
          else None)
    if isinstance(x, LoDValue) and x.lod:
        # the branches' ragged cotangents merged back by the mask
        zeros = _split_lod_host(_zeros_like(x), mask, ctx.device)
        ctx.set_output("X@GRAD", _merge_lod_host(
            x, mask, gt if gt is not None else zeros[0],
            gf if gf is not None else zeros[1]))
        return
    ref = raw_data(gt if gt is not None else gf)
    zt = raw_data(gt) if gt is not None else torch.zeros_like(ref)
    zf = raw_data(gf) if gf is not None else torch.zeros_like(ref)
    if mask.shape[0] == 1 and ref.shape[0] != 1:
        # the fan-out of the one-condition split: the branches' sum
        ctx.set_output("X@GRAD", zt + zf)
        return
    ctx.set_output("X@GRAD", _merge_rows(zt, zf, mask))


def _merge_rows(t, f, mask):
    if mask.shape[0] == 1 and t.shape[0] != 1:
        # one condition: one branch whole
        return torch.where(mask.reshape((1,) + (1,) * (t.ndim - 1)), t, f)
    mask_i = mask.to(torch.int64)
    pos_t = (torch.cumsum(mask_i, 0) - 1).clamp(0, max(t.shape[0] - 1, 0))
    pos_f = (torch.cumsum(1 - mask_i, 0) - 1).clamp(0, max(f.shape[0] - 1,
                                                            0))
    return torch.where(mask.reshape((-1,) + (1,) * (t.ndim - 1)), t[pos_t],
                       f[pos_f])


def _infer_merge_lod(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    tv = block._find_var_recursive(op.input("InTrue")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if ov is None:
        return
    mv = block._find_var_recursive(op.input("Mask")[0])
    rows = mv.shape[0] if mv is not None and mv.shape else None
    if tv is not None and tv.shape is not None:
        if rows == 1 and tv.shape[0] not in (None, 1):
            # one condition: the output keeps the branches' rows
            rows = tv.shape[0]
        ov.shape = ((rows,) + tuple(tv.shape[1:]) if rows is not None
                    else tuple(tv.shape))
        ov.dtype = tv.dtype
    if xv is not None:
        ov.lod_level = getattr(xv, "lod_level", 0)


def _merge_lod_grad_maker(op, block, grad_of, no_grad):
    g = grad_of.get(op.output("Out")[0])
    if g is None:
        return None
    outputs = {}
    for slot in ("InTrue", "InFalse"):
        names = op.input(slot)
        if names and names[0] not in no_grad:
            v = block._find_var_recursive(names[0])
            if v is not None and not v.stop_gradient:
                outputs[slot + "@GRAD"] = [grad_var_name(names[0])]
    if not outputs:
        return None
    return [("merge_lod_tensor_grad",
             {"Mask": list(op.input("Mask")), "X": list(op.input("X")),
              "Out@GRAD": [g]},
             outputs, dict(op.attrs))]


@register_op("merge_lod_tensor", infer_shape=_infer_merge_lod,
             grad_maker=_merge_lod_grad_maker)
def merge_lod_tensor(ctx):
    """Out[i] = InTrue[the rank of i among the true rows] where Mask[i],
    else InFalse[its rank among the false rows]."""
    mask = _mask_bool(ctx.input("Mask"))
    t, f, x = ctx.input("InTrue"), ctx.input("InFalse"), ctx.input("X")
    if isinstance(x, LoDValue) and x.lod:
        _check_lod_level("merge_lod_tensor", x, ctx.attr("level", 0))
        ctx.set_output("Out", _merge_lod_host(x, mask, t, f))
        return
    ctx.set_output("Out", _merge_rows(raw_data(t), raw_data(f), mask))


@register_op("merge_lod_tensor_grad", no_gradient=True)
def merge_lod_tensor_grad(ctx):
    mask = _mask_bool(ctx.input("Mask"))
    gv = ctx.input("Out@GRAD")
    x = ctx.input("X")
    if isinstance(x, LoDValue) and x.lod:
        gt, gf = _split_lod_host(LoDValue(raw_data(gv), x.lod,
                                          max_lens=x.max_lens), mask,
                                 ctx.device)
        ctx.set_output("InTrue@GRAD", gt)
        ctx.set_output("InFalse@GRAD", gf)
        return
    g = raw_data(gv)
    if mask.shape[0] == 1 and g.shape[0] != 1:
        # one condition: the cotangent goes to the chosen branch alone
        sel = mask.reshape((1,) + (1,) * (g.ndim - 1))
        ctx.set_output("InTrue@GRAD", torch.where(sel, g, g.new_zeros(())))
        ctx.set_output("InFalse@GRAD", torch.where(sel, g.new_zeros(()), g))
        return
    ctx.set_output("InTrue@GRAD", _compact_rows(g, mask))
    ctx.set_output("InFalse@GRAD", _compact_rows(g, ~mask))
