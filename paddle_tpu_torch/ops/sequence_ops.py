"""Sequence ops over ragged (LoD) batches (counterpart of the matching
part of ``paddle_tpu/ops/sequence_ops.py``: the ragged <-> padded
helpers :41-116, ``sequence_pool`` :177, ``lstm`` :547 and ``gru`` :729).

A ragged input is a ``LoDValue``: the sequences concatenated along dim 0,
int64 offsets on the device and each level's longest sequence as a host
int. Two families, as in the JAX package:

1. ``sequence_pool`` reduces each segment of the concatenated rows
   (``index_add`` / ``scatter_reduce`` by segment id), with no padding;
2. ``lstm`` and ``gru`` pad the batch to ``[num_seqs, max_len, ...]``
   (``max_len`` from the feed, never read back from the device), run the
   recurrence over time with a mask, and scatter the result back to the
   ragged rows. ``is_reverse`` reverses each sequence within its valid
   prefix before and after; the recurrence always runs forward in t.

Under ``lstm_impl="pallas"`` (an op's own ``lstm_impl`` attr, else
``FLAGS.lstm_impl``) the recurrence goes to the fused kernels
(``kernels/fused_lstm.py``, ``kernels/fused_gru.py``) for the population
the JAX package sends to its Pallas kernels: the standard activations,
no peepholes, and a hidden width that is a multiple of 128. Every other
op runs the plain time loop.

Not ported yet (later slices): the stride windows of ``sequence_pool``,
nested (2-level) LoD in the recurrent ops, and the other sequence ops
of the JAX module.
"""
from __future__ import annotations

import torch

from ..core.executor import LoDValue, raw_data, with_lod_of
from ..core.registry import register_op
from ..flags import FLAGS
from ..kernels.fused_gru import fused_gru
from ..kernels.fused_lstm import fused_lstm

__all__ = ["lod_to_padded", "lstm_impl", "padded_to_lod", "reverse_padded",
           "segment_ids", "seq_offsets", "static_max_len"]


# ---------------------------------------------------------------------------
# ragged <-> padded helpers

def seq_offsets(v, level=-1):
    """The offsets of ``v``'s ``level`` (the innermost by default)."""
    if not isinstance(v, LoDValue) or not v.lod:
        raise ValueError(
            "sequence op input must carry LoD: feed a LoDTensor (built "
            "e.g. with build_lod_tensor, or by a DataFeeder field with "
            "lod_level > 0)")
    return v.lod[level]


def static_max_len(v, level=-1):
    """The pad length of the recurrent ops: the level's longest sequence,
    counted on the host when the value was fed."""
    lv = level if level >= 0 else len(v.lod) + level
    ml = v.max_lens[lv] if v.max_lens else None
    if ml is None:
        raise ValueError(
            "sequence op needs the longest sequence of its input, counted "
            "at feed time: feed the input as a LoDTensor")
    return int(ml)


def segment_ids(offsets, total):
    """[0, 2, 5] -> [0, 0, 1, 1, 1]; an empty sequence skips its id. The
    marks at ``offsets[1:-1]`` go into ``total + 1`` slots, and the last,
    which only a trailing empty sequence marks, is dropped."""
    marks = torch.zeros((total + 1,), dtype=offsets.dtype,
                        device=offsets.device)
    marks.index_add_(0, offsets[1:-1], torch.ones_like(offsets[1:-1]))
    return torch.cumsum(marks[:total], dim=0)


def _expand_mask(mask, ref):
    """A mask broadcast against the trailing feature dims of ``ref``."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ref.ndim - mask.ndim))


def lod_to_padded(data, offsets, max_len):
    """Concatenated ``[total, ...]`` -> padded ``[num_seqs, max_len,
    ...]`` (zeros past each sequence's end) and its bool mask."""
    lengths = offsets[1:] - offsets[:-1]
    t = torch.arange(max_len, dtype=offsets.dtype, device=offsets.device)
    mask = t[None, :] < lengths[:, None]
    idx = torch.where(mask, offsets[:-1, None] + t[None, :],
                      torch.zeros_like(t)[None, :])
    padded = data[idx]
    padded = torch.where(_expand_mask(mask, padded), padded,
                         torch.zeros((), dtype=padded.dtype,
                                     device=padded.device))
    return padded, mask


def reverse_padded(padded, mask, offsets, max_len):
    """Reverse each sequence of ``padded`` within its valid prefix."""
    lengths = offsets[1:] - offsets[:-1]
    t = torch.arange(max_len, dtype=offsets.dtype, device=offsets.device)
    ridx = torch.where(mask, lengths[:, None] - 1 - t[None, :],
                       torch.zeros_like(t)[None, :])
    ridx = ridx.reshape(tuple(ridx.shape) + (1,) * (padded.ndim - 2))
    return torch.gather(padded, 1, ridx.expand(padded.shape))


def padded_to_lod(padded, offsets, total):
    """Padded ``[num_seqs, T, ...]`` -> concatenated ``[total, ...]``: the
    valid steps scatter to their rows, the padding to an extra row
    ``total``, which is dropped (the JAX scatter's ``mode="drop"``)."""
    n, T = padded.shape[0], padded.shape[1]
    lengths = offsets[1:] - offsets[:-1]
    t = torch.arange(T, dtype=offsets.dtype, device=offsets.device)
    mask = t[None, :] < lengths[:, None]
    idx = torch.where(mask, offsets[:-1, None] + t[None, :],
                      torch.full_like(t, total)[None, :])
    flat = padded.reshape((n * T,) + tuple(padded.shape[2:]))
    out = torch.zeros((total + 1,) + tuple(padded.shape[2:]),
                      dtype=padded.dtype, device=padded.device)
    return out.index_copy(0, idx.reshape(-1), flat)[:total]


# ---------------------------------------------------------------------------
# sequence_pool

def _segment_sum(data, sid, nseg):
    out = torch.zeros((nseg,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, sid, data)


def _segment_pool(data, sid, nseg, lengths, ptype):
    """SUM / AVERAGE / SQRT / MAX over the segments (``lengths``: float
    sizes ``[nseg]``). MAX zeroes empty segments, as the reference does
    (math/sequence_pooling.cc)."""
    if ptype == "MAX":
        out = torch.zeros((nseg,) + tuple(data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        idx = sid.reshape((-1,) + (1,) * (data.ndim - 1)).expand(data.shape)
        # include_self=False: an empty segment keeps its 0
        return out.scatter_reduce(0, idx, data, "amax", include_self=False)
    out = _segment_sum(data, sid, nseg)
    safe = _expand_mask(torch.clamp(lengths, min=1), out)
    if ptype == "SUM":
        return out
    if ptype == "AVERAGE":
        return out / safe
    if ptype == "SQRT":
        return out / torch.sqrt(safe)
    raise ValueError("unknown pooltype %r" % ptype)


@register_op("sequence_pool")
def sequence_pool(ctx):
    """Pool each sequence to one row, dropping the innermost LoD level:
    SUM, AVERAGE (or AVG), SQRT, MAX (with ``MaxIndex``, the first row of
    each maximum), LAST and FIRST; an empty sequence pools to zeros."""
    x = ctx.input("X")
    data = raw_data(x)
    offs = seq_offsets(x)
    if int(ctx.attr("stride", -1) or -1) > 0:
        raise NotImplementedError(
            "sequence_pool stride windows are not ported to "
            "paddle_tpu_torch yet")
    ptype = str(ctx.attr("pooltype", "AVERAGE")).upper()
    ptype = {"AVG": "AVERAGE"}.get(ptype, ptype)
    n = offs.shape[0] - 1
    total = data.shape[0]
    lengths = (offs[1:] - offs[:-1]).to(data.dtype)
    nonempty = (lengths > 0).reshape((n,) + (1,) * (data.ndim - 1))
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if ptype == "LAST":
        out = torch.where(nonempty, data[torch.clamp(offs[1:] - 1, min=0)],
                          zero)
    elif ptype == "FIRST":
        out = torch.where(nonempty,
                          data[torch.clamp(offs[:-1], max=total - 1)], zero)
    else:
        sid = segment_ids(offs, total)
        out = _segment_pool(data, sid, n, lengths, ptype)
        if ptype == "MAX" and ctx.op.output("MaxIndex"):
            pos = torch.arange(total, dtype=torch.int64, device=data.device)
            pos = _expand_mask(pos, data).expand(data.shape)
            best = out[sid] == data
            cand = torch.where(best, pos, torch.full_like(pos, total))
            idx = torch.full(out.shape, torch.iinfo(torch.int32).max,
                             dtype=torch.int64, device=data.device)
            sidx = _expand_mask(sid, data).expand(data.shape)
            idx = idx.scatter_reduce(0, sidx, cand, "amin",
                                     include_self=False)
            ctx.set_output("MaxIndex", idx.to(torch.int32))
    if len(x.lod) > 1:
        out = LoDValue(out, x.lod[:-1], max_lens=x.max_lens[:-1])
    ctx.set_output("Out", out)


# ---------------------------------------------------------------------------
# recurrent ops

_ACT = {
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
    "identity": lambda v: v, "": lambda v: v,
}


def lstm_impl(op_choice=None):
    """The recurrent lowering, 'scan' or 'pallas': the op's ``lstm_impl``
    attr (set by a config that opts its program in), else
    ``FLAGS.lstm_impl``."""
    impl = op_choice or FLAGS.lstm_impl
    if impl not in ("scan", "pallas"):
        raise ValueError("lstm_impl must be 'scan' or 'pallas', got %r"
                         % (impl,))
    return impl


def _ragged_time_major(x, rev):
    """The op's ragged input as time-major padded ``xs [T, n, F]`` and
    mask ``[T, n]``, reversed within each sequence when ``rev``; also
    returns what :func:`_back_to_lod` needs."""
    data = raw_data(x)
    offs = seq_offsets(x)
    ml = static_max_len(x)
    padded, mask = lod_to_padded(data, offs, ml)
    if rev:
        padded = reverse_padded(padded, mask, offs, ml)
    return (padded.transpose(0, 1), mask.transpose(0, 1),
            (mask, offs, ml, data.shape[0]))


def _back_to_lod(x, seqs, rev, layout):
    """Time-major ``[T, n, D]`` results -> ragged rows with ``x``'s LoD."""
    mask, offs, ml, total = layout
    seqs = seqs.transpose(0, 1)
    if rev:
        seqs = reverse_padded(seqs, mask, offs, ml)
    return with_lod_of(x, padded_to_lod(seqs, offs, total))


@register_op("lstm")
def lstm(ctx):
    """Whole-sequence LSTM over a ragged batch. Input ``[total, 4D]`` is
    the pre-projected gate input (gate slabs c~, i, f, o); Weight
    ``[D, 4D]`` the recurrent projection; Bias ``[1, 4D]``, or ``[1, 7D]``
    with the peephole weights (i, f, o) after it."""
    x = ctx.input("Input")
    w = raw_data(ctx.input("Weight"))
    bias = raw_data(ctx.input("Bias"))
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    D = w.shape[0]
    rev = bool(ctx.attr("is_reverse", False))
    acts = (ctx.attr("gate_activation", "sigmoid"),
            ctx.attr("cell_activation", "tanh"),
            ctx.attr("candidate_activation", "tanh"))
    g_act, c_act, cand_act = (_ACT[a] for a in acts)

    xs, ms, layout = _ragged_time_major(x, rev)
    n = xs.shape[1]
    # peepholes only with a bias that holds them: [1, 7D]
    use_peep = (bool(ctx.attr("use_peepholes", True)) and bias is not None
                and bias.numel() >= 7 * D)
    if bias is not None:
        b = bias.reshape(-1)
        xs = xs + b[:4 * D]
        if use_peep:
            w_ic, w_fc, w_oc = b[4 * D:5 * D], b[5 * D:6 * D], b[6 * D:7 * D]
    h = raw_data(h0) if h0 is not None else xs.new_zeros((n, D))
    c = raw_data(c0) if c0 is not None else xs.new_zeros((n, D))
    mf = ms.to(xs.dtype)

    if (lstm_impl(ctx.attr("lstm_impl")) == "pallas" and not use_peep
            and acts == ("sigmoid", "tanh", "tanh") and D % 128 == 0):
        hs, cs = fused_lstm(xs, w, h, c, mf)
    else:
        hs, cs = [], []
        for t in range(xs.shape[0]):
            g = xs[t] + h @ w
            c_t, i_t, f_t, o_t = g[:, :D], g[:, D:2 * D], \
                g[:, 2 * D:3 * D], g[:, 3 * D:]
            if use_peep:
                i_t = i_t + c * w_ic
                f_t = f_t + c * w_fc
            c_new = g_act(f_t) * c + g_act(i_t) * cand_act(c_t)
            if use_peep:
                o_t = o_t + c_new * w_oc
            h_new = g_act(o_t) * c_act(c_new)
            m = mf[t][:, None]
            h = h_new * m + h * (1 - m)
            c = c_new * m + c * (1 - m)
            hs.append(h)
            cs.append(c)
        hs, cs = torch.stack(hs), torch.stack(cs)
    ctx.set_output("Hidden", _back_to_lod(x, hs, rev, layout))
    ctx.set_output("Cell", _back_to_lod(x, cs, rev, layout))


@register_op("gru")
def gru(ctx):
    """Whole-sequence GRU over a ragged batch. Input ``[total, 3D]``
    pre-projected (slabs u, r, c); Weight ``[D, 3D]``: ``[D, 2D]`` update
    and reset, then ``[D, D]`` candidate; Bias ``[1, 3D]``."""
    x = ctx.input("Input")
    w = raw_data(ctx.input("Weight"))
    bias = ctx.input("Bias")
    h0 = ctx.input("H0")
    D = w.shape[0]
    rev = bool(ctx.attr("is_reverse", False))
    acts = (ctx.attr("gate_activation", "sigmoid"),
            ctx.attr("activation", "tanh"))
    g_act, cand_act = (_ACT[a] for a in acts)

    xs, ms, layout = _ragged_time_major(x, rev)
    n = xs.shape[1]
    if bias is not None:
        xs = xs + raw_data(bias).reshape(-1)
    h = raw_data(h0) if h0 is not None else xs.new_zeros((n, D))
    mf = ms.to(xs.dtype)

    if (lstm_impl(ctx.attr("lstm_impl")) == "pallas" and D % 128 == 0
            and acts == ("sigmoid", "tanh")):
        hs = fused_gru(xs, w, h, mf)
    else:
        w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
        hs = []
        for t in range(xs.shape[0]):
            ur = g_act(xs[t][:, :2 * D] + h @ w_ur)
            u, r = ur[:, :D], ur[:, D:]
            cand = cand_act(xs[t][:, 2 * D:] + (r * h) @ w_c)
            h_new = (1.0 - u) * h + u * cand
            m = mf[t][:, None]
            h = h_new * m + h * (1 - m)
            hs.append(h)
        hs = torch.stack(hs)
    ctx.set_output("Hidden", _back_to_lod(x, hs, rev, layout))
