"""Sequence ops over ragged (LoD) batches (counterpart of
``paddle_tpu/ops/sequence_ops.py``: the ragged <-> padded helpers
:41-116, ``sequence_pool`` :177 with its stride windows :139-174,
``sequence_softmax`` :221, ``sequence_expand`` :239, ``sequence_concat``
:272, ``sequence_reshape`` :308, ``lod_reset`` :324, the host ops
``sequence_slice`` :346, ``sequence_erase`` :380, ``ctc_align`` :401 and
``chunk_eval`` :1034, ``sequence_conv`` :429, ``context_project`` :467,
``row_conv`` :517, ``lstm`` :547, ``lstmp`` :644, ``gru`` :729,
``lstm_unit`` :787, ``gru_unit`` :805, ``linear_chain_crf`` :842 and
``crf_decoding`` :898 over ``_crf_pieces`` :831, ``warpctc`` :946,
``uniform_random_int`` :975, ``nce_core`` :986, ``kmax_seq_score``
:1109, ``sub_nested_seq`` :1146, ``sequence_reverse`` :1193,
``simple_rnn`` :1208 and ``lambda_rank_cost`` :1247).

A ragged input is a ``LoDValue``: the sequences concatenated along dim 0,
int64 offsets on the device and each level's longest sequence as a host
int. The families, as in the JAX package:

1. segment ops (``sequence_pool``, ``sequence_softmax``,
   ``sequence_expand``) reduce or gather over the concatenated rows by
   segment id (``index_add`` / ``scatter_reduce``), with no padding;
2. scan ops (``lstm``, ``lstmp``, ``gru``, ``simple_rnn``, the context
   windows, the CRF, CTC, ``sequence_concat``, ``sequence_reverse``,
   ``kmax_seq_score``, ``lambda_rank_cost``) pad the batch to
   ``[num_seqs, max_len, ...]`` (``max_len`` from the feed, never read
   back from the device), work over time with a mask, and scatter the
   result back to the ragged rows. ``is_reverse`` reverses each sequence
   within its valid prefix before and after; the recurrence always runs
   forward in t. A nested (2-level) input runs on its innermost level
   and keeps the outer one;
3. host ops (``sequence_slice``, ``sequence_erase``, ``ctc_align``,
   ``chunk_eval``, and ``sequence_pool`` with a stride) have outputs
   whose size depends on the offsets' values: they read them on the host
   and run between the compiled segments of the hybrid path. Their
   arithmetic on floats stays in torch, so the generic grad replays it.

Each output's longest sequence comes from its inputs' host ``max_lens``
as the JAX ops compute it; where the JAX op leaves it unknown
(``lod_reset`` from a plain ``Y``, the stride windows), a scan op reads
it from the offsets on the per-op path and raises the JAX package's
``jit`` message inside a compiled step (:func:`static_max_len`). New
offsets are int64, the index type of torch, where the JAX ops make
int32 ones (the values equal; ROADMAP.md Queue 3 #26).

Under ``lstm_impl="pallas"`` (an op's own ``lstm_impl`` attr, else
``FLAGS.lstm_impl``) the ``lstm`` and ``gru`` recurrences go to the
fused kernels (``kernels/fused_lstm.py``, ``kernels/fused_gru.py``) for
the population the JAX package sends to its Pallas kernels: the standard
activations, no peepholes, and a hidden width that is a multiple of 128.
Every other op runs in PyTorch, as the JAX ops run in ``jnp`` / ``lax``
outside any Pallas kernel.

The random ``uniform_random_int`` draws from the Executor's generator,
so it agrees with the JAX op (a threefry key) in distribution only
(ROADMAP.md Queue 3 #30); ``nce_core`` is deterministic given its
``Samples``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.executor import (LoDValue, in_compiled_step, raw_data,
                             with_lod_of)
from ..core.registry import register_op
from ..flags import FLAGS
from ..kernels.fused_gru import fused_gru
from ..kernels.fused_lstm import fused_lstm
from .common import constant, jax_clip

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
    """The pad length of the scan ops: the level's longest sequence,
    counted on the host when the value was fed (or by the host op that
    made it). Where it is unknown, the per-op path counts it from the
    offsets, which it reads back; a compiled step raises, as the JAX op
    does under ``jit``."""
    lv = level if level >= 0 else len(v.lod) + level
    ml = v.max_lens[lv] if v.max_lens else None
    if ml is not None:
        return int(ml)
    if in_compiled_step():
        raise ValueError(
            "sequence op needs a static max sequence length under jit; feed "
            "the input as a LoDTensor through Executor.run (which records "
            "max_lens), or run with use_jit=False")
    d = v.lod[lv].tolist()
    return max((b - a for a, b in zip(d, d[1:])), default=0)


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


def _sequence_pool_stride(ctx, data, offs, stride, ptype):
    """Stride windows: each sequence is cut into ceil(len / stride)
    windows of ``stride`` steps and each window pools to one row, so the
    output is a sequence of window results (the v1 SequencePoolLayer's
    ``stride_``; LAST / FIRST take each window's last / first row). The
    windows come from the offsets on the host; the pooling stays in
    torch, so the generic grad replays it."""
    offs_c = offs.tolist()
    new_offs, starts, ends = [0], [], []
    for a, b in zip(offs_c, offs_c[1:]):
        for w0 in range(a, b, stride):
            starts.append(w0)
            ends.append(min(w0 + stride, b))
        new_offs.append(len(starts))
    nwin = len(starts)
    wlens = np.asarray(ends, np.int64) - np.asarray(starts, np.int64)
    dev = data.device
    if ptype == "LAST":
        out = data[torch.as_tensor(np.asarray(ends, np.int64) - 1,
                                   device=dev)]
    elif ptype == "FIRST":
        out = data[torch.as_tensor(np.asarray(starts, np.int64),
                                   device=dev)]
    else:
        sid = torch.as_tensor(np.repeat(np.arange(nwin), wlens), device=dev)
        out = _segment_pool(data, sid, nwin,
                            torch.as_tensor(wlens, device=dev).to(
                                data.dtype), ptype)
    # the JAX op leaves the windows' longest sequence unknown (:169-170)
    ctx.set_output("Out", LoDValue(out, (torch.as_tensor(
        np.asarray(new_offs, np.int64), device=dev),)))


def _seq_pool_is_host(op):
    return int(op.attr("stride", -1) or -1) > 0


@register_op("sequence_pool", host=_seq_pool_is_host)
def sequence_pool(ctx):
    """Pool each sequence to one row, dropping the innermost LoD level:
    SUM, AVERAGE (or AVG), SQRT, MAX (with ``MaxIndex``, the first row of
    each maximum), LAST and FIRST; an empty sequence pools to zeros. With
    the v1 ``stride`` attr (a host op then), pool stride-sized windows to
    a shorter sequence."""
    x = ctx.input("X")
    data = raw_data(x)
    offs = seq_offsets(x)
    stride = int(ctx.attr("stride", -1) or -1)
    ptype = str(ctx.attr("pooltype", "AVERAGE")).upper()
    ptype = {"AVG": "AVERAGE"}.get(ptype, ptype)
    if stride > 0:
        if len(x.lod) > 1:
            raise NotImplementedError(
                "sequence_pool stride windows on nested sequences "
                "(the reference SequencePoolLayer asserts this too)")
        _sequence_pool_stride(ctx, data, offs, stride, ptype)
        return
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
    xs, peep = _peepholes(ctx, bias, D, xs)
    h = raw_data(h0) if h0 is not None else xs.new_zeros((n, D))
    c = raw_data(c0) if c0 is not None else xs.new_zeros((n, D))
    mf = ms.to(xs.dtype)

    if (lstm_impl(ctx.attr("lstm_impl")) == "pallas" and peep is None
            and acts == ("sigmoid", "tanh", "tanh") and D % 128 == 0):
        # the mask goes in as float32, as the JAX lowering gives it: the
        # kernel's bfloat16 face (pure AMP, no bias) takes a float32 mask
        hs, cs = fused_lstm(xs, w, h, c, ms.to(torch.float32))
    else:
        hs, cs = [], []
        # unbind, not xs[t]: the backward of T selects would zero-fill a
        # [T, n, 4D] gradient at every step
        for x_t, m_t in zip(xs.unbind(0), mf.unbind(0)):
            h_new, c_new = _lstm_cell(x_t + h @ w, c, D, peep, g_act,
                                      c_act, cand_act)
            m = m_t[:, None]
            h = h_new * m + h * (1 - m)
            c = c_new * m + c * (1 - m)
            hs.append(h)
            cs.append(c)
        hs, cs = _stack(hs, xs, n, D), _stack(cs, xs, n, D)
    ctx.set_output("Hidden", _back_to_lod(x, hs, rev, layout))
    ctx.set_output("Cell", _back_to_lod(x, cs, rev, layout))


def _peepholes(ctx, bias, D, xs):
    """(xs with the gate bias added, the (i, f, o) peephole weights or
    None): a bias ``[1, 4D]``, or ``[1, 7D]`` with the peepholes after
    it, which count only under ``use_peepholes``."""
    if bias is None:
        return xs, None
    b = bias.reshape(-1)
    xs = xs + b[:4 * D]
    if bool(ctx.attr("use_peepholes", True)) and bias.numel() >= 7 * D:
        return xs, (b[4 * D:5 * D], b[5 * D:6 * D], b[6 * D:7 * D])
    return xs, None


def _lstm_cell(g, c, D, peep, g_act, c_act, cand_act):
    """One LSTM step from the gate pre-activations ``g`` (slabs c~, i, f,
    o) and the previous cell: (h, c)."""
    c_t, i_t, f_t, o_t = g[:, :D], g[:, D:2 * D], g[:, 2 * D:3 * D], \
        g[:, 3 * D:]
    if peep is not None:
        i_t = i_t + c * peep[0]
        f_t = f_t + c * peep[1]
    c_new = g_act(f_t) * c + g_act(i_t) * cand_act(c_t)
    if peep is not None:
        o_t = o_t + c_new * peep[2]
    return g_act(o_t) * c_act(c_new), c_new


def _stack(steps, xs, n, width):
    """The steps' states ``[T, n, width]`` (a batch of empty sequences
    has none to stack)."""
    return torch.stack(steps) if steps else xs.new_zeros((0, n, width))


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
        for x_t, m_t in zip(xs.unbind(0), mf.unbind(0)):
            ur = g_act(x_t[:, :2 * D] + h @ w_ur)
            u, r = ur[:, :D], ur[:, D:]
            cand = cand_act(x_t[:, 2 * D:] + (r * h) @ w_c)
            h_new = (1.0 - u) * h + u * cand
            m = m_t[:, None]
            h = h_new * m + h * (1 - m)
            hs.append(h)
        hs = _stack(hs, xs, n, D)
    ctx.set_output("Hidden", _back_to_lod(x, hs, rev, layout))


@register_op("lstmp")
def lstmp(ctx):
    """LSTM with a recurrent projection: after the standard cell (with
    peepholes as ``lstm``'s), r = proj_act(h @ ProjWeight) feeds back as
    the recurrent input. Input ``[total, 4D]`` pre-projected; Weight
    ``[P, 4D]``; ProjWeight ``[D, P]``. Outputs Projection ``[total, P]``
    and Cell ``[total, D]``."""
    x = ctx.input("Input")
    w = raw_data(ctx.input("Weight"))
    w_proj = raw_data(ctx.input("ProjWeight"))
    bias = ctx.input("Bias")
    h0, c0 = ctx.input("H0"), ctx.input("C0")
    D, P = w_proj.shape[0], w_proj.shape[1]
    rev = bool(ctx.attr("is_reverse", False))
    g_act, c_act, cand_act = (_ACT[ctx.attr(k, d)] for k, d in (
        ("gate_activation", "sigmoid"), ("cell_activation", "tanh"),
        ("candidate_activation", "tanh")))
    proj_act = _ACT[ctx.attr("proj_activation", "tanh")]
    xs, ms, layout = _ragged_time_major(x, rev)
    n = xs.shape[1]
    xs, peep = _peepholes(ctx, None if bias is None else raw_data(bias), D,
                          xs)
    r = raw_data(h0) if h0 is not None else xs.new_zeros((n, P))
    c = raw_data(c0) if c0 is not None else xs.new_zeros((n, D))
    mf = ms.to(xs.dtype)
    rs, cs = [], []
    for x_t, m_t in zip(xs.unbind(0), mf.unbind(0)):
        h_new, c_new = _lstm_cell(x_t + r @ w, c, D, peep, g_act, c_act,
                                  cand_act)
        r_new = proj_act(h_new @ w_proj)
        m = m_t[:, None]
        r = r_new * m + r * (1 - m)
        c = c_new * m + c * (1 - m)
        rs.append(r)
        cs.append(c)
    ctx.set_output("Projection",
                   _back_to_lod(x, _stack(rs, xs, n, P), rev, layout))
    ctx.set_output("Cell", _back_to_lod(x, _stack(cs, xs, n, D), rev,
                                        layout))


@register_op("lstm_unit")
def lstm_unit(ctx):
    """One LSTM step on dense rows: X ``[N, 4D]`` pre-activation gates in
    slabs (c~, i, f, o), C_prev ``[N, D]``; ``forget_bias`` is added to
    the forget gate's input."""
    g = raw_data(ctx.input("X"))
    c_prev = raw_data(ctx.input("C_prev"))
    forget_bias = float(ctx.attr("forget_bias", 0.0))
    D = g.shape[-1] // 4
    c_t, i_t, f_t, o_t = (g[..., :D], g[..., D:2 * D], g[..., 2 * D:3 * D],
                          g[..., 3 * D:])
    c = torch.sigmoid(f_t + forget_bias) * c_prev \
        + torch.sigmoid(i_t) * torch.tanh(c_t)
    ctx.set_output("C", c)
    ctx.set_output("H", torch.sigmoid(o_t) * torch.tanh(c))


@register_op("gru_unit")
def gru_unit(ctx):
    """One GRU step: Input ``[N, 3D]`` pre-projected (slabs u, r, c),
    Weight ``[D, 3D]``, HiddenPrev ``[N, D]``, Bias ``[1, 3D]``. Outputs
    Gate (u, r and the candidate), ResetHiddenPrev (r * h_prev) and
    Hidden ((1 - u) h_prev + u c)."""
    g_in = raw_data(ctx.input("Input"))
    h_prev = raw_data(ctx.input("HiddenPrev"))
    w = raw_data(ctx.input("Weight"))
    bias = ctx.input("Bias")
    D = w.shape[0]
    if bias is not None:
        g_in = g_in + raw_data(bias).reshape(-1)
    g_act = _ACT[ctx.attr("gate_activation", "sigmoid")]
    cand_act = _ACT[ctx.attr("activation", "tanh")]
    ur = g_act(g_in[:, :2 * D] + h_prev @ w[:, :2 * D])
    u, r = ur[:, :D], ur[:, D:]
    cand = cand_act(g_in[:, 2 * D:] + (r * h_prev) @ w[:, 2 * D:])
    ctx.set_output("Gate", torch.cat([ur, cand], dim=-1))
    ctx.set_output("ResetHiddenPrev", r * h_prev)
    ctx.set_output("Hidden", (1.0 - u) * h_prev + u * cand)


@register_op("simple_rnn")
def simple_rnn(ctx):
    """Whole-sequence vanilla RNN: h_t = act(x_t + h_{t-1} W + b) over
    the pre-projected input (the v1 recurrent_layer's contract)."""
    x = ctx.input("Input")
    w = raw_data(ctx.input("Weight"))
    bias = ctx.input("Bias")
    act = _ACT[ctx.attr("activation", "tanh")]
    rev = bool(ctx.attr("is_reverse", False))
    D = w.shape[0]
    xs, ms, layout = _ragged_time_major(x, rev)
    n = xs.shape[1]
    if bias is not None:
        xs = xs + raw_data(bias).reshape(-1)
    mf = ms.to(xs.dtype)
    h, hs = xs.new_zeros((n, D)), []
    for x_t, m_t in zip(xs.unbind(0), mf.unbind(0)):
        m = m_t[:, None]
        h = act(x_t + h @ w) * m + h * (1 - m)
        hs.append(h)
    ctx.set_output("Hidden", _back_to_lod(x, _stack(hs, xs, n, D), rev,
                                          layout))


# ---------------------------------------------------------------------------
# LoD shaping

@register_op("sequence_softmax")
def sequence_softmax(ctx):
    """Softmax within each sequence over the concatenated rows of a
    ``[total, 1]`` input."""
    x = ctx.input("X")
    data = raw_data(x)
    flat = data.reshape(data.shape[0])
    offs = seq_offsets(x)
    n = offs.shape[0] - 1
    sid = segment_ids(offs, flat.shape[0])
    mx = torch.zeros((n,), dtype=flat.dtype, device=flat.device)
    mx = mx.scatter_reduce(0, sid, flat.detach(), "amax",
                           include_self=False)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(flat - mx[sid])
    z = _segment_sum(e, sid, n)
    ctx.set_output("Out", with_lod_of(x, (e / z[sid]).reshape(data.shape)))


@register_op("sequence_expand")
def sequence_expand(ctx):
    """Expand X to Y's sequence structure, aligned with Y's rows: X with
    one row per sequence of Y repeats row i over Y's sequence i; X with
    LoD repeats its sequence i cyclically over Y's sequence i."""
    x, y = ctx.input("X"), ctx.input("Y")
    xd = raw_data(x)
    y_offs = seq_offsets(y, 0)
    total_y = raw_data(y).shape[0]
    sid_y = segment_ids(y_offs, total_y)
    if isinstance(x, LoDValue) and x.lod:
        x_offs = seq_offsets(x, 0)
        pos = torch.arange(total_y, dtype=y_offs.dtype,
                           device=y_offs.device) - y_offs[:-1][sid_y]
        x_len = (x_offs[1:] - x_offs[:-1])[sid_y]
        src = x_offs[:-1][sid_y] + pos % torch.clamp(x_len, min=1)
        out = xd[src]
    else:
        out = xd[sid_y]
    ctx.set_output("Out", LoDValue(out, y.lod, max_lens=y.max_lens)
                   if isinstance(y, LoDValue) and y.lod else out)


@register_op("sequence_concat")
def sequence_concat(ctx):
    """Concatenate the inputs sequence by sequence along time. The
    output's longest sequence is the sum of the inputs' (the JAX op's
    static frame). Each part is written into an ``[n, T + 1]`` frame
    whose last column takes the padding (the JAX scatter's dropped
    writes) and is cut off."""
    xs = ctx.inputs("X")
    offs = [seq_offsets(v) for v in xs]
    datas = [raw_data(v) for v in xs]
    max_lens = [static_max_len(v) for v in xs]
    n = offs[0].shape[0] - 1
    T = sum(max_lens)
    feat = tuple(datas[0].shape[1:])
    dev, idt = offs[0].device, offs[0].dtype
    buf = torch.zeros((n, T + 1) + feat, dtype=datas[0].dtype, device=dev)
    start = torch.zeros((n,), dtype=idt, device=dev)
    rows = torch.arange(n, dtype=idt, device=dev)[:, None]
    out_len = torch.zeros_like(start)
    for d, o, ml in zip(datas, offs, max_lens):
        p, _ = lod_to_padded(d, o, ml)
        ln = o[1:] - o[:-1]
        t = torch.arange(ml, dtype=idt, device=dev)
        cols = torch.where(t[None, :] < ln[:, None], start[:, None] + t,
                           torch.full_like(t, T)[None, :])
        buf = buf.index_put((rows.expand(n, ml).reshape(-1),
                             cols.reshape(-1)), p.reshape((-1,) + feat))
        start = start + ln
        out_len = out_len + ln
    new_offs = torch.cat([torch.zeros((1,), dtype=idt, device=dev),
                          torch.cumsum(out_len, 0)])
    total = sum(d.shape[0] for d in datas)
    out = padded_to_lod(buf[:, :T], new_offs, total)
    ctx.set_output("Out", LoDValue(out, (new_offs,), max_lens=(T,)))


@register_op("sequence_reshape")
def sequence_reshape(ctx):
    """Change the feature width to ``new_dim``; each sequence's length
    scales by old / new."""
    x = ctx.input("X")
    data = raw_data(x)
    new_dim = int(ctx.attr("new_dim"))
    old_dim = data.shape[-1]
    offs = seq_offsets(x)
    ml = x.max_lens[-1]
    ml = None if ml is None else (ml * old_dim + new_dim - 1) // new_dim
    ctx.set_output("Out", LoDValue(data.reshape(-1, new_dim),
                                   ((offs * old_dim) // new_dim,),
                                   max_lens=(ml,)))


@register_op("lod_reset")
def lod_reset(ctx):
    """X's data with a new LoD: Y's (Y a LoD value), Y's values as
    offsets (Y a plain tensor; its longest sequence stays unknown, as in
    the JAX op), or the ``target_lod`` attr (its longest sequence
    counted on the host)."""
    x, y = ctx.input("X"), ctx.input("Y")
    data = raw_data(x)
    if y is not None:
        if isinstance(y, LoDValue) and y.lod:
            out = LoDValue(data, y.lod, max_lens=y.max_lens)
        else:
            out = LoDValue(data, (raw_data(y).to(torch.int64).reshape(-1),))
        ctx.set_output("Out", out)
        return
    target = [int(v) for v in ctx.attr("target_lod")]
    ml = max((b - a for a, b in zip(target, target[1:])), default=0)
    offs = constant(np.asarray(target, np.int64), data.device)
    ctx.set_output("Out", LoDValue(data, (offs,), max_lens=(ml,)))


@register_op("sequence_reverse")
def sequence_reverse(ctx):
    """Reverse the order of the steps within each sequence."""
    x = ctx.input("X")
    data = raw_data(x)
    offs = seq_offsets(x)
    ml = static_max_len(x)
    padded, mask = lod_to_padded(data, offs, ml)
    out = padded_to_lod(reverse_padded(padded, mask, offs, ml), offs,
                        data.shape[0])
    ctx.set_output("Y", LoDValue(out, x.lod, max_lens=x.max_lens))


def _infer_kmax_seq_score(op, block):
    ov = block._find_var_recursive(op.output("Out")[0])
    if ov is not None:
        ov.shape = (None, op.attr("beam_size", 1))
        ov.dtype = "int64"


@register_op("kmax_seq_score", infer_shape=_infer_kmax_seq_score,
             no_gradient=True)
def kmax_seq_score(ctx):
    """The ``beam_size`` best positions within each sequence of a
    ``[total, 1]`` score, one int64 row a sequence, -1 past its length;
    equal scores rank by position (a stable descending sort, as
    ``lax.top_k`` ranks them)."""
    x = ctx.input("X")
    data = raw_data(x)
    offs = seq_offsets(x)
    ml = static_max_len(x)
    k = int(ctx.attr("beam_size", 1))
    n = offs.shape[0] - 1
    kk = min(k, ml) if ml else 0
    if kk == 0:
        ctx.set_output("Out", torch.full((n, k), -1, dtype=torch.int64,
                                         device=data.device))
        return
    padded, mask = lod_to_padded(data.reshape(data.shape[0]), offs, ml)
    padded = torch.where(mask, padded, torch.full_like(padded, -math.inf))
    idx = torch.sort(padded, dim=1, descending=True, stable=True)[1][:, :kk]
    idx = torch.where(torch.gather(mask, 1, idx), idx,
                      torch.full_like(idx, -1))
    if kk < k:
        idx = torch.cat([idx, torch.full((n, k - kk), -1, dtype=idx.dtype,
                                         device=idx.device)], dim=1)
    ctx.set_output("Out", idx)


def _infer_sub_nested_seq(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    ov.shape = xv.shape
    ov.dtype = xv.dtype


@register_op("sub_nested_seq", infer_shape=_infer_sub_nested_seq)
def sub_nested_seq(ctx):
    """Select sub-sequences of a 2-level input by per-outer-sequence
    indices (SelectedIndices ``[n_outer, k]``, -1 padded): a 1-level
    output of ``n_outer * k`` slots (an invalid selection an empty
    sequence) over a buffer of the input's row count, the rows past the
    last offset zero, so its size does not depend on the data."""
    x = ctx.input("X")
    sel = raw_data(ctx.input("SelectedIndices")).to(torch.int64)
    if not isinstance(x, LoDValue) or len(x.lod) < 2:
        raise ValueError("sub_nested_seq input must be a nested (lod "
                         "level 2) sequence")
    data = raw_data(x)
    outer, inner = x.lod[0], x.lod[1]
    total = data.shape[0]
    n_outer, k = sel.shape
    n_sub = outer[1:] - outer[:-1]
    valid = (sel >= 0) & (sel < n_sub[:, None])
    g_flat = torch.where(valid, outer[:-1, None] + sel,
                         torch.zeros_like(sel)).reshape(-1)
    seg_len = inner[1:] - inner[:-1]
    new_lens = torch.where(valid.reshape(-1), seg_len[g_flat],
                           torch.zeros_like(g_flat))
    new_offs = torch.cat([torch.zeros((1,), dtype=new_lens.dtype,
                                      device=data.device),
                          torch.cumsum(new_lens, 0)])
    r = torch.arange(total, dtype=new_offs.dtype, device=data.device)
    t = torch.clamp(torch.searchsorted(new_offs[1:].contiguous(), r,
                                       right=True),
                    0, n_outer * k - 1)
    src = torch.clamp(inner[:-1][g_flat[t]] + (r - new_offs[t]), 0,
                      total - 1)
    out = data[src]
    out = torch.where(_expand_mask(r < new_offs[-1], out), out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    ml = x.max_lens[-1] if x.max_lens else None
    ctx.set_output("Out", LoDValue(out, (new_offs,), max_lens=(ml,)))


# ---------------------------------------------------------------------------
# host ops: the output's size depends on the offsets' values

def _host_lod(lens, dev):
    """(offsets, longest) of host lengths, on ``dev``."""
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return torch.as_tensor(offs, device=dev), (max(lens) if lens else 0)


@register_op("sequence_slice", host=True)
def sequence_slice(ctx):
    """Each sequence's rows [Offset, Offset + Length); a missing Offset
    starts at the sequence's first row, a missing Length runs to its end
    (v1 seq_slice_layer's open sides). A slice past the sequence
    raises."""
    x = ctx.input("X")
    data = raw_data(x)
    offs = seq_offsets(x).tolist()
    seq_lens = [b - a for a, b in zip(offs, offs[1:])]
    off_v, len_v = ctx.input("Offset"), ctx.input("Length")
    offset = (raw_data(off_v).reshape(-1).tolist() if off_v is not None
              else [0] * len(seq_lens))
    length = (raw_data(len_v).reshape(-1).tolist() if len_v is not None
              else [sl - o for sl, o in zip(seq_lens, offset)])
    rows, lens = [], []
    for i, sl in enumerate(seq_lens):
        o, ln = int(offset[i]), int(length[i])
        if o < 0 or ln < 0 or o + ln > sl:
            raise ValueError(
                "sequence_slice: seq %d has %d rows but offset=%d "
                "length=%d" % (i, sl, o, ln))
        rows.extend(range(offs[i] + o, offs[i] + o + ln))
        lens.append(ln)
    dev = data.device
    out = data[torch.as_tensor(np.asarray(rows, np.int64), device=dev)]
    new_offs, ml = _host_lod(lens, dev)
    ctx.set_output("Out", LoDValue(out, (new_offs,), max_lens=(ml,)))


def _host_int_op(ctx, slot, keep_fn, out_slot):
    """A host op on a ``[total, 1]`` int sequence: ``keep_fn(seq)`` gives
    each sequence's kept values (numpy)."""
    x = ctx.input(slot)
    data = raw_data(x)
    vals = data.reshape(-1).cpu().numpy()
    offs = seq_offsets(x).tolist()
    pieces = [keep_fn(vals[a:b]) for a, b in zip(offs, offs[1:])]
    out = np.concatenate(pieces) if pieces else vals[:0]
    lens = [len(p) for p in pieces]
    new_offs, ml = _host_lod(lens, data.device)
    ctx.set_output(out_slot, LoDValue(
        torch.as_tensor(out.reshape(-1, 1), device=data.device),
        (new_offs,), max_lens=(ml,)))


@register_op("sequence_erase", host=True)
def sequence_erase(ctx):
    """Remove the ``tokens`` from each sequence."""
    tokens = [int(t) for t in ctx.attr("tokens", [])]
    _host_int_op(ctx, "X", lambda s: s[~np.isin(s, tokens)] if tokens
                 else s, "Out")


@register_op("ctc_align", host=True)
def ctc_align(ctx):
    """CTC greedy decoding of each sequence of class ids: merge repeats
    (``merge_repeated``), then drop ``blank``."""
    blank = int(ctx.attr("blank", 0))
    merge = bool(ctx.attr("merge_repeated", True))

    def align(s):
        if merge and len(s):
            s = s[np.concatenate([[True], s[1:] != s[:-1]])]
        return s[s != blank]
    _host_int_op(ctx, "Input", align, "Output")


# per-scheme (begin, inside, end, single) position codes, -1 unused, and
# the number of positions (reference: chunk_eval_op.h GetSegments)
_CHUNK_POS = {"IOB": (0, 1, -1, -1), "IOE": (-1, 0, 1, -1),
              "IOBES": (0, 1, 2, 3), "plain": (-1, -1, -1, 0)}
_CHUNK_N_POS = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _chunks(seq, scheme, num_chunk_types, excluded):
    """The set of (start, end, type) chunks of one tag sequence."""
    p_begin, _, p_end, p_single = _CHUNK_POS[scheme]
    n_pos = _CHUNK_N_POS[scheme]
    parsed = [((int(t) // n_pos, int(t) % n_pos)
               if 0 <= int(t) < num_chunk_types * n_pos else None)
              for t in seq]
    chunks, start = [], None
    for i, cur in enumerate(parsed):
        if cur is None:
            start = None
            continue
        ctype, pos = cur
        prev = parsed[i - 1] if i > 0 else None
        if (pos in (p_begin, p_single) or prev is None
                or prev[0] != ctype or prev[1] in (p_end, p_single)):
            start = i
        nxt = parsed[i + 1] if i + 1 < len(parsed) else None
        ends = (pos in (p_end, p_single) or nxt is None
                or nxt[0] != ctype or nxt[1] in (p_begin, p_single))
        if ends and start is not None:
            if ctype not in excluded:
                chunks.append((start, i, ctype))
            start = None
    return set(chunks)


@register_op("chunk_eval", host=True, no_gradient=True)
def chunk_eval(ctx):
    """Chunk precision, recall and F1 (float32) and the inferred, label
    and correct chunk counts (int64) over IOB / IOE / IOBES / plain
    tags, the sequences cut by the Label's offsets."""
    inf_v, lab_v = ctx.input("Inference"), ctx.input("Label")
    num_chunk_types = int(ctx.attr("num_chunk_types"))
    scheme = str(ctx.attr("chunk_scheme", "IOB"))
    excluded = set(ctx.attr("excluded_chunk_types", []) or [])
    inf = raw_data(inf_v).reshape(-1).cpu().numpy()
    lab = raw_data(lab_v).reshape(-1).cpu().numpy()
    offs = seq_offsets(lab_v).tolist()
    n_inf = n_lab = n_correct = 0
    for a, b in zip(offs, offs[1:]):
        ic = _chunks(inf[a:b], scheme, num_chunk_types, excluded)
        lc = _chunks(lab[a:b], scheme, num_chunk_types, excluded)
        n_inf += len(ic)
        n_lab += len(lc)
        n_correct += len(ic & lc)
    p = n_correct / n_inf if n_inf else 0.0
    r = n_correct / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    dev = raw_data(lab_v).device
    for slot, v, dt in (("Precision", p, np.float32),
                        ("Recall", r, np.float32),
                        ("F1-Score", f1, np.float32),
                        ("NumInferChunks", n_inf, np.int64),
                        ("NumLabelChunks", n_lab, np.int64),
                        ("NumCorrectChunks", n_correct, np.int64)):
        ctx.set_output(slot, torch.as_tensor(np.asarray([v], dt),
                                             device=dev))


# ---------------------------------------------------------------------------
# context windows

def _context_cols(padded, mask, ctx_start, ctx_len):
    """The window's columns: for each j < ctx_len, row t's neighbour at
    t + ctx_start + j within its sequence, zero outside it; and each
    column's positions ``[T]``."""
    ml = padded.shape[1]
    t = torch.arange(ml, device=padded.device)
    zero = torch.zeros((), dtype=padded.dtype, device=padded.device)
    cols = []
    for j in range(ctx_len):
        shift = ctx_start + j
        pos = t + shift
        valid = ((pos >= 0) & (pos < ml))[None, :] \
            & torch.roll(mask, -shift, dims=1)
        cols.append((torch.where(valid[..., None],
                                 torch.roll(padded, -shift, dims=1), zero),
                     pos))
    return cols


def _context_attrs(ctx):
    ctx_len = int(ctx.attr("contextLength"))
    return ctx_len, int(ctx.attr("contextStart", -((ctx_len - 1) // 2)))


@register_op("sequence_conv")
def sequence_conv(ctx):
    """The context window of each row (``contextLength`` rows from
    ``contextStart``, zeros outside the sequence) times Filter
    ``[contextLength * D, F]``."""
    x = ctx.input("X")
    filt = raw_data(ctx.input("Filter"))
    data = raw_data(x)
    offs = seq_offsets(x)
    ml = static_max_len(x)
    ctx_len, ctx_start = _context_attrs(ctx)
    padded, mask = lod_to_padded(data, offs, ml)
    ctxmat = torch.cat([c for c, _ in _context_cols(padded, mask, ctx_start,
                                                    ctx_len)], dim=-1)
    out = torch.matmul(ctxmat, filt)
    out = torch.where(mask[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    ctx.set_output("Out", with_lod_of(x, padded_to_lod(out, offs,
                                                       data.shape[0])))


def _infer_context_project(op, block):
    xv = block._find_var_recursive(op.input("X")[0])
    ov = block._find_var_recursive(op.output("Out")[0])
    if None in (xv, ov) or xv.shape is None:
        return
    cl = op.attr("contextLength")
    ov.shape = tuple(xv.shape[:-1]) + (xv.shape[-1] * int(cl),)
    ov.dtype = xv.dtype
    ov.lod_level = xv.lod_level


@register_op("context_project", infer_shape=_infer_context_project)
def context_project(ctx):
    """The context window without the filter product: row i becomes its
    ``contextLength`` neighbours side by side. Off-sequence positions are
    zeros, or, with PaddingData ``[up_pad + down_pad, D]`` wired, learned
    rows: position -k before a sequence reads row up_pad - k, position
    len + q after it row up_pad + q."""
    x = ctx.input("X")
    data = raw_data(x)
    offs = seq_offsets(x)
    ml = static_max_len(x)
    ctx_len, ctx_start = _context_attrs(ctx)
    pad_w = (raw_data(ctx.input("PaddingData"))
             if ctx.has_input("PaddingData") else None)
    up_pad = max(0, -ctx_start)
    padded, mask = lod_to_padded(data, offs, ml)
    lens = offs[1:] - offs[:-1]
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    cols = []
    for col, pos in _context_cols(padded, mask, ctx_start, ctx_len):
        if pad_w is not None and pad_w.shape[0] > 0:
            wsz = pad_w.shape[0]
            w_b = pad_w[torch.clamp(up_pad + pos, 0, wsz - 1)]
            col = torch.where((pos < 0)[None, :, None], w_b[None], col)
            after = pos[None, :] >= lens[:, None]
            a_idx = torch.clamp(up_pad + pos[None, :] - lens[:, None], 0,
                                wsz - 1)
            col = torch.where(after[..., None], pad_w[a_idx], col)
            col = torch.where(mask[..., None], col, zero)
        cols.append(col)
    out = padded_to_lod(torch.cat(cols, dim=-1), offs, data.shape[0])
    ctx.set_output("Out", with_lod_of(x, out))


@register_op("row_conv")
def row_conv(ctx):
    """Lookahead row convolution: out_t = sum_j x_{t+j} * Filter[j] per
    feature, within each sequence."""
    x = ctx.input("X")
    filt = raw_data(ctx.input("Filter"))
    data = raw_data(x)
    offs = seq_offsets(x)
    ml = static_max_len(x)
    padded, mask = lod_to_padded(data, offs, ml)
    t = torch.arange(ml, device=data.device)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    out = torch.zeros_like(padded)
    for j in range(filt.shape[0]):
        valid = (t + j < ml)[None, :] & torch.roll(mask, -j, dims=1)
        out = out + torch.where(valid[..., None],
                                torch.roll(padded, -j, dims=1), zero) \
            * filt[j]
    out = torch.where(mask[..., None], out, zero)
    ctx.set_output("Out", with_lod_of(x, padded_to_lod(out, offs,
                                                       data.shape[0])))


# ---------------------------------------------------------------------------
# structured losses: CRF, CTC

def _crf_pieces(ctx):
    em_v = ctx.input("Emission")
    emission = raw_data(em_v)
    trans = raw_data(ctx.input("Transition"))  # [K + 2, K]
    offs = seq_offsets(em_v)
    ml = static_max_len(em_v)
    padded, mask = lod_to_padded(emission, offs, ml)  # [n, T, K]
    return (em_v, emission, offs, trans[0], trans[1], trans[2:], padded,
            mask)


@register_op("linear_chain_crf")
def linear_chain_crf(ctx):
    """-log p(label | emission) of a linear-chain CRF, one row a
    sequence: the forward algorithm in log space over the padded batch.
    Transition rows 0 and 1 are the start and end weights, rows 2+ the
    tag-to-tag matrix. Alpha is the final alpha broadcast over every
    step (the JAX op's, not the reference's per-step alphas)."""
    (em_v, emission, offs, start_w, end_w, tr, padded,
     mask) = _crf_pieces(ctx)
    label = raw_data(ctx.input("Label")).reshape(-1).to(torch.int64)
    lab_p = lod_to_padded(label[:, None], offs, padded.shape[1])[0][..., 0]
    n, T, K = padded.shape
    lengths = offs[1:] - offs[:-1]
    steps, masks = padded.unbind(1), mask.unbind(1)
    alpha = start_w[None, :] + steps[0]
    for em_t, m_t in zip(steps[1:], masks[1:]):
        nxt = torch.logsumexp(alpha[:, :, None] + tr[None], dim=1) + em_t
        alpha = torch.where(m_t[:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + end_w[None, :], dim=-1)
    zero = torch.zeros((), dtype=padded.dtype, device=padded.device)
    em_score = torch.where(mask, torch.gather(padded, 2, lab_p[..., None])
                           [..., 0], zero).sum(dim=1)
    tr_score = torch.where(mask[:, 1:], tr[lab_p[:, :-1], lab_p[:, 1:]],
                           zero).sum(dim=1)
    last_lab = torch.gather(lab_p, 1, torch.clamp(lengths - 1, min=0)[:, None])
    gold = em_score + tr_score + start_w[lab_p[:, 0]] + end_w[last_lab[:, 0]]
    ctx.set_output("LogLikelihood", (log_z - gold)[:, None])
    ctx.set_output("Alpha", with_lod_of(em_v, padded_to_lod(
        alpha[:, None, :].expand(n, T, K), offs, emission.shape[0])))
    ctx.set_output("EmissionExps", with_lod_of(em_v, torch.exp(emission)))
    ctx.set_output("TransitionExps", torch.exp(torch.cat(
        [start_w[None], end_w[None], tr], dim=0)))


@register_op("crf_decoding", no_gradient=True)
def crf_decoding(ctx):
    """Viterbi decoding: the best tag path (int64, the Emission's LoD);
    with Label, 1 where the path's tag equals the label, else 0. Ties go
    to the first tag, as ``jnp.argmax`` takes them."""
    (em_v, emission, offs, start_w, end_w, tr, padded,
     mask) = _crf_pieces(ctx)
    n, T, K = padded.shape
    lengths = offs[1:] - offs[:-1]
    score = start_w[None, :] + padded[:, 0, :]
    back = []
    for t in range(1, T):
        cand = score[:, :, None] + tr[None]
        back.append(torch.argmax(cand, dim=1))
        score = torch.where(mask[:, t, None],
                            cand.amax(dim=1) + padded[:, t], score)
    tag = torch.argmax(score + end_w[None, :], dim=-1)
    path = [tag]
    for step_t in range(T - 2, -1, -1):
        prev = torch.gather(back[step_t], 1, tag[:, None])[:, 0]
        tag = torch.where(step_t < lengths - 1, prev, tag)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)             # [n, T]
    flat = padded_to_lod(path[..., None].to(torch.int64), offs,
                         emission.shape[0])
    label = ctx.input("Label")
    if label is not None:
        gold = raw_data(label).reshape(-1, 1).to(torch.int64)
        flat = (flat == gold).to(torch.int64)
    ctx.set_output("ViterbiPath", with_lod_of(em_v, flat))


def _ctc_loss(logits, logit_pad, labels, label_pad, blank_id,
              log_epsilon=-1e5):
    """CTC's negative log-likelihood a sequence: ``optax.ctc_loss``'s
    log-space DP over raw logits (the log-softmax taken here, an
    impossible alignment a large finite loss through ``log_epsilon``),
    which the JAX op calls. logits ``[B, T, K]``, labels ``[B, N]``
    int64, paddings float 1.0 where padded."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_pad.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = torch.cat([repeat, repeat.new_zeros((B, 1))], dim=1)
    lp_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1).unbind(0)
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(B, T, N))
    lp_emit = lp_emit.transpose(0, 1).unbind(0)       # T x [B, N]
    phi = logits.new_full((B, N + 1), log_epsilon)
    phi = torch.cat([phi.new_zeros((B, 1)), phi[:, 1:]], dim=1)
    emit = logits.new_full((B, N), log_epsilon)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)],
                         dim=-1)

    for lp_e, lp_p, pad in zip(lp_emit, lp_phi, logit_pad.unbind(1)):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_e, emit + lp_e)
        next_phi = update_phi(prev_phi + lp_p,
                              emit + lp_p + log_epsilon * (1.0 - repeat))
        pad = pad.reshape(B, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


@register_op("warpctc")
def warpctc(ctx):
    """CTC loss of each sequence of raw logits (Logits ``[total, K]``)
    against its label sequence, one row a sequence; ``norm_by_times``
    divides by the sequence's length."""
    logits_v, label_v = ctx.input("Logits"), ctx.input("Label")
    logits = raw_data(logits_v)
    offs_x = seq_offsets(logits_v)
    labels = raw_data(label_v).reshape(-1)
    offs_y = seq_offsets(label_v)
    ml_y = max(static_max_len(label_v), 1)
    lp, lp_mask = lod_to_padded(logits, offs_x, static_max_len(logits_v))
    lab_p, lab_mask = lod_to_padded(labels[:, None], offs_y, ml_y)
    loss = _ctc_loss(lp, (~lp_mask).to(lp.dtype), lab_p[..., 0].to(
        torch.int64), (~lab_mask).to(lp.dtype), int(ctx.attr("blank", 0)))
    if bool(ctx.attr("norm_by_times", False)):
        loss = loss / torch.clamp(offs_x[1:] - offs_x[:-1], min=1).to(
            loss.dtype)
    ctx.set_output("Loss", loss[:, None])


# ---------------------------------------------------------------------------
# NCE: the samples drawn by an op of their own, the loss deterministic

@register_op("uniform_random_int", no_gradient=True)
def uniform_random_int(ctx):
    """int64 draws in [low, high) from the Executor's generator."""
    shape = [int(d) for d in ctx.attr("shape")]
    ctx.set_output("Out", torch.randint(
        int(ctx.attr("low", 0)), int(ctx.attr("high", 2)), shape,
        dtype=torch.int64, device=ctx.device,
        generator=ctx.next_generator()))


@register_op("nce_core")
def nce_core(ctx):
    """NCE loss of each row given the drawn negative Samples: the
    logistic loss of the true class against k q(y), and of each sample
    against k q(sample), q the sampler's noise distribution (uniform,
    ``log_uniform`` or ``custom_dist`` over CustomDistProbs)."""
    from .misc_ops import log_uniform_prob
    x = raw_data(ctx.input("Input"))
    label = raw_data(ctx.input("Label")).reshape(-1).to(torch.int64)
    w = raw_data(ctx.input("Weight"))
    b = ctx.input("Bias")
    samples = raw_data(ctx.input("Samples")).to(torch.int64)
    num_total = int(ctx.attr("num_total_classes"))
    num_neg = int(ctx.attr("num_neg_samples", samples.shape[0]))
    sampler = str(ctx.attr("sampler", "uniform"))
    if sampler == "log_uniform":
        log_q_label = log_uniform_prob(label, num_total)
        log_q_samples = log_uniform_prob(samples, num_total)
    elif sampler == "custom_dist":
        probs = raw_data(ctx.input("CustomDistProbs")).reshape(-1)
        log_q = torch.log(torch.clamp(probs, min=1e-20))
        log_q_label, log_q_samples = log_q[label], log_q[samples]
    else:
        log_q_label = x.new_full((label.shape[0],), -math.log(num_total))
        log_q_samples = x.new_full((samples.shape[0],),
                                   -math.log(num_total))
    true_logit = (x * w[label]).sum(dim=-1)
    neg_logit = x @ w[samples].t()
    if b is not None:
        bias = raw_data(b).reshape(-1)
        true_logit = true_logit + bias[label]
        neg_logit = neg_logit + bias[samples][None, :]
    log_kq_pos = math.log(num_neg) + log_q_label
    log_kq_neg = math.log(num_neg) + log_q_samples
    pos_ll = true_logit - torch.logaddexp(true_logit, log_kq_pos)
    neg_ll = log_kq_neg[None, :] - torch.logaddexp(neg_logit,
                                                   log_kq_neg[None, :])
    ctx.set_output("Cost", (-(pos_ll + neg_ll.sum(dim=-1)))[:, None])


# ---------------------------------------------------------------------------
# ranking

@register_op("lambda_rank_cost")
def lambda_rank_cost(ctx):
    """LambdaRank's listwise cost (v1 lambda_cost): per query sequence,
    sum over pairs with rel_i > rel_j of |dNDCG_ij| log(1 + exp(-(s_i -
    s_j))), the discount truncated at ``ndcg_num``; the mean over the
    queries. Ranks by score come from two stable argsorts, as the JAX
    op's ``jnp.argsort`` ranks ties."""
    s_in, r_in = ctx.input("Score"), ctx.input("Label")
    s = raw_data(s_in).reshape(-1)
    r = raw_data(r_in).reshape(-1)
    lod_in = s_in if isinstance(s_in, LoDValue) else r_in
    offs = seq_offsets(lod_in)
    ml = static_max_len(lod_in)
    k = int(ctx.attr("ndcg_num", 5))
    ps, mask = lod_to_padded(s, offs, ml)
    pr, _ = lod_to_padded(r, offs, ml)
    pos = torch.arange(ml, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    disc = 1.0 / torch.log2(pos.to(s.dtype) + 2.0)
    disc = torch.where(pos < k, disc, zero)
    gain_in = torch.where(mask, pr, zero)
    r_sorted = -torch.sort(-gain_in, dim=1)[0]
    idcg = torch.clamp(((2.0 ** r_sorted - 1.0) * disc[None]).sum(dim=1),
                       min=1e-5)
    order = torch.argsort(-torch.where(mask, ps, torch.full_like(
        ps, -math.inf)), dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    d_i = disc[torch.clamp(ranks, max=ml - 1)]
    gain = 2.0 ** gain_in - 1.0
    w = (gain[:, :, None] - gain[:, None, :]).abs() \
        * (d_i[:, :, None] - d_i[:, None, :]).abs() / idcg[:, None, None]
    pair_mask = ((pr[:, :, None] - pr[:, None, :]) > 0) \
        & mask[:, :, None] & mask[:, None, :]
    sd = ps[:, :, None] - ps[:, None, :]
    pair_cost = torch.log1p(torch.exp(-jax_clip(sd, -30.0, 30.0)))
    per_query = torch.where(pair_mask, w * pair_cost, zero).sum(dim=(1, 2))
    ctx.set_output("Out", per_query.mean().reshape(1))
