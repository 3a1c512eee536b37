"""Decoder-only transformer language model (counterpart of
``paddle_tpu/models/transformer.py``): the Program builders the trainer
runs and the serving face the generation engine drives.

Program builders (the layers DSL): :func:`transformer_lm`,
:func:`transformer_block` and :func:`causal_flash_attention`, whose
attention is the ``flash_attention`` op. :func:`params_from_scope` takes
the trained weights out of a scope for the serving face.

The serving face has the same weights and the same math as the JAX
package: learned token and position embeddings, pre-LN blocks
(``LN_EPS = 1e-5``, population variance), bias-free q/k/v/proj, a
bias-free ReLU MLP, a final layer norm and an untied head. Weights keep
the JAX layout, ``h @ W`` with ``W`` ``[in, out]``, and ``init_params`` is
numpy, so both packages start from the same bytes. The Program's FFN-up
``fc`` has an auto-named bias ``fc_N.b_0`` that the JAX package's
``param_names``, ``params_from_scope`` and serving face leave out; the
port mirrors that, so a trained model exports without that bias (its
initial value is zero). :func:`forward` takes it when the params dict
holds it as ``blk<i>_up_b``, for a gradient reference of the whole
Program.

Entry points of the serving face, all on tensors that live on one
device:

- :func:`forward`: full-sequence logits through the plain attention —
  the reference decoder;
- :func:`prefill_step`: one prompt through the full forward, its
  causal attention through the flash forward kernel, its K/V written
  into the paged pool, the last real position's logits returned;
- :func:`decode_step`: one token for every running row, its attention
  through the paged-attention kernel;
- :func:`device_sample`, :func:`decode_step_sampled`,
  :func:`prefill_step_sampled`: the same with the next token sampled
  on the device;
- :func:`draft_propose_step`, :func:`verify_step`,
  :func:`speculative_accept`, :func:`verify_step_sampled`: speculative
  decoding's round, a draft model's k proposals (k + 1 decode steps over
  its own pool) and one target step over the k + 1 lanes whose
  attention is the k-wide face of the paged-attention kernel, then the
  accept rule on the device.

The KV pool is updated in place. The JAX engine donates the pool
buffers to each jitted step and gets new ones back; PyTorch tensors are
mutable, so the scatter writes straight into the pool and the steps
return no pools.

Sampling. Greedy decode (temperature <= 0) is argmax and matches the
JAX package exactly. The JAX package draws tempered tokens from
``fold_in(PRNGKey(seed), position)`` with threefry, which this port does
not reproduce: its tempered draw is a Gumbel-max over noise from a
counter-based hash of (seed, position, vocab id) computed on the
device. The two packages' tempered tokens therefore agree only in
distribution; within the port the draw is a pure function of
(seed, position), so a preempted request that is resumed replays the
same stream. The speculative round's draws (the draft's proposal, the
accept uniform, the residual draw) are salted variants of the same hash,
as the JAX package salts its ``fold_in`` keys; a plain or bonus draw
uses the unsalted counter, so a row with no draft lanes reproduces the
plain stream bit for bit.

Positions past the context. A speculative round computes lanes past a
row's cap, whose positions can reach ``max_seq`` or more near the end of
the context; their writes go to the trash page and their outputs are
never read. The JAX package's ``take`` and gathers clamp or fill such
an index; PyTorch's embedding and advanced indexing raise (a device-side
assert on CUDA, which ends the process's CUDA context). So every
position-embedding row and block-table column is looked up at a clamped
index; a live position is never clamped.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.scope import global_scope
from ..device import resolve_device
from ..kernels.flash_attention import (flash_attention_reference,
                                       flash_attention_with_lse)
from ..kernels.paged_attention import (paged_attention,
                                       paged_attention_kwide)
from ..layers import nn as L
from ..layers import ops as OPS
from ..layers import tensor as T
from ..layers.layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["LN_EPS", "TransformerConfig", "TransformerLM", "param_names",
           "init_params", "params_from_scope", "forward", "prefill_step",
           "decode_step", "device_sample", "decode_step_sampled",
           "prefill_step_sampled", "draft_propose_step", "verify_step",
           "speculative_accept", "verify_step_sampled",
           "causal_flash_attention", "transformer_block", "transformer_lm"]


def causal_flash_attention(q, k, v, num_heads):
    """[B, S, hidden] q/k/v -> [B, S, hidden] through the causal
    ``flash_attention`` op."""
    hidden = q.shape[-1]
    seq = q.shape[-2]
    dh = hidden // num_heads
    qh = L.reshape(q, shape=[0, seq, num_heads, dh])
    kh = L.reshape(k, shape=[0, seq, num_heads, dh])
    vh = L.reshape(v, shape=[0, seq, num_heads, dh])
    helper = LayerHelper("flash_attention")
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    out.shape = qh.shape
    helper.append_op(type="flash_attention",
                     inputs={"Q": [qh], "K": [kh], "V": [vh]},
                     outputs={"Out": [out]}, attrs={"causal": True})
    return L.reshape(out, shape=[0, seq, hidden])


def transformer_block(x, hidden, num_heads, ffn_mult=4, prefix="blk"):
    """Pre-norm block: x + attn(ln(x)); x + ffn(ln(x))."""
    h = L.layer_norm(x, begin_norm_axis=2,
                     param_attr=ParamAttr(name=prefix + "_ln1_w"),
                     bias_attr=ParamAttr(name=prefix + "_ln1_b"))
    q = L.fc(h, size=hidden, num_flatten_dims=2, bias_attr=False,
             param_attr=ParamAttr(name=prefix + "_q"))
    k = L.fc(h, size=hidden, num_flatten_dims=2, bias_attr=False,
             param_attr=ParamAttr(name=prefix + "_k"))
    v = L.fc(h, size=hidden, num_flatten_dims=2, bias_attr=False,
             param_attr=ParamAttr(name=prefix + "_v"))
    att = causal_flash_attention(q, k, v, num_heads)
    proj = L.fc(att, size=hidden, num_flatten_dims=2, bias_attr=False,
                param_attr=ParamAttr(name=prefix + "_proj"))
    x = L.elementwise_add(x, proj)
    h2 = L.layer_norm(x, begin_norm_axis=2,
                      param_attr=ParamAttr(name=prefix + "_ln2_w"),
                      bias_attr=ParamAttr(name=prefix + "_ln2_b"))
    up = L.fc(h2, size=hidden * ffn_mult, num_flatten_dims=2, act="relu",
              param_attr=ParamAttr(name=prefix + "_up"))
    down = L.fc(up, size=hidden, num_flatten_dims=2, bias_attr=False,
                param_attr=ParamAttr(name=prefix + "_down"))
    return L.elementwise_add(x, down)


def transformer_lm(tokens, vocab_size, hidden=64, num_layers=2,
                   num_heads=4, ffn_mult=4):
    """``tokens`` [B, S] int64 -> logits [B, S, vocab_size]: learned
    position embeddings added to token embeddings, ``num_layers`` pre-norm
    causal blocks, final layer norm, untied head."""
    seq = tokens.shape[1]
    emb = L.embedding(tokens, size=[vocab_size, hidden],
                      param_attr=ParamAttr(name="tok_emb"))
    # position ids: cumsum over a ones row - 1, per batch row
    ones = T.fill_constant_batch_size_like(tokens, shape=[-1, seq],
                                           dtype="float32", value=1.0)
    pos_ids = T.cast(L.scale(OPS.cumsum(ones, axis=1), scale=1.0, bias=-1.0),
                     "int64")
    pos = L.embedding(pos_ids, size=[seq, hidden],
                      param_attr=ParamAttr(name="pos_emb"))
    x = L.elementwise_add(emb, pos)
    for i in range(num_layers):
        x = transformer_block(x, hidden, num_heads, ffn_mult,
                              prefix="blk%d" % i)
    x = L.layer_norm(x, begin_norm_axis=2,
                     param_attr=ParamAttr(name="final_ln_w"),
                     bias_attr=ParamAttr(name="final_ln_b"))
    return L.fc(x, size=vocab_size, num_flatten_dims=2, bias_attr=False,
                param_attr=ParamAttr(name="lm_head"))


LN_EPS = 1e-5


class TransformerConfig(object):
    """Static hyperparameters of one decoder-only LM (JSON round-trip
    for the generative artifact)."""

    __slots__ = ("vocab_size", "hidden", "num_layers", "num_heads",
                 "ffn_mult", "max_seq", "eos_id")

    def __init__(self, vocab_size, hidden=64, num_layers=2, num_heads=4,
                 ffn_mult=4, max_seq=128, eos_id=None):
        if hidden % num_heads:
            raise ValueError("hidden=%d not divisible by num_heads=%d"
                             % (hidden, num_heads))
        self.vocab_size = int(vocab_size)
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.ffn_mult = int(ffn_mult)
        self.max_seq = int(max_seq)
        self.eos_id = None if eos_id is None else int(eos_id)

    @property
    def head_dim(self):
        return self.hidden // self.num_heads

    def to_dict(self):
        return {"vocab_size": self.vocab_size, "hidden": self.hidden,
                "num_layers": self.num_layers, "num_heads": self.num_heads,
                "ffn_mult": self.ffn_mult, "max_seq": self.max_seq,
                "eos_id": self.eos_id}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def param_names(config):
    """Declaration-ordered parameter names, the JAX package's own."""
    names = ["tok_emb", "pos_emb"]
    for i in range(config.num_layers):
        p = "blk%d" % i
        names += [p + s for s in ("_ln1_w", "_ln1_b", "_q", "_k", "_v",
                                  "_proj", "_ln2_w", "_ln2_b", "_up",
                                  "_down")]
    names += ["final_ln_w", "final_ln_b", "lm_head"]
    return names


def init_params(config, seed=0):
    """Random float32 params as numpy arrays: byte for byte what the JAX
    package's ``init_params`` makes for the same config and seed."""
    rng = np.random.RandomState(seed)
    H, V, S = config.hidden, config.vocab_size, config.max_seq
    Fw = H * config.ffn_mult

    def w(shape, scale):
        return (rng.randn(*shape) * scale).astype(np.float32)

    p = {"tok_emb": w((V, H), 0.05), "pos_emb": w((S, H), 0.05)}
    for i in range(config.num_layers):
        pre = "blk%d" % i
        p[pre + "_ln1_w"] = np.ones((H,), np.float32)
        p[pre + "_ln1_b"] = np.zeros((H,), np.float32)
        for s in ("_q", "_k", "_v", "_proj"):
            p[pre + s] = w((H, H), (2.0 / H) ** 0.5)
        p[pre + "_ln2_w"] = np.ones((H,), np.float32)
        p[pre + "_ln2_b"] = np.zeros((H,), np.float32)
        p[pre + "_up"] = w((H, Fw), (2.0 / H) ** 0.5)
        p[pre + "_down"] = w((Fw, H), (2.0 / Fw) ** 0.5)
    p["final_ln_w"] = np.ones((H,), np.float32)
    p["final_ln_b"] = np.zeros((H,), np.float32)
    p["lm_head"] = w((H, V), (2.0 / H) ** 0.5)
    return p


def params_from_scope(config, scope=None):
    """The trained transformer_lm weights of ``scope`` (default the
    global scope) as the {name: np.ndarray} dict of the serving face.
    Raises with every missing name listed."""
    scope = scope or global_scope()
    out, missing = {}, []
    for n in param_names(config):
        v = scope.find_var(n)
        if v is None:
            missing.append(n)
        else:
            out[n] = v.detach().cpu().numpy()
    if missing:
        raise ValueError(
            "scope is missing transformer params %s — was transformer_lm "
            "built with this config and the startup program run?" % missing)
    return out


def _ln(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps=LN_EPS)


def _plain_causal(q, k, v):
    return flash_attention_reference(q, k, v, causal=True)[0]


def _kernel_causal(q, k, v):
    return flash_attention_with_lse(q, k, v, causal=True)[0]


def _forward_hidden(params, tokens, config, causal_attention):
    """Full forward over ``tokens`` [B, S] -> (final-LN hidden [B, S, H],
    per-layer k and v lists of [B, S, nh, dh]). ``causal_attention``
    maps [B, S, nh, dh] q/k/v to the attention output."""
    nh, dh = config.num_heads, config.head_dim
    B, S = tokens.shape
    x = F.embedding(tokens.long(), params["tok_emb"]) \
        + params["pos_emb"][:S][None]
    ks, vs = [], []
    for i in range(config.num_layers):
        pre = "blk%d" % i
        h = _ln(x, params[pre + "_ln1_w"], params[pre + "_ln1_b"])
        q = (h @ params[pre + "_q"]).view(B, S, nh, dh)
        k = (h @ params[pre + "_k"]).view(B, S, nh, dh)
        v = (h @ params[pre + "_v"]).view(B, S, nh, dh)
        ks.append(k)
        vs.append(v)
        att = causal_attention(q, k, v).reshape(B, S, nh * dh)
        x = x + att @ params[pre + "_proj"]
        h2 = _ln(x, params[pre + "_ln2_w"], params[pre + "_ln2_b"])
        up = h2 @ params[pre + "_up"]
        if pre + "_up_b" in params:
            up = up + params[pre + "_up_b"]
        x = x + torch.relu(up) @ params[pre + "_down"]
    return _ln(x, params["final_ln_w"], params["final_ln_b"]), ks, vs


def _forward_kv(params, tokens, config):
    """(logits [B, S, V], k [L, B, S, nh, dh], v [L, B, S, nh, dh]) of the
    plain forward, the JAX function's return."""
    x, ks, vs = _forward_hidden(params, tokens, config, _plain_causal)
    return x @ params["lm_head"], torch.stack(ks), torch.stack(vs)


def forward(params, tokens, config):
    """Full-sequence logits [B, S, V] through the plain attention."""
    x, _, _ = _forward_hidden(params, tokens, config, _plain_causal)
    return x @ params["lm_head"]


def prefill_step(params, k_pages, v_pages, tokens, length, pages, config,
                 covered=0):
    """One prompt (``tokens`` [S_bucket], real length ``length``, an int)
    through the full forward with the flash kernel's causal attention.
    Its K/V are written in place into the pools ``[L, P + 1, T, nh, dh]``
    at the sequence's ``pages`` ([max_blocks], trash-padded); positions
    >= ``length`` go to the trash page. Padding sits after the real
    positions, so causality keeps it out of every real row. Positions
    below ``covered`` (an int: the run of pages a prefix match pinned)
    go to the trash page too, so that no shared page is written; the
    JAX package writes them again with what they hold. Returns the
    logits [V] of the last real position (the head runs on that row
    only: the other rows' logits are never read)."""
    T = k_pages.shape[2]
    trash = k_pages.shape[1] - 1
    x, ks, vs = _forward_hidden(params, tokens[None], config, _kernel_causal)
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    page = torch.where((pos >= covered) & (pos < length),
                       pages.long()[pos // T], torch.full_like(pos, trash))
    slot = pos % T
    for i in range(config.num_layers):
        # padded positions all land on the trash page, some at the same
        # slot: which duplicate wins is unspecified and never read
        k_pages[i, page, slot] = ks[i][0]
        v_pages[i, page, slot] = vs[i][0]
    return x[0, length - 1] @ params["lm_head"]


def decode_step(params, k_pages, v_pages, block_tables, positions, tokens,
                active, config):
    """ONE token step for the whole running batch.

    ``k_pages``/``v_pages``: [L, P + 1, T, nh, dh], updated in place.
    ``block_tables``: [R, max_blocks] int32, trash-padded. ``positions``:
    [R] int32, the new token's position (= tokens cached so far).
    ``tokens``: [R] int32, each row's last sampled token. ``active``: [R]
    bool; inactive rows write to the trash page and their outputs are
    garbage the engine discards. Per layer the new K/V is written into
    the pool before the paged-attention kernel reads it, on the same
    stream. Returns the logits [R, V]."""
    nh, dh = config.num_heads, config.head_dim
    R = tokens.shape[0]
    T = k_pages.shape[2]
    trash = k_pages.shape[1] - 1
    pos = positions.long()
    rows = torch.arange(R, device=tokens.device)
    x = F.embedding(tokens.long(), params["tok_emb"]) \
        + F.embedding(pos.clamp(max=config.max_seq - 1), params["pos_emb"])
    blk = (pos // T).clamp(max=block_tables.shape[1] - 1)
    page = torch.where(active, block_tables[rows, blk].long(),
                       torch.full_like(pos, trash))
    slot = pos % T
    for i in range(config.num_layers):
        pre = "blk%d" % i
        h = _ln(x, params[pre + "_ln1_w"], params[pre + "_ln1_b"])
        q = (h @ params[pre + "_q"]).view(R, nh, dh)
        k_new = (h @ params[pre + "_k"]).view(R, nh, dh)
        v_new = (h @ params[pre + "_v"]).view(R, nh, dh)
        # inactive rows share the trash page (and a slot): unspecified
        # which duplicate wins, never read by a live row
        k_pages[i, page, slot] = k_new
        v_pages[i, page, slot] = v_new
        att = paged_attention(q, k_pages[i], v_pages[i], block_tables,
                              positions)
        x = x + att.reshape(R, nh * dh) @ params[pre + "_proj"]
        h2 = _ln(x, params[pre + "_ln2_w"], params[pre + "_ln2_b"])
        up = torch.relu(h2 @ params[pre + "_up"])
        x = x + up @ params[pre + "_down"]
    x = _ln(x, params["final_ln_w"], params["final_ln_b"])
    return x @ params["lm_head"]


_MASK32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 tensors holding 32-bit values, in two
    16-bit halves so that no product leaves the int64 range."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _hash32(x):
    """A 32-bit integer mix (lowbias32) over int64 tensors."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


# salts of the speculative round's draws (the JAX package's
# _DRAFT_SALT, _ACCEPT_SALT and _RESID_SALT): the draft model's proposal,
# the accept uniform of a draft lane, the residual draw after a rejection
DRAFT_SALT = 0x5D
ACCEPT_SALT = 0x5A
RESID_SALT = 0x5E


def _row_key(seeds, counters, salt=0):
    """The 32-bit key of each row's draw at ``counters``; a salt keys an
    independent stream, salt 0 the plain one."""
    row = _hash32(_hash32(seeds.long()) ^ counters.long())
    if salt:
        row = _hash32(row ^ _hash32(torch.full_like(row, salt)))
    return row


def _unit(bits):
    """24 random bits -> a uniform strictly inside (0, 1), float64."""
    return ((bits >> 8).double() + 0.5) * (1.0 / (1 << 24))


def gumbel_noise(seeds, counters, vocab_size, salt=0):
    """[R, V] standard Gumbel noise, a pure function of each row's
    (seed, counter), the salt and the vocab id, computed on the seeds'
    device."""
    row = _row_key(seeds, counters, salt)
    ids = torch.arange(vocab_size, device=seeds.device, dtype=torch.long)
    bits = _hash32(row[:, None] ^ _hash32(ids + 0x9E3779B9)[None, :])
    return (-torch.log(-torch.log(_unit(bits)))).float()


def uniform_noise(seeds, counters, salt):
    """A uniform in (0, 1) of each entry's (seed, counter, salt):
    ``seeds`` and ``counters`` broadcast to one shape; float32."""
    seeds, counters = torch.broadcast_tensors(seeds, counters)
    return _unit(_hash32(_row_key(seeds, counters, salt)
                         ^ 0x2545F491)).float()


def device_sample(logits, temperatures, seeds, counters):
    """Per-row sampling on the device: ``logits`` [R, V];
    ``temperatures`` [R] f32 (<= 0 is greedy argmax); ``seeds`` and
    ``counters`` [R] int32, the counter being the sampled token's
    position in the full sequence. Tempered rows take
    ``argmax(logits / temperature + gumbel(seed, counter))``. Returns
    (tokens [R] int32, logprobs [R] f32: the untempered log-softmax at
    the chosen token)."""
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperatures, min=1e-6)[:, None]
    noise = gumbel_noise(seeds, counters, logits.shape[-1])
    sampled = torch.argmax(logits / temp + noise, dim=-1)
    toks = torch.where(temperatures > 0.0, sampled, greedy)
    logps = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                         toks[:, None])[:, 0]
    return toks.int(), logps


def decode_step_sampled(params, k_pages, v_pages, block_tables, positions,
                        tokens, active, temperatures, seeds, config):
    """:func:`decode_step` + :func:`device_sample`, the counter of each row
    being ``positions + 1`` (the sampled token's position). Returns
    (tokens [R] int32, logprobs [R] f32)."""
    logits = decode_step(params, k_pages, v_pages, block_tables, positions,
                         tokens, active, config)
    return device_sample(logits, temperatures, seeds, positions + 1)


def prefill_step_sampled(params, k_pages, v_pages, tokens, length, pages,
                         temperature, seed, config, covered=0):
    """:func:`prefill_step` + sampling of the first token on the device,
    its counter being ``length`` (its position in the full sequence).
    Returns (token, logprob) as 0-d tensors."""
    last = prefill_step(params, k_pages, v_pages, tokens, length, pages,
                        config, covered=covered)
    dev = last.device
    toks, logps = device_sample(
        last[None], torch.tensor([temperature], dtype=torch.float32,
                                 device=dev),
        torch.tensor([seed], dtype=torch.int32, device=dev),
        torch.tensor([length], dtype=torch.int32, device=dev))
    return toks[0], logps[0]


# ---------------------------------------------------------------------------
# Speculative decoding (serving/speculative.py and the engine drive these).
#
# One round: the DRAFT model proposes k tokens a row (k + 1 decode steps
# over its own page pool), then the TARGET runs ONE step over the k + 1
# lanes of every row, which writes all lanes' K/V and attends every lane
# at once, accepts the longest valid draft prefix and samples the
# correction or bonus token on the device. Only a packed [R, 2 * K1 + 1]
# float32 row crosses to the host; the draft logits stay on the device.
#
# Stale writes need no rollback: a lane past the accepted point wrote
# K/V that attention masks (columns past a lane's position), and the
# next round starts at the first unaccepted position and writes it again
# before any unmasked read.

def draft_propose_step(params, k_pages, v_pages, block_tables, positions,
                       tokens, active, temperatures, seeds, spec_caps, k,
                       config):
    """Propose ``k`` tokens a row with the DRAFT model: k + 1
    :func:`decode_step` substeps over the draft's own pool (the JAX
    package's ``lax.scan`` as a Python loop). Substep j feeds the row's
    current token at ``positions + j`` (substep 0 the pending last token,
    later ones the row's own proposals) and writes its K/V only while
    ``j <= spec_caps`` (the rest go to the trash page); it then draws the
    next proposal: argmax, or for a tempered row a Gumbel-max keyed by
    (seed, ``positions + j + 1``, ``DRAFT_SALT``). Both draws are
    computed for every row and selected per row, so nothing waits on
    the host. The last substep only writes K/V, which keeps the draft's
    cache level with the target's. Returns (drafts [R, k] int32,
    draft_logits [R, k, V] float32), both on the device."""
    pos0 = positions.long()
    temp = torch.clamp(temperatures, min=1e-6)[:, None]
    tempered = temperatures > 0.0
    cur = tokens
    drafts, logits_k = [], []
    for j in range(k + 1):
        write_ok = active & (spec_caps >= j)
        logits = decode_step(params, k_pages, v_pages, block_tables,
                             positions + j, cur, write_ok, config)
        if j == k:
            break
        greedy = torch.argmax(logits, dim=-1)
        noise = gumbel_noise(seeds, pos0 + j + 1, logits.shape[-1],
                             DRAFT_SALT)
        sampled = torch.argmax(logits / temp + noise, dim=-1)
        cur = torch.where(tempered, sampled, greedy).int()
        drafts.append(cur)
        logits_k.append(logits)
    return torch.stack(drafts, dim=1), torch.stack(logits_k, dim=1)


def verify_step(params, k_pages, v_pages, block_tables, positions, tokens,
                active, spec_caps, config):
    """ONE target step over ``K1 = k + 1`` lanes a row: lane i feeds
    ``tokens[r, i]`` at position ``positions[r] + i`` (lane 0 the pending
    last token, lanes 1..k the proposals). Per layer every lane's K/V is
    written first, then every lane attends through the block table with
    its own position mask (:func:`paged_attention_kwide`), so lane i
    computes what a plain decode step computes after accepting the lanes
    before it. Lanes past ``spec_caps[r]`` and inactive rows write to the
    trash page. The projections run on R * K1 rows. Returns the logits
    [R, K1, V]."""
    nh, dh = config.num_heads, config.head_dim
    R, K1 = tokens.shape
    T = k_pages.shape[2]
    trash = k_pages.shape[1] - 1
    lanes = torch.arange(K1, device=tokens.device)
    pos = positions.long()[:, None] + lanes[None, :]            # [R, K1]
    live = active[:, None] & (lanes[None, :] <= spec_caps.long()[:, None])
    x = F.embedding(tokens.long(), params["tok_emb"]) \
        + F.embedding(pos.clamp(max=config.max_seq - 1), params["pos_emb"])
    blk = (pos // T).clamp(max=block_tables.shape[1] - 1)
    page = torch.where(live, torch.gather(block_tables.long(), 1, blk),
                       torch.full_like(pos, trash))
    slot = pos % T
    pos32 = pos.int()
    for i in range(config.num_layers):
        pre = "blk%d" % i
        h = _ln(x, params[pre + "_ln1_w"], params[pre + "_ln1_b"])
        q = (h @ params[pre + "_q"]).view(R, K1, nh, dh)
        k_new = (h @ params[pre + "_k"]).view(R, K1, nh, dh)
        v_new = (h @ params[pre + "_v"]).view(R, K1, nh, dh)
        # dead lanes share the trash page (and slots): unspecified which
        # duplicate wins, never read by a live lane
        k_pages[i, page, slot] = k_new
        v_pages[i, page, slot] = v_new
        att = paged_attention_kwide(q, k_pages[i], v_pages[i],
                                    block_tables, pos32)
        x = x + att.reshape(R, K1, nh * dh) @ params[pre + "_proj"]
        h2 = _ln(x, params[pre + "_ln2_w"], params[pre + "_ln2_b"])
        up = torch.relu(h2 @ params[pre + "_up"])
        x = x + up @ params[pre + "_down"]
    x = _ln(x, params["final_ln_w"], params["final_ln_b"])
    return x @ params["lm_head"]


def speculative_accept(logits, drafts, draft_logits, positions,
                       temperatures, seeds, spec_caps):
    """The accept rule, on the device. ``logits`` [R, K1, V] the target's
    verify logits; ``drafts`` [R, K] and ``draft_logits`` [R, K, V] the
    proposals; ``spec_caps`` [R]: draft i counts only while ``i < cap``
    (cap 0 is a plain row).

    A greedy row (temperature <= 0) accepts the longest prefix with
    ``drafts[i] == argmax(logits[:, i])`` and emits
    ``argmax(logits[:, a])`` after it: the tokens plain greedy decode
    emits. A tempered row uses rejection sampling: draft i is accepted
    when ``log u <= log q(d) - log p(d)`` (q the tempered target, p the
    tempered draft, u keyed by the draft's position and ``ACCEPT_SALT``);
    the first rejection draws from ``norm(max(q - p, 0))`` keyed
    ``RESID_SALT``; a row that accepted all its lanes draws its bonus
    token with the plain, unsalted key at that position. Greedy and
    tempered results are both computed and selected per row.

    Returns (emitted [R, K1] int32, n_out [R] int32 in 1..K1, logprobs
    [R, K1] float32: the untempered log-softmax at each emitted token)."""
    R, K1, V = logits.shape
    K = K1 - 1
    pos0 = positions.long()
    lanes = torch.arange(K, device=logits.device)
    lanes1 = torch.arange(K1, device=logits.device)
    temp = torch.clamp(temperatures, min=1e-6)[:, None]          # [R, 1]
    is_greedy = temperatures <= 0.0
    dl = drafts.long()

    greedy_t = torch.argmax(logits, dim=-1)                      # [R, K1]
    g_acc = dl == greedy_t[:, :K]
    lq = torch.log_softmax(logits[:, :K] / temp[:, :, None], dim=-1)
    lp = torch.log_softmax(draft_logits / temp[:, :, None], dim=-1)
    lq_d = torch.gather(lq, 2, dl[..., None])[..., 0]
    lp_d = torch.gather(lp, 2, dl[..., None])[..., 0]
    u = uniform_noise(seeds.long()[:, None],
                      pos0[:, None] + 1 + lanes[None, :], ACCEPT_SALT)
    t_acc = torch.log(u) <= lq_d - lp_d
    acc = torch.where(is_greedy[:, None], g_acc, t_acc)
    acc = acc & (lanes[None, :] < spec_caps.long()[:, None])
    a = torch.cumprod(acc.long(), dim=1).sum(dim=1)               # [R]

    # the correction or bonus token, from lane a's distributions
    lt_a = torch.gather(logits, 1, a[:, None, None].expand(R, 1, V))[:, 0]
    ld_a = torch.gather(draft_logits, 1, a.clamp(max=K - 1)[:, None, None]
                        .expand(R, 1, V))[:, 0]
    qa = torch.softmax(lt_a / temp, dim=-1)
    pa = torch.softmax(ld_a / temp, dim=-1)
    resid = torch.clamp(qa - pa, min=0.0)
    resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0.0, resid, qa)
    idx = pos0 + a + 1
    t_resid = torch.argmax(torch.log(resid + 1e-38)
                           + gumbel_noise(seeds, idx, V, RESID_SALT), dim=-1)
    t_plain = torch.argmax(lt_a / temp + gumbel_noise(seeds, idx, V),
                           dim=-1)
    final_t = torch.where(a < spec_caps.long(), t_resid, t_plain)
    final_g = torch.gather(greedy_t, 1, a[:, None])[:, 0]
    final = torch.where(is_greedy, final_g, final_t)

    drafts_pad = torch.cat([dl, dl[:, :1]], dim=1)
    emitted = torch.where(lanes1[None, :] < a[:, None], drafts_pad,
                          final[:, None])
    logps = torch.gather(torch.log_softmax(logits, dim=-1), 2,
                         emitted[..., None])[..., 0]
    return emitted.int(), (a + 1).int(), logps


def verify_step_sampled(params, k_pages, v_pages, block_tables, positions,
                        tokens, drafts, draft_logits, active, temperatures,
                        seeds, spec_caps, config):
    """:func:`verify_step` over ``[last token, drafts...]`` and
    :func:`speculative_accept`. Returns the packed [R, 2 * K1 + 1]
    float32 rows (emitted tokens [K1], n_out, logprobs [K1]), the one
    tensor a round copies to the host (token ids are exact in float32
    up to a vocab of 2**24)."""
    tokens_k1 = torch.cat([tokens.int()[:, None], drafts.int()], dim=1)
    logits = verify_step(params, k_pages, v_pages, block_tables, positions,
                         tokens_k1, active, spec_caps, config)
    emitted, n_out, logps = speculative_accept(
        logits, drafts, draft_logits, positions, temperatures, seeds,
        spec_caps)
    return torch.cat([emitted.float(), n_out.float()[:, None], logps],
                     dim=1)


class TransformerLM(nn.Module):
    """Weights and config bound into the serving face the generation
    engine drives. The weights are buffers in the JAX layout, kept on
    one device; ``model(tokens)`` is the plain full-sequence forward."""

    def __init__(self, config, params):
        super().__init__()
        if isinstance(config, dict):
            config = TransformerConfig.from_dict(config)
        self.config = config
        missing = [n for n in param_names(config) if n not in params]
        if missing:
            raise ValueError("params dict is missing %s" % missing)
        for n in param_names(config):
            self.register_buffer(n, params[n])

    @classmethod
    def from_numpy(cls, params, config, device="cuda"):
        """Carry weights across from the JAX package: ``params`` is its
        ``{name: np.ndarray}`` dict (``init_params``, or the pickle of an
        ``export_generative`` artifact); each array is copied as float32
        onto ``device``."""
        dev = resolve_device(device)
        if isinstance(config, dict):
            config = TransformerConfig.from_dict(config)
        missing = [n for n in param_names(config) if n not in params]
        if missing:
            raise ValueError("params dict is missing %s" % missing)
        tensors = {n: torch.tensor(np.asarray(params[n], np.float32),
                                   device=dev)
                   for n in param_names(config)}
        return cls(config, tensors)

    @property
    def params(self):
        """{name: tensor}, the dict the module functions take."""
        return {n: getattr(self, n) for n in param_names(self.config)}

    @property
    def device(self):
        return self.tok_emb.device

    @property
    def kv_spec(self):
        """(num_layers, num_heads, head_dim) of one cached position."""
        c = self.config
        return (c.num_layers, c.num_heads, c.head_dim)

    def forward(self, tokens):
        return forward(self.params, tokens, self.config)

    def draft_propose_fn(self, k):
        """This model as the DRAFT: ``fn(params, k_pages, v_pages,
        block_tables, positions, tokens, active, temperatures, seeds,
        spec_caps)`` -> (drafts, draft_logits) of :func:`draft_propose_step`
        at depth ``k``."""
        cfg = self.config

        def fn(params, k_pages, v_pages, block_tables, positions, tokens,
               active, temperatures, seeds, spec_caps):
            return draft_propose_step(params, k_pages, v_pages,
                                      block_tables, positions, tokens,
                                      active, temperatures, seeds,
                                      spec_caps, k, cfg)
        return fn

    def verify_sample_fn(self):
        """This model as the TARGET: ``fn(params, k_pages, v_pages,
        block_tables, positions, tokens, drafts, draft_logits, active,
        temperatures, seeds, spec_caps)`` -> the packed rows of
        :func:`verify_step_sampled` (k is the drafts' width)."""
        cfg = self.config

        def fn(params, k_pages, v_pages, block_tables, positions, tokens,
               drafts, draft_logits, active, temperatures, seeds,
               spec_caps):
            return verify_step_sampled(params, k_pages, v_pages,
                                       block_tables, positions, tokens,
                                       drafts, draft_logits, active,
                                       temperatures, seeds, spec_caps, cfg)
        return fn
