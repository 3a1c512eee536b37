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
  on the device.

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
same stream.
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
from ..kernels.paged_attention import paged_attention
from ..layers import nn as L
from ..layers import ops as OPS
from ..layers import tensor as T
from ..layers.layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["LN_EPS", "TransformerConfig", "TransformerLM", "param_names",
           "init_params", "params_from_scope", "forward", "prefill_step",
           "decode_step", "device_sample", "decode_step_sampled",
           "prefill_step_sampled", "causal_flash_attention",
           "transformer_block", "transformer_lm"]


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


def prefill_step(params, k_pages, v_pages, tokens, length, pages, config):
    """One prompt (``tokens`` [S_bucket], real length ``length``, an int)
    through the full forward with the flash kernel's causal attention.
    Its K/V are written in place into the pools ``[L, P + 1, T, nh, dh]``
    at the sequence's ``pages`` ([max_blocks], trash-padded); positions
    >= ``length`` go to the trash page. Padding sits after the real
    positions, so causality keeps it out of every real row. Returns the
    logits [V] of the last real position (the head runs on that row
    only: the other rows' logits are never read)."""
    T = k_pages.shape[2]
    trash = k_pages.shape[1] - 1
    x, ks, vs = _forward_hidden(params, tokens[None], config, _kernel_causal)
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    page = torch.where(pos < length, pages.long()[pos // T],
                       torch.full_like(pos, trash))
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
        + F.embedding(pos, params["pos_emb"])
    page = torch.where(active, block_tables[rows, pos // T].long(),
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


def gumbel_noise(seeds, counters, vocab_size):
    """[R, V] standard Gumbel noise, a pure function of each row's
    (seed, counter) and the vocab id, computed on the seeds' device."""
    row = _hash32(_hash32(seeds.long()) ^ counters.long())
    ids = torch.arange(vocab_size, device=seeds.device, dtype=torch.long)
    bits = _hash32(row[:, None] ^ _hash32(ids + 0x9E3779B9)[None, :])
    # 24 random bits -> a uniform strictly inside (0, 1)
    u = ((bits >> 8).double() + 0.5) * (1.0 / (1 << 24))
    return (-torch.log(-torch.log(u))).float()


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
                         temperature, seed, config):
    """:func:`prefill_step` + sampling of the first token on the device,
    its counter being ``length`` (its position in the full sequence).
    Returns (token, logprob) as 0-d tensors."""
    last = prefill_step(params, k_pages, v_pages, tokens, length, pages,
                        config)
    dev = last.device
    toks, logps = device_sample(
        last[None], torch.tensor([temperature], dtype=torch.float32,
                                 device=dev),
        torch.tensor([seed], dtype=torch.int32, device=dev),
        torch.tensor([length], dtype=torch.int32, device=dev))
    return toks[0], logps[0]


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
