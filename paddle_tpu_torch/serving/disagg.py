"""Disaggregated serving: the prefill-tier engine and the KV handoff hop
(counterpart of ``paddle_tpu/serving/disagg.py``).

A prompt pass is one large burst of compute; decoding is a long run of
small memory-bound steps pinned to the KV pool. A disaggregated fleet
gives each its own replicas:

- :class:`PrefillEngine` is the prefill-class replica's engine. It runs
  only the prompt pass, through the same functions as the generation
  engine's prefill (the flash forward kernel, then the first token from
  the same position-keyed stream), copies the written KV pages to the
  host as a :class:`HandoffArtifact` and frees them: its pool holds a
  request for the length of one prefill.
- :class:`HandoffArtifact` is the wire unit: prompt, first token and
  its logprob, sampling parameters, pool geometry and the raw K/V page
  contents. ``to_payload`` / ``from_payload`` give the JAX package's
  JSON body (base64 of the raw little-endian bytes with dtype and
  shape), so either package reads what the other wrote.
- :func:`ship` is the hop, fault site ``serving.ship``: it hands the
  artifact to a decode-class engine's ``submit_prefilled``, which
  installs the pages and decodes from the next position. A failed hop
  never loses the request: the decode engine prefills the prompt again
  (``handoff_failed`` event; the tokens are the same). Overload and
  pool exhaustion on the decode side are backpressure and propagate.

The pages travel through host memory, as in the JAX package; a
device-to-device transport is not part of either.
"""
from __future__ import annotations

import base64
import threading
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .. import profiler as _prof
from ..resilience.events import record_event
from ..resilience.faults import fault_point
from .admission import OverloadError, ServingError
from .batcher import bucket_for, padding_buckets
from .generator import check_request, prefill_first, sample_token
from .kvcache import PagePool, PoolExhausted, pages_for

__all__ = ["HandoffArtifact", "PrefillEngine", "ship", "max_payload_bytes"]

# a payload's JSON around its page arrays: keys, scalars and whitespace
_PAYLOAD_SLACK = 64 * 1024
# the widest JSON of one prompt id: a 10-digit id, its separator and
# some indentation
_ID_CHARS = 24


class HandoffArtifact(object):
    """One finished prefill, packaged for the decode tier: the request
    state that makes the continuation exact (prompt, first sampled token
    and logprob, temperature, seed, budget), the pool geometry the pages
    were written under, and the page contents (``k_pages`` /
    ``v_pages``, numpy ``[L, n_pages, T, nh, dh]``)."""

    __slots__ = ("prompt", "first_token", "first_logprob", "temperature",
                 "seed", "max_new_tokens", "page_tokens", "num_layers",
                 "num_heads", "head_dim", "k_pages", "v_pages")

    def __init__(self, prompt, first_token, first_logprob, temperature,
                 seed, max_new_tokens, page_tokens, num_layers, num_heads,
                 head_dim, k_pages, v_pages):
        self.prompt = [int(t) for t in prompt]
        self.first_token = int(first_token)
        self.first_logprob = (None if first_logprob is None
                              else float(first_logprob))
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.max_new_tokens = int(max_new_tokens)
        self.page_tokens = int(page_tokens)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.k_pages = np.asarray(k_pages)
        self.v_pages = np.asarray(v_pages)

    @property
    def pages(self):
        return int(self.k_pages.shape[1])

    @property
    def kv_bytes(self):
        """Bytes of both page arrays: the hop's payload before
        encoding."""
        return int(self.k_pages.nbytes + self.v_pages.nbytes)

    def to_payload(self):
        """JSON-able dict (the ``:decode`` body): scalars inline, each
        page array as base64 of its raw little-endian bytes with its
        dtype and shape."""
        def pack(a):
            a = np.ascontiguousarray(a)
            return {"dtype": str(a.dtype), "shape": list(a.shape),
                    "data": base64.b64encode(a.tobytes()).decode("ascii")}
        return {"prompt": list(self.prompt),
                "first_token": self.first_token,
                "first_logprob": self.first_logprob,
                "temperature": self.temperature,
                "seed": self.seed,
                "max_new_tokens": self.max_new_tokens,
                "page_tokens": self.page_tokens,
                "num_layers": self.num_layers,
                "num_heads": self.num_heads,
                "head_dim": self.head_dim,
                "k_pages": pack(self.k_pages),
                "v_pages": pack(self.v_pages)}

    @classmethod
    def from_payload(cls, payload):
        """Inverse of :meth:`to_payload`; ValueError on a malformed body
        (the HTTP side answers 400)."""
        def unpack(obj):
            if not isinstance(obj, dict):
                raise ValueError("page block must be {dtype, shape, data}")
            raw = base64.b64decode(obj["data"], validate=True)
            a = np.frombuffer(raw, dtype=np.dtype(obj["dtype"]))
            return a.reshape([int(d) for d in obj["shape"]]).copy()
        if not isinstance(payload, dict):
            raise ValueError("handoff payload must be a JSON object")
        try:
            return cls(payload["prompt"], payload["first_token"],
                       payload.get("first_logprob"),
                       payload.get("temperature", 0.0),
                       payload.get("seed", 0),
                       payload.get("max_new_tokens", 16),
                       payload["page_tokens"], payload["num_layers"],
                       payload["num_heads"], payload["head_dim"],
                       unpack(payload["k_pages"]),
                       unpack(payload["v_pages"]))
        except (KeyError, TypeError) as e:
            raise ValueError("malformed handoff payload: %r" % (e,))


def max_payload_bytes(pool, max_context):
    """The largest JSON body a handoff into ``pool`` (a
    :class:`PagePool`) can need: the float32 K and V pages of a prompt
    that fills ``max_context``, base64-encoded, plus the prompt's ids and
    the rest of the payload. The ``:decode`` route reads no more (for
    GPT-2 small at 1024 positions, about 100 MB)."""
    pages = pages_for(max_context, pool.page_tokens)
    raw = (pool.num_layers * pages * pool.page_tokens * pool.num_heads
           * pool.head_dim * 4)
    return 2 * 4 * -(-raw // 3) + max_context * _ID_CHARS + _PAYLOAD_SLACK


class PrefillEngine(object):
    """The prefill-class replica's engine: prompt pass, first token, page
    export; no decode loop and no long-lived pages. :meth:`prefill` is
    synchronous and serialised under a lock: HTTP threads call it
    concurrently, and the pool tensors are written in place.

    The pool's geometry (``page_tokens``, the model's KV spec) must be
    the decode tier's, or ``submit_prefilled`` refuses the artifact.
    ``kv_pages`` only has to hold the longest prompt (by default one of
    the model's context), since pages are freed once exported.
    ``device`` must be the model's.
    """

    def __init__(self, model, kv_pages=None, page_tokens=None,
                 name="model", eos_id=None, device_sample=None,
                 device=DEFAULT_DEVICE):
        from ..flags import FLAGS
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError("the model lives on %s, not on %s"
                             % (model.device, self.device))
        self.model = model
        self.name = name
        cfg = model.config
        self.eos_id = cfg.eos_id if eos_id is None else int(eos_id)
        self.max_context = int(cfg.max_seq)
        page_tokens = int(page_tokens if page_tokens is not None
                          else FLAGS.serve_page_tokens)
        if kv_pages is None:
            kv_pages = pages_for(self.max_context, page_tokens)
        L, nh, dh = model.kv_spec
        self.pool = PagePool(int(kv_pages), page_tokens, L, nh, dh)
        self._kp, self._vp = self.pool.zeros(self.device)
        self.max_blocks = pages_for(self.max_context, page_tokens)
        self._buckets = padding_buckets(self.max_context)
        self.device_sample = bool(FLAGS.serve_device_sample
                                  if device_sample is None
                                  else device_sample)
        self._lock = threading.Lock()
        self._counts = {"prefills": 0, "prompt_tokens": 0,
                        "exported_pages": 0, "exported_bytes": 0}
        self._busy_s = 0.0
        self._closed = False

    def prefill(self, prompt, max_new_tokens=16, temperature=0.0, seed=0):
        """Run one prompt pass and export it: returns a
        :class:`HandoffArtifact` for :func:`ship`. Pages are allocated
        for the prompt only, copied to the host after the pass and freed
        after the copy. Raises ValueError on an infeasible request and
        :class:`PoolExhausted` when the prompt does not fit the pool, as
        ``submit`` does."""
        if self._closed:
            raise ServingError("prefill engine is closed")
        prompt, max_new_tokens, temperature = check_request(
            prompt, max_new_tokens, temperature,
            self.model.config.vocab_size, self.max_context)
        T = self.pool.page_tokens
        seed_i = int(seed) & 0x7FFFFFFF
        with self._lock:
            pages = self.pool.alloc(pages_for(len(prompt), T))
            row = np.full((self.max_blocks,), self.pool.trash_page,
                          np.int32)
            row[:len(pages)] = pages
            t0 = time.monotonic()
            try:
                S_b = bucket_for(len(prompt), self._buckets)
                padded = np.zeros((S_b,), np.int32)
                padded[:len(prompt)] = prompt
                with torch.no_grad():
                    first = prefill_first(self.model, self._kp, self._vp,
                                          padded, len(prompt), row,
                                          temperature, seed_i,
                                          self.device_sample)
                    if self.device_sample:
                        tok, logp = first
                    else:
                        tok = sample_token(first, temperature,
                                           np.random.RandomState(seed_i))
                        logp = None
                    # the export: .cpu() into pageable host memory waits
                    # for the copy, so the pages are free to reuse after
                    ids = torch.as_tensor(np.asarray(pages, np.int64)).to(
                        self.device)
                    k = self._kp[:, ids].cpu().numpy()
                    v = self._vp[:, ids].cpu().numpy()
            finally:
                self._busy_s += time.monotonic() - t0
                self.pool.free(pages)
            self._counts["prefills"] += 1
            self._counts["prompt_tokens"] += len(prompt)
            self._counts["exported_pages"] += len(pages)
            art = HandoffArtifact(
                prompt, tok, logp, temperature, seed, max_new_tokens, T,
                self.pool.num_layers, self.pool.num_heads,
                self.pool.head_dim, k, v)
            self._counts["exported_bytes"] += art.kv_bytes
        return art

    @property
    def stats(self):
        return dict(self._counts, busy_s=round(self._busy_s, 4),
                    kv_pages=self.pool.num_pages,
                    page_tokens=self.pool.page_tokens)

    def close(self):
        self._closed = True


def ship(artifact, decode_engine, deadline_ms=None):
    """Deliver one handoff into a decode-class engine, fault site
    ``serving.ship``; returns the decode engine's request handle
    (``.wait()`` for the GenResult).

    - A hop failure (the armed fault, a geometry mismatch between the
      tiers, the install raising) re-submits the original prompt to the
      decode engine with ``spec_k=0``, which prefills it again: slower,
      the same tokens (same seed, same position-keyed stream), recorded
      as ``handoff_failed``.
    - ``OverloadError`` and ``PoolExhausted`` from the decode engine's
      admission are backpressure, not hop failures: they propagate to
      the caller.
    """
    try:
        fault_point("serving.ship")
        return decode_engine.submit_prefilled(artifact,
                                              deadline_ms=deadline_ms)
    except (OverloadError, PoolExhausted):
        raise
    except Exception as e:
        _prof.update_generation_counters(gen_handoff_failed=1)
        record_event("handoff_failed", site="serving.ship",
                     model=getattr(decode_engine, "name", "?"),
                     pages=artifact.pages, error=repr(e))
        return decode_engine.submit(
            artifact.prompt, max_new_tokens=artifact.max_new_tokens,
            temperature=artifact.temperature, seed=artifact.seed,
            deadline_ms=deadline_ms, spec_k=0)
