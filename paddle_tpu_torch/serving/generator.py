"""Continuous (iteration-level) batching: the autoregressive engine
(counterpart of ``paddle_tpu/serving/generator.py``).

One engine thread loops; each iteration it

1. **admits** queued prompts into free slots while their page
   reservation fits, running one prefill per admitted prompt (prompt
   lengths padded to power-of-two buckets; the causal attention runs
   through the flash forward kernel),
2. runs **one decode step** for every running sequence at once, at
   whatever positions they are (``models/transformer.decode_step``,
   whose attention reads K/V through the block tables with the
   paged-attention kernel),
3. **samples**, on the device by default (``FLAGS.serve_device_sample``):
   the step returns ``[R]`` tokens and logprobs, packed into one
   ``[2R]`` float32 row, instead of ``[R, V]`` logits; with the flag off
   the host samples from the logits with :func:`sample_token`, and
4. **retires** finished sequences at once, so their slot and pages go
   to the next admission.

Pool exhaustion at submit is a shed; starvation mid-flight (only under
``reserve="prompt"``) preempts the starved sequence back to the head of
the queue, where it later resumes by prefilling prompt + progress
(recompute-on-resume: greedy decode re-derives the same continuation and
the device sampler's stream is keyed by position), or sheds it when
preemption cannot help. An exception in a step fails that step's
sequences and the loop keeps serving.

**Speculative decoding** (``draft_model=`` and ``spec_k``; flags
``serve_draft_dir`` / ``serve_spec_k``): each decode step becomes a
round. A small draft model proposes up to k tokens a row into its own
page pool (``serving/speculative.DraftEngine``), then one target step
over the k + 1 lanes of every row verifies them, accepts the longest
valid prefix and samples the correction on the device
(``models/transformer.verify_step_sampled``, whose attention is the
k-wide face of the paged-attention kernel). Greedy output is the plain
engine's; tempered rows use rejection sampling keyed by position, so a
preempted request replays its history. Rejected lanes cost a page-table
trim (``BlockTable.trim``), never a cache rollback. Fault site
``serving.speculate`` degrades to plain decode with a
``speculation_degraded`` event.

**Prefix sharing** (``prefix_sharing=`` / ``FLAGS.serve_prefix_sharing``,
``serving/prefix.py``): prompt pages are keyed by content and published
to a per-engine cache; a later request whose prompt starts with the
same chunks pins the same physical pages (``PagePool.ref``) and its
prefill writes only the positions past them. Admission discounts the
full pages it will pin, while exhaustion stays priced in physical
pages. The first write into a still-shared page (a generated token in a
shared partial tail page) copies that one page on the device and swaps
it into the table: copy-on-write. Greedy output is the same with
sharing on or off. Fault site ``serving.prefix`` degrades the engine to
private pages with a ``prefix_degraded`` event.

**Disaggregated handoff** (``serving/disagg.py``):
:meth:`GenerationEngine.submit_prefilled` queues a prefill-tier
engine's artifact, whose finished K/V pages the admission installs into
this pool in place of a prefill (:meth:`GenerationEngine._install_handoff`);
the row then decodes from the next position with the preloaded first
token, plainly (``spec_k=0``) and on private pages that are never
published to the prefix cache. A preempted handoff row resumes by
prefilling prompt + progress, as any row does.

Fault site ``serving.generate`` is hit once per prefill or install and
once per decode step or round: a raise fails that request or the
running ones (``generate_failed`` event) and the loop keeps serving.

Besides its own :attr:`GenerationEngine.stats`, the engine bumps the
profiler's generation counters (``profiler.generation_counters()``:
``gen_requests``, ``gen_prefills``, ``gen_decode_steps``,
``gen_tokens``, the sheds, the speculation and prefix counters,
``gen_handoff_installs``, ...) at every site the JAX engine does, the
token counters once a step, never a row; ``gen_kernel_hits`` counts the
decode steps that launched the paged-attention kernel (each step on the
card, none on the CPU).

Left out of this port for now (``ROADMAP.md``): the tune-cache lookup
of the paged attention.

The engine thread drives the card: it makes the model's device current
before its first step, the kernels launch on that thread's current
stream, and every step ends by copying its result to the host, which
waits for the device, so the busy time it records is device time plus
host bookkeeping.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np
import torch

from ..models import transformer as _tm
from .. import profiler as _prof
from ..resilience.events import record_event
from ..resilience.faults import fault_point
from .admission import (AdmissionController, DeadlineExceededError,
                        OverloadError, ServingError)
from .batcher import bucket_for, padding_buckets
from .kvcache import BlockTable, PagePool, PoolExhausted, pages_for
from .prefix import PrefixCache
from .service import _WINDOW, _percentile
from .speculative import DraftEngine

__all__ = ["GenRequest", "GenResult", "GenerationEngine", "sample_token",
           "reference_decode", "prefill_first", "check_request"]

# how many preemptions one request may absorb before the engine calls
# the pool too small for it and sheds instead of thrashing
_PREEMPT_LIMIT = 2


def check_request(prompt, max_new_tokens, temperature, vocab_size,
                  max_context):
    """The checks of one generation request, made on the caller's thread
    by every entry point that takes one (``GenerationEngine.submit`` and
    ``submit_prefilled``, ``PrefillEngine.prefill``): a non-empty prompt
    of ids in [0, V), a budget >= 1, a finite temperature >= 0 and the
    context window. ValueError otherwise: an id out of range would fire
    a device-side assert in the embedding, which ends the process's CUDA
    context, and a NaN temperature reaching the host sampler would fail
    every other in-flight generation of the step. Returns the
    normalised (prompt, max_new_tokens, temperature)."""
    prompt = [int(t) for t in prompt]
    if not prompt:
        raise ValueError("prompt must hold at least one token id")
    if min(prompt) < 0 or max(prompt) >= vocab_size:
        raise ValueError("prompt token ids must be in [0, %d)"
                         % vocab_size)
    max_new_tokens = int(max_new_tokens)
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    temperature = float(temperature or 0.0)
    if not np.isfinite(temperature) or temperature < 0.0:
        raise ValueError("temperature must be finite and >= 0.0, "
                         "got %r" % temperature)
    if len(prompt) + max_new_tokens > max_context:
        raise ValueError(
            "prompt (%d) + max_new_tokens (%d) exceeds the model "
            "context window (%d)" % (len(prompt), max_new_tokens,
                                     max_context))
    return prompt, max_new_tokens, temperature


def sample_token(logits, temperature, rng):
    """One token id from a [V] logits row (numpy): ``temperature <= 0`` is
    greedy (np.argmax); otherwise softmax at ``temperature`` sampled with
    ``rng`` (np.random.RandomState). The JAX package's rule verbatim."""
    logits = np.asarray(logits, np.float64)
    if temperature is None or temperature <= 0.0:
        return int(np.argmax(logits))
    z = (logits - logits.max()) / float(temperature)
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


def prefill_first(model, k_pages, v_pages, padded, length, table_row,
                  temperature, seed, device_sample, covered=0):
    """One prompt pass (``padded`` [S_bucket], real ``length``) into the
    pools at ``table_row``'s pages (positions below ``covered`` are not
    written), the one prefill of the engine and of the prefill tier
    (``serving/disagg.py``). Returns (token, logprob) sampled on the
    device, the token's counter being its position, with
    ``device_sample``; else the [V] logits as numpy."""
    dev = model.device

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

    p, cfg = model.params, model.config
    if device_sample:
        tok, logp = _tm.prefill_step_sampled(
            p, k_pages, v_pages, i32(padded), length, i32(table_row),
            temperature, seed, cfg, covered=covered)
        packed = torch.stack([tok.float(), logp]).cpu()
        return int(packed[0]), float(packed[1])
    return _tm.prefill_step(p, k_pages, v_pages, i32(padded), length,
                            i32(table_row), cfg,
                            covered=covered).cpu().numpy()


def reference_decode(model, prompt, max_new_tokens, temperature=0.0,
                     seed=0, eos_id=None):
    """Sequential full-sequence decode through the plain forward, no
    cache: the slow, obviously-correct decoder the engine is held
    against (greedy outputs must be token-identical)."""
    if eos_id is None:
        eos_id = model.config.eos_id
    toks = [int(t) for t in prompt]
    out = []
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for _ in range(int(max_new_tokens)):
            ids = torch.tensor([toks], dtype=torch.int32,
                               device=model.device)
            logits = model(ids)[0, -1].cpu().numpy()
            t = sample_token(logits, temperature, rng)
            out.append(t)
            toks.append(t)
            if eos_id is not None and t == eos_id:
                break
    return out


class GenResult(object):
    """What a finished generation resolves to. ``logprobs`` (the
    untempered log-softmax at each chosen token) is filled on the
    device-sampling path and None on the host path."""

    __slots__ = ("tokens", "finish_reason", "ttft_ms", "latency_ms",
                 "preemptions", "logprobs")

    def __init__(self, tokens, finish_reason, ttft_ms, latency_ms,
                 preemptions, logprobs=None):
        self.tokens = tokens
        self.finish_reason = finish_reason
        self.ttft_ms = ttft_ms
        self.latency_ms = latency_ms
        self.preemptions = preemptions
        self.logprobs = logprobs

    def describe(self):
        out = {"tokens": list(self.tokens),
               "finish_reason": self.finish_reason,
               "ttft_ms": round(self.ttft_ms, 3),
               "latency_ms": round(self.latency_ms, 3),
               "preemptions": self.preemptions}
        if self.logprobs is not None:
            out["logprobs"] = [round(lp, 6) for lp in self.logprobs]
        return out


class GenRequest(object):
    """One queued or running generation; resolves to a :class:`GenResult`.
    Sampled tokens accumulate here, so a preempted request carries its
    progress back through the queue and resumes from prompt + progress."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "seed",
                 "deadline_t", "enqueue_t", "tokens", "logprobs",
                 "preemptions", "model_version", "spec_k", "handoff",
                 "_rng", "_ttft_ms", "_done", "_result", "_error")

    def __init__(self, prompt, max_new_tokens, temperature=0.0, seed=0,
                 deadline_t=None, spec_k=None):
        self.prompt = [int(t) for t in prompt]
        # the request's cap on the speculation depth (None: the engine's;
        # 0: plain decode). Part of the request's identity: a resumed
        # preemption derives the same round boundaries from it
        self.spec_k = None if spec_k is None else int(spec_k)
        # stamped by InferenceService.generate_async
        self.model_version = None
        # a disaggregated handoff artifact (serving/disagg.py) whose pages
        # the admission installs in place of a prefill; cleared once
        # installed, so a preempted request resumes by prefilling
        self.handoff = None
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature or 0.0)
        self.seed = int(seed or 0)
        self.deadline_t = deadline_t
        self.enqueue_t = time.monotonic()
        self.tokens = []
        self.logprobs = []
        self.preemptions = 0
        self._rng = np.random.RandomState(self.seed)
        self._ttft_ms = None
        self._done = threading.Event()
        self._result = None
        self._error = None

    @property
    def budget_left(self):
        return self.max_new_tokens - len(self.tokens)

    @property
    def pending_prompt(self):
        """What a (re)prefill must feed: original prompt + progress."""
        return self.prompt + self.tokens

    def resolve(self, finish_reason):
        self._result = GenResult(
            list(self.tokens), finish_reason,
            self._ttft_ms if self._ttft_ms is not None else 0.0,
            (time.monotonic() - self.enqueue_t) * 1e3, self.preemptions,
            logprobs=(list(self.logprobs)
                      if len(self.logprobs) == len(self.tokens)
                      else None))
        self._done.set()

    def fail(self, exc):
        self._error = exc
        self._done.set()

    @property
    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block for the :class:`GenResult`; re-raises shed/step errors."""
        if not self._done.wait(timeout):
            raise TimeoutError("generation still pending after %.3fs"
                               % (timeout,))
        if self._error is not None:
            raise self._error
        return self._result


class _Running(object):
    """One occupied engine slot."""

    __slots__ = ("req", "slot", "table", "cached", "last_token", "last_t",
                 "spec_cap")

    def __init__(self, req, slot, table):
        self.req = req
        self.slot = slot
        self.table = table
        self.cached = 0          # positions written into the paged cache
        self.last_token = None   # next decode step's input token
        self.last_t = time.monotonic()
        self.spec_cap = 0        # draft lanes this row runs this round


class GenerationEngine(object):
    """The per-model generation engine: a paged KV pool on the model's
    device and one engine thread running admit/decode/sample/retire.

    ``reserve``, the admission policy:

    - ``"full"`` (default): admission reserves pages for prompt +
      max_new_tokens, so a running sequence never starves mid-flight;
    - ``"prompt"``: admission reserves the prompt only and pages are
      taken at block boundaries; starvation preempts
      (recompute-on-resume).

    ``device_sample``: sample on the device (None reads
    ``FLAGS.serve_device_sample``). ``draft_model`` and ``spec_k``:
    speculative decoding with that draft at that depth (``spec_k`` None
    reads ``FLAGS.serve_spec_k``); it needs device sampling. A draft
    that cannot be built degrades to plain decode with a recorded
    ``speculation_degraded`` event. ``prefix_sharing``: copy-on-write
    prefix sharing (None reads ``FLAGS.serve_prefix_sharing``). Knobs
    left None read the ``FLAGS.serve_*`` defaults.
    """

    def __init__(self, model, max_running=None, kv_pages=None,
                 page_tokens=None, queue_depth=None, reserve="full",
                 eos_id=None, name="model", warm=False, device_sample=None,
                 draft_model=None, spec_k=None, prefix_sharing=None):
        from ..flags import FLAGS
        if reserve not in ("full", "prompt"):
            raise ValueError("reserve must be 'full' or 'prompt'")
        self.model = model
        self.name = name
        self.reserve = reserve
        self.device = model.device
        # a decode step on the card launches the paged-attention kernel
        # (ROADMAP.md Queue 3 #5); the profiler's gen_kernel_hits counts
        # those steps, 0 on the CPU's plain version
        self._kernel_hit = 1 if torch.device(self.device).type == "cuda" \
            else 0
        self.max_running = int(max_running if max_running is not None
                               else FLAGS.serve_max_running)
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else FLAGS.serve_queue_depth)
        page_tokens = int(page_tokens if page_tokens is not None
                          else FLAGS.serve_page_tokens)
        kv_pages = int(kv_pages if kv_pages is not None
                       else FLAGS.serve_kv_pages)
        cfg = model.config
        self.eos_id = cfg.eos_id if eos_id is None else int(eos_id)
        self.max_context = int(cfg.max_seq)
        self.max_blocks = pages_for(self.max_context, page_tokens)
        L, nh, dh = model.kv_spec
        self.pool = PagePool(kv_pages, page_tokens, L, nh, dh)
        self._kp, self._vp = self.pool.zeros(self.device)
        # copy-on-write prefix sharing: a cache over THIS pool; a failed
        # build (fault site serving.prefix) degrades to private pages
        if prefix_sharing is None:
            prefix_sharing = bool(FLAGS.serve_prefix_sharing)
        self._prefix = None
        self._prefix_degraded = False
        if prefix_sharing:
            try:
                self._prefix = PrefixCache(self.pool, name=name)
            except Exception as e:
                self._prefix_degraded = True
                record_event("prefix_degraded", site="serving.prefix",
                             model=name, phase="build", error=repr(e))
        self.device_sample = bool(FLAGS.serve_device_sample
                                  if device_sample is None
                                  else device_sample)
        self._sample_meta = None   # cached (temps, seeds) device copies
        self._buckets = padding_buckets(self.max_context)
        # speculative decoding: a DraftEngine (its own pool and propose
        # step) and the target's verify step. Verification IS device
        # sampling, so it needs that path; any failure here (an armed
        # serving.speculate site included) degrades to plain decode
        if spec_k is None:
            spec_k = int(FLAGS.serve_spec_k)
        self.spec_k = int(spec_k) if draft_model is not None else 0
        self._spec = None
        self._spec_degraded = False
        self._verify = None
        if draft_model is not None and self.spec_k >= 1:
            try:
                if not self.device_sample:
                    raise ServingError(
                        "speculative decoding needs device sampling, "
                        "which is off on this engine")
                self._spec = DraftEngine(
                    draft_model, self.spec_k, cfg, kv_pages, page_tokens,
                    self.max_context, self._buckets, self.device,
                    name=name)
                self._verify = model.verify_sample_fn()
            except Exception as e:
                self._spec = None
                self._spec_degraded = True
                record_event("speculation_degraded",
                             site="serving.speculate", model=name,
                             phase="build", error=repr(e))
        self._queue = collections.deque()
        self._seqs = []            # _Running, slot-ordered
        self._admitting = 0        # popped from the queue, prefill underway
        self._free_slots = list(range(self.max_running))
        self._cond = threading.Condition()
        self._alive = True
        self._draining = False
        self._counts = collections.Counter()
        self._busy_s = 0.0
        self._occupancy_sum = 0
        self._max_running_seen = 0
        self._page_util_max = 0.0
        self._ttft_ms = collections.deque(maxlen=_WINDOW)
        self._intertoken_ms = collections.deque(maxlen=_WINDOW)
        # warm before the engine thread exists: both touch the pool
        self.warmup_ms = self.warm_up() if warm else 0.0
        self._thread = threading.Thread(
            target=self._loop, name="paddle_tpu_torch-generate-" + name,
            daemon=True)
        self._thread.start()

    # -- device operands ------------------------------------------------------
    def _i32(self, a):
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _sample_operands(self, temps, seeds):
        """Device copies of the rows' temperatures and seeds, cached: they
        change only when the running set does."""
        cached = self._sample_meta
        if (cached is None or not np.array_equal(temps, cached[0])
                or not np.array_equal(seeds, cached[1])):
            cached = (temps, seeds,
                      torch.as_tensor(temps).to(self.device),
                      self._i32(seeds))
            self._sample_meta = cached
        return cached[2], cached[3]

    def _prefill(self, padded, length, table_row, temperature, seed,
                 covered=0):
        """:func:`prefill_first` into this engine's pools."""
        return prefill_first(self.model, self._kp, self._vp, padded, length,
                             table_row, temperature, seed,
                             self.device_sample, covered=covered)

    def warm_up(self, buckets=None):
        """Run every prefill bucket and one decode step (and, when
        speculative, the draft's prefills, one propose and one verify)
        with all-trash block tables, so the kernels are built and loaded
        before the first request; the writes land on the trash page only.
        Returns the wall time in ms. Call before the engine thread starts
        (the constructor's ``warm=True``)."""
        t0 = time.monotonic()
        trash_row = np.full((self.max_blocks,), self.pool.trash_page,
                            np.int32)
        with torch.no_grad():
            for S_b in (self._buckets if buckets is None else buckets):
                self._prefill(np.zeros((S_b,), np.int32), 1, trash_row,
                              0.0, 0)
            R = self.max_running
            tables = np.tile(trash_row, (R, 1))
            zeros_i = np.zeros((R,), np.int32)
            self._decode(tables, zeros_i, zeros_i, np.zeros((R,), bool),
                         np.zeros((R,), np.float32), zeros_i)
            if self._spec is not None:
                try:
                    drafts, dlogits = self._spec.warm(R)
                    z = self._i32(zeros_i)
                    self._verify(
                        self.model.params, self._kp, self._vp,
                        self._i32(tables), z, z, drafts, dlogits,
                        torch.zeros((R,), dtype=torch.bool,
                                    device=self.device),
                        torch.zeros((R,), dtype=torch.float32,
                                    device=self.device), z, z).cpu()
                except Exception as e:
                    self._degrade_spec("warm", e)
        return (time.monotonic() - t0) * 1e3

    # -- submit side ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, temperature=0.0, seed=0,
               deadline_ms=None, spec_k=None):
        """Queue one prompt; returns the :class:`GenRequest` handle.
        Sheds now when the queue is full, the request could never fit
        the pool, or it exceeds the model's context window. ``spec_k``
        caps this request's speculation depth (0: plain decode)."""
        prompt, max_new_tokens, temperature = check_request(
            prompt, max_new_tokens, temperature,
            self.model.config.vocab_size, self.max_context)
        if spec_k is not None:
            spec_k = int(spec_k)
            if spec_k < 0:
                raise ValueError("spec_k must be >= 0 (0 disables "
                                 "speculation for this request)")
        req = GenRequest(prompt, max_new_tokens, temperature, seed,
                         AdmissionController.deadline_from(deadline_ms),
                         spec_k=spec_k)
        return self._enqueue(req)

    def _enqueue(self, req):
        """The submit tail shared by :meth:`submit` and
        :meth:`submit_prefilled`: the pool-feasibility shed (in physical
        pages), the liveness, drain and queue-depth checks, the append."""
        total = len(req.pending_prompt) + req.budget_left
        if not self.pool.can_fit(total):
            record_event("kv_pool_exhausted", site="serving.generate",
                         action="shed", model=self.name,
                         want_pages=pages_for(total, self.pool.page_tokens),
                         pool_pages=self.pool.num_pages)
            with self._cond:
                self._counts["shed_pool"] += 1
            self._update_prof(gen_shed_pool=1)
            raise PoolExhausted(
                "request needs %d token(s) of cache; the pool holds %d "
                "(serve_kv_pages=%d x serve_page_tokens=%d) — shed "
                "instead of wedging the engine"
                % (total, self.pool.num_pages * self.pool.page_tokens,
                   self.pool.num_pages, self.pool.page_tokens))
        with self._cond:
            if not self._alive:
                raise ServingError("generation engine is closed")
            if self._draining:
                raise ServingError(
                    "generation engine is draining — resubmit to the "
                    "replacement engine")
            if len(self._queue) >= self.queue_depth:
                self._counts["shed_overload"] += 1
                self._update_prof(gen_shed_overload=1)
                raise OverloadError(
                    "generation queue full (%d pending >= queue_depth="
                    "%d); request shed — retry with backoff or raise "
                    "FLAGS.serve_queue_depth"
                    % (len(self._queue), self.queue_depth))
            self._counts["submitted"] += 1
            self._queue.append(req)
            self._cond.notify_all()
        self._update_prof(gen_requests=1)
        return req

    def submit_prefilled(self, artifact, deadline_ms=None):
        """Queue a disaggregated handoff (``serving/disagg.py``): the
        artifact carries a prefill-tier engine's finished K/V pages and
        the request state that makes the continuation exact (first token
        and logprob, temperature, seed: the position-keyed device stream
        needs nothing else). The admission installs the pages instead of
        prefilling. The request runs plain (``spec_k=0``): the draft's
        pool never saw the prompt. Resolves at once when the first token
        is ``eos`` or the budget is 1; otherwise sheds as :meth:`submit`
        does. A geometry other than this pool's raises
        :class:`ServingError`. The artifact comes off the network, so it
        gets :meth:`submit`'s checks on the caller's thread, and its
        first token must be in [0, V) and its pages exactly the prompt's
        (fewer would decode over pages it never wrote): ValueError
        otherwise."""
        pool = self.pool
        if (int(artifact.page_tokens) != pool.page_tokens
                or int(artifact.num_layers) != pool.num_layers
                or int(artifact.num_heads) != pool.num_heads
                or int(artifact.head_dim) != pool.head_dim):
            raise ServingError(
                "handoff artifact geometry (layers=%s heads=%s "
                "head_dim=%s page_tokens=%s) does not match this "
                "engine's pool (layers=%d heads=%d head_dim=%d "
                "page_tokens=%d) — the tiers must serve the same model "
                "geometry" % (artifact.num_layers, artifact.num_heads,
                              artifact.head_dim, artifact.page_tokens,
                              pool.num_layers, pool.num_heads,
                              pool.head_dim, pool.page_tokens))
        V = self.model.config.vocab_size
        prompt, max_new_tokens, temperature = check_request(
            artifact.prompt, artifact.max_new_tokens, artifact.temperature,
            V, self.max_context)
        first = int(artifact.first_token)
        if not 0 <= first < V:
            raise ValueError("handoff first token %d is not in [0, %d)"
                             % (first, V))
        n = pages_for(len(prompt), pool.page_tokens)
        if any(a.ndim != 5 or a.shape[1] != n
               for a in (artifact.k_pages, artifact.v_pages)):
            raise ValueError(
                "handoff pages %r/%r do not hold the %d page(s) of a "
                "%d-token prompt" % (artifact.k_pages.shape,
                                     artifact.v_pages.shape, n,
                                     len(prompt)))
        req = GenRequest(prompt, max_new_tokens, temperature,
                         int(artifact.seed),
                         AdmissionController.deadline_from(deadline_ms),
                         spec_k=0)
        req.tokens = [first]
        if artifact.first_logprob is not None:
            req.logprobs = [float(artifact.first_logprob)]
        eos = self.eos_id is not None and req.tokens[0] == self.eos_id
        if eos or req.budget_left <= 0:
            # the prefill tier's one token already finished the request
            with self._cond:
                self._counts["submitted"] += 1
                self._counts["completed"] += 1
            self._update_prof(gen_requests=1, gen_completed=1)
            req._ttft_ms = 0.0
            req.resolve("eos" if eos else "length")
            return req
        req.handoff = artifact
        return self._enqueue(req)

    def generate(self, prompt, max_new_tokens=16, temperature=0.0, seed=0,
                 deadline_ms=None, timeout=None, spec_k=None):
        """Blocking convenience: submit + wait -> :class:`GenResult`."""
        return self.submit(prompt, max_new_tokens, temperature, seed,
                           deadline_ms, spec_k=spec_k).wait(timeout)

    # -- engine loop ---------------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            while True:
                with self._cond:
                    while self._alive and not self._queue and \
                            not self._seqs:
                        self._cond.wait(0.1)
                    if not self._alive:
                        return
                try:
                    self._admit()
                    if self._seqs:
                        self._step()
                    else:
                        # queued work that cannot admit yet: block
                        # briefly instead of spinning the admission check
                        with self._cond:
                            if self._alive and self._queue:
                                self._cond.wait(0.01)
                except Exception as e:
                    # an engine-thread bug fails the running requests; it
                    # never leaves a silently dead loop
                    self._fail_running(e)

    @property
    def draining(self):
        with self._cond:
            return self._draining

    def drain(self, timeout=None):
        """Stop accepting submits and wait for the queue and the running
        set to empty. Returns True when drained, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._draining = True
            while self._alive and (self._queue or self._seqs
                                   or self._admitting):
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                self._cond.wait(0.05)
            return not (self._queue or self._seqs or self._admitting)

    def close(self):
        """Stop the engine; queued and running requests fail with
        :class:`ServingError` (idempotent). Call :meth:`drain` first for
        a graceful stop."""
        with self._cond:
            if not self._alive:
                return
            self._alive = False
            orphans = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for r in orphans:
            r.fail(ServingError("generation engine shut down before "
                                "dispatch"))
        if self._thread.is_alive() and \
                threading.current_thread() is not self._thread:
            self._thread.join(timeout=10.0)
        for s in list(self._seqs):
            s.table.release()
            if not s.req.done:
                s.req.fail(ServingError("generation engine shut down "
                                        "mid-flight"))
        del self._seqs[:]
        if self._spec is not None:
            self._spec.close()
            self._spec = None
        if self._prefix is not None:
            self._prefix.clear()
            self._prefix = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- admission ------------------------------------------------------------
    def _reserve_tokens(self, req):
        """Cache positions ``req`` needs up front, the one encoding of the
        reserve policy: ``full`` holds the whole budget, ``prompt`` only
        the prefill."""
        if self.reserve == "full":
            return len(req.pending_prompt) + req.budget_left
        return len(req.pending_prompt)

    def _reservation(self, req):
        """Pages admission must see free before ``req`` may start, in
        effective pages: leading full prompt pages already cached will be
        pinned, not allocated. A cached partial tail page is not
        discounted, since copy-on-write buys it back at the first
        generated token."""
        pages = pages_for(self._reserve_tokens(req), self.pool.page_tokens)
        if req.handoff is None and self._prefix is not None:
            pages -= self._prefix.probe(req.pending_prompt)
        return max(pages, 0)

    def _admit(self):
        """Move queued requests into free slots while their reservation
        fits (FIFO: a big head request waits rather than starves)."""
        while True:
            with self._cond:
                if not self._queue or not self._free_slots:
                    return
                req = self._queue[0]
                if AdmissionController.expired(req):
                    self._queue.popleft()
                    self._shed_deadline(req)
                    continue
                need = self._reservation(req)
                if need > self.pool.available and self._prefix is not None:
                    # pages only the cache pins come back here too: an
                    # idle engine never allocates, so the pool's own hook
                    # would never fire
                    self._prefix.reclaim(need - self.pool.available,
                                         keep=req.pending_prompt)
                if need > self.pool.available:
                    return
                self._queue.popleft()
                slot = self._free_slots.pop(0)
                self._admitting += 1
            try:
                self._start(req, slot)
            except PoolExhausted as e:
                with self._cond:
                    self._queue.appendleft(req)
                    self._free_slots.insert(0, slot)
                    self._free_slots.sort()
                record_event("kv_pool_exhausted", site="serving.generate",
                             action="requeue", model=self.name,
                             error=repr(e))
                return
            finally:
                with self._cond:
                    self._admitting -= 1
                    self._cond.notify_all()

    def _start(self, req, slot):
        """Prefill ``req`` into its block table and take its first token;
        may retire it at once (budget 1 or eos). The first token's
        sampling counter is its position in the full sequence, so a
        resumed request continues its stream. With prefix sharing the
        table starts with the pages of the longest cached run of the
        prompt, which the prefill does not write; the prompt's pages are
        published after it. A handoff request installs its artifact's
        pages instead, on private pages, and skips the prefix cache and
        the draft's prompt mirror."""
        prompt = req.pending_prompt
        handoff = req.handoff
        table = BlockTable(self.pool)
        matched = covered = 0
        if handoff is None and self._prefix is not None:
            try:
                shared, covered = self._prefix.match(prompt)
                table.pages.extend(shared)
                matched = len(shared)
            except Exception as e:
                self._degrade_prefix("match", e)
        try:
            table.ensure(self._reserve_tokens(req))
        except PoolExhausted:
            table.release()   # drops the prefix pins too
            raise
        if self._spec is not None:
            # the draft's reservation: admit on both pools or on neither
            try:
                self._spec.ensure_slot(slot, self._reserve_tokens(req))
            except PoolExhausted:
                self._spec.release_slot(slot)
                table.release()
                raise
        if matched:
            with self._cond:
                self._counts["prefix_hits"] += matched
                self._counts["prefix_hit_requests"] += 1
            self._update_prof(gen_prefix_hits=matched)
        S_b = bucket_for(len(prompt), self._buckets)
        padded = np.zeros((S_b,), np.int32)
        padded[:len(prompt)] = prompt
        t0 = time.monotonic()
        try:
            fault_point("serving.generate")
            if handoff is not None:
                self._install_handoff(table, handoff)
            else:
                first = self._prefill(padded, len(prompt),
                                      table.as_row(self.max_blocks),
                                      req.temperature,
                                      req.seed & 0x7FFFFFFF,
                                      covered=covered)
        except Exception as e:
            table.release()
            if self._spec is not None:
                self._spec.release_slot(slot)
            with self._cond:
                self._free_slots.append(slot)
                self._free_slots.sort()
                self._counts["failed"] += 1
            record_event("generate_failed", site="serving.generate",
                         model=self.name, phase="prefill", error=repr(e))
            self._update_prof(gen_failed=1)
            req.fail(e)
            return
        self._busy_s += time.monotonic() - t0
        if handoff is None and self._spec is not None:
            # the draft mirrors the prompt into its own pool; a failure
            # degrades speculation engine-wide and the request runs
            # plain. A handoff row runs spec_k=0, so its draft lanes
            # never propose and the draft never needs its prompt
            try:
                self._spec.prefill(slot, padded, len(prompt))
            except Exception as e:
                self._degrade_spec("prefill", e)
        if handoff is None and self._prefix is not None:
            try:
                published = self._prefix.publish(prompt, table.pages)
            except Exception as e:
                self._degrade_prefix("publish", e)
            else:
                if published:
                    with self._cond:
                        self._counts["prefix_published"] += published
                    self._update_prof(gen_prefix_published=published)
        run = _Running(req, slot, table)
        run.cached = len(prompt)
        # A resumed request on a speculative engine drops the prefill's
        # draw: its stream's token at the resume position came from an
        # accept or residual draw (another salt), so the row re-enters
        # the rounds pending its last token, and the next round replays
        # the same draws (caps are pure functions of request and
        # progress)
        resumed_spec = (handoff is None and self._spec is not None
                        and len(req.tokens) > 0)
        if handoff is not None:
            # the pages cover the original prompt; pending already holds
            # the prefill tier's first token, so the next decode step
            # writes that token's K/V at position len(prompt) and the
            # stream continues where a local prefill would have left it
            run.cached = len(prompt) - len(req.tokens)
            run.last_token = req.tokens[-1]
            req.handoff = None    # a preemption resumes by re-prefill
        elif resumed_spec:
            run.cached = len(prompt) - 1
            run.last_token = req.tokens[-1]
        with self._cond:
            if handoff is not None:
                self._counts["handoff_installs"] += 1
            else:
                self._counts["prefills"] += 1
                self._counts["prompt_tokens"] += len(prompt)
                if not resumed_spec:
                    self._counts["tokens"] += 1
            self._seqs.append(run)
            self._seqs.sort(key=lambda s: s.slot)
            self._max_running_seen = max(self._max_running_seen,
                                         len(self._seqs))
            running = len(self._seqs)
        if handoff is not None:
            self._update_prof(gen_handoff_installs=1,
                              gen_max_running=running)
            return
        if resumed_spec:
            self._update_prof(gen_prefills=1, gen_max_running=running)
            return
        if self.device_sample:
            self._update_prof(gen_prefills=1, gen_tokens=1,
                              gen_max_running=running)
            self._record_token(run, first[0], first[1])
        else:
            self._update_prof(gen_prefills=1, gen_tokens=1,
                              gen_max_running=running,
                              gen_host_logit_syncs=1)
            with self._cond:
                self._counts["host_logit_syncs"] += 1
            self._accept_token(run, first)

    # -- the decode step -------------------------------------------------------
    def _decode(self, tables, positions, tokens, active, temps, seeds):
        """One decode step on host arrays; returns (tokens [R] int32,
        logprobs [R] f32) on the device-sampling path, else the [R, V]
        logits as numpy."""
        p = self.model.params
        cfg = self.model.config
        args = (p, self._kp, self._vp, self._i32(tables),
                self._i32(positions), self._i32(tokens),
                torch.as_tensor(active).to(self.device))
        if not self.device_sample:
            return _tm.decode_step(*args, cfg).cpu().numpy()
        toks, logps = _tm.decode_step_sampled(
            *args, *self._sample_operands(temps, seeds), cfg)
        # one [2R] float32 row crosses to the host (tokens are exact in
        # float32 up to a vocab of 2**24)
        packed = torch.cat([toks.float(), logps]).cpu().numpy()
        R = toks.shape[0]
        return packed[:R].astype(np.int32), packed[R:]

    def _step(self):
        if self._spec is not None:
            self._step_spec()
            return
        self._grow_tables()
        seqs = list(self._seqs)
        if not seqs:
            return
        R, MB = self.max_running, self.max_blocks
        tables = np.full((R, MB), self.pool.trash_page, np.int32)
        positions = np.zeros((R,), np.int32)
        tokens = np.zeros((R,), np.int32)
        active = np.zeros((R,), bool)
        temps = np.zeros((R,), np.float32)
        seeds = np.zeros((R,), np.int32)
        for s in seqs:
            tables[s.slot] = s.table.as_row(MB)
            positions[s.slot] = s.cached
            tokens[s.slot] = s.last_token
            active[s.slot] = True
            temps[s.slot] = s.req.temperature
            seeds[s.slot] = s.req.seed & 0x7FFFFFFF
        t0 = time.monotonic()
        try:
            fault_point("serving.generate")
            out = self._decode(tables, positions, tokens, active, temps,
                               seeds)
        except Exception as e:
            self._fail_running(e)
            return
        self._busy_s += time.monotonic() - t0
        util = self.pool.utilization()["frac"]
        with self._cond:
            self._counts["decode_steps"] += 1
            self._counts["tokens"] += len(seqs)
            self._counts["device_sample_steps" if self.device_sample
                         else "host_logit_syncs"] += 1
            self._occupancy_sum += len(seqs)
            self._page_util_max = max(self._page_util_max, util)
        # the profiler's token counters flush once a step, never a row
        prof = {"gen_decode_steps": 1, "gen_page_util_max": util,
                "gen_tokens": len(seqs), "gen_kernel_hits": self._kernel_hit}
        prof["gen_device_sample_steps" if self.device_sample
             else "gen_host_logit_syncs"] = 1
        self._update_prof(**prof)
        for s in seqs:
            s.cached += 1
            if self.device_sample:
                self._record_token(s, int(out[0][s.slot]),
                                   float(out[1][s.slot]))
            else:
                self._accept_token(s, out[s.slot])

    def _grow_tables(self):
        """Make room for each running row's next position, copying a
        still-shared page the write would land in; starvation preempts
        (or sheds, when preemption cannot help)."""
        for s in list(self._seqs):
            try:
                s.table.ensure(s.cached + 1)
                self._unshare_for_write(s.table, s.cached, s.cached + 1)
            except PoolExhausted:
                self._starved(s)

    def _starved(self, s):
        if len(self._seqs) > 1 and s.req.preemptions < _PREEMPT_LIMIT:
            self._preempt(s)
        else:
            self._shed_pool(s)

    # -- the speculative round ----------------------------------------------
    def _grow_tables_spec(self):
        """Grow both pools to each row's round window ``cached + cap +
        1``, where ``cap``, the draft lanes the row runs this round, is a
        pure function of the request and its progress (the engine's k,
        the request's, the budget left, the context). That purity lets a
        resumed request replay its tempered stream; so starvation
        preempts or sheds, and never shrinks a row's cap."""
        for s in list(self._seqs):
            req_k = (s.req.spec_k if s.req.spec_k is not None
                     else self.spec_k)
            cap = max(0, min(self.spec_k, req_k, s.req.budget_left - 1,
                             self.max_context - 1 - s.cached))
            try:
                s.table.ensure(s.cached + cap + 1)
                self._spec.ensure_slot(s.slot, s.cached + cap + 1)
                # the verify step writes positions cached .. cached + cap
                self._unshare_for_write(s.table, s.cached,
                                        s.cached + cap + 1)
            except PoolExhausted:
                self._starved(s)
                continue
            s.spec_cap = cap

    def _step_spec(self):
        """One speculative round for the running batch: the draft
        proposes up to k tokens a row, the target verifies every lane in
        one step, and one packed row crosses to the host; then each row
        takes its accepted tokens and the correction or bonus token, and
        the pages past its accepted point go back to both pools. A
        propose failure degrades speculation and skips the round (the
        loop steps plain next); a verify failure fails the running rows
        as a plain step's failure does."""
        self._grow_tables_spec()
        seqs = list(self._seqs)
        if not seqs:
            return
        spec = self._spec
        R, MB = self.max_running, self.max_blocks
        K1 = self.spec_k + 1
        tables = np.full((R, MB), self.pool.trash_page, np.int32)
        dtables = np.full((R, spec.max_blocks), spec.pool.trash_page,
                          np.int32)
        positions = np.zeros((R,), np.int32)
        tokens = np.zeros((R,), np.int32)
        active = np.zeros((R,), bool)
        temps = np.zeros((R,), np.float32)
        seeds = np.zeros((R,), np.int32)
        caps = np.zeros((R,), np.int32)
        for s in seqs:
            tables[s.slot] = s.table.as_row(MB)
            dtables[s.slot] = spec.row(s.slot)
            positions[s.slot] = s.cached
            tokens[s.slot] = s.last_token
            active[s.slot] = True
            temps[s.slot] = s.req.temperature
            seeds[s.slot] = s.req.seed & 0x7FFFFFFF
            caps[s.slot] = s.spec_cap
        t0 = time.monotonic()
        try:
            fault_point("serving.generate")
            temps_d, seeds_d = self._sample_operands(temps, seeds)
            pos_d = self._i32(positions)
            tok_d = self._i32(tokens)
            act_d = torch.as_tensor(active).to(self.device)
            caps_d = self._i32(caps)
            try:
                drafts, dlogits = spec.propose(
                    self._i32(dtables), pos_d, tok_d, act_d, temps_d,
                    seeds_d, caps_d)
            except Exception as pe:
                self._degrade_spec("propose", pe)
                return
            packed = self._verify(
                self.model.params, self._kp, self._vp, self._i32(tables),
                pos_d, tok_d, drafts, dlogits, act_d, temps_d, seeds_d,
                caps_d).cpu().numpy()
        except Exception as e:
            self._fail_running(e)
            return
        self._busy_s += time.monotonic() - t0
        tok_rows = packed[:, :K1].astype(np.int32)
        n_out = packed[:, K1].astype(np.int32)
        logp_rows = packed[:, K1 + 1:]
        drafted = int(sum(s.spec_cap for s in seqs))
        accepted = int(sum(max(int(n_out[s.slot]) - 1, 0) for s in seqs))
        consumed = 0
        now = time.monotonic()
        for s in seqs:
            n = int(n_out[s.slot])
            # a round's tokens land together: each takes an even share
            # of the row's gap, so the inter-token statistics read per
            # token as a plain step's do
            gap_ms = (now - s.last_t) * 1e3 / max(n, 1)
            for j in range(n):
                if s.req.done:
                    break   # retired mid-round; the rest is discarded
                s.cached += 1
                consumed += 1
                self._record_token(s, int(tok_rows[s.slot, j]),
                                   float(logp_rows[s.slot, j]), gap_ms)
            if s.req.done:
                continue
            # pages past the accepted point (and the reserve policy's
            # floor) go back to both pools before the next admission
            floor = max(s.cached + 1, self._reserve_tokens(s.req))
            s.table.trim(floor)
            spec.trim_slot(s.slot, floor)
        util = self.pool.utilization()["frac"]
        with self._cond:
            self._counts["decode_steps"] += 1
            self._counts["spec_steps"] += 1
            self._counts["tokens"] += consumed
            self._counts["draft_tokens"] += drafted
            self._counts["accepted_tokens"] += accepted
            self._counts["device_sample_steps"] += 1
            self._occupancy_sum += len(seqs)
            self._page_util_max = max(self._page_util_max, util)
        self._update_prof(
            gen_decode_steps=1, gen_page_util_max=util,
            gen_tokens=consumed, gen_kernel_hits=self._kernel_hit,
            gen_device_sample_steps=1, gen_spec_steps=1,
            gen_draft_tokens=drafted, gen_accepted_tokens=accepted)

    def _degrade_spec(self, phase, exc):
        """Speculation failed (fault site ``serving.speculate``): drop the
        draft engine and keep serving plain decode. Running rows are
        unharmed: the draft pool is the only state a draft failure can
        consume, and the target's cache never depended on it."""
        spec = self._spec
        if spec is None:
            return
        self._spec = None
        self._spec_degraded = True
        try:
            spec.close()
        except Exception:
            pass
        record_event("speculation_degraded", site="serving.speculate",
                     model=self.name, phase=phase, error=repr(exc))
        self._update_prof(gen_spec_degraded=1)

    def _degrade_prefix(self, phase, exc):
        """Prefix sharing failed (fault site ``serving.prefix``): drop
        the cache and keep serving private pages. Tables that already
        share pages keep them; :meth:`_unshare_for_write` runs whether
        the cache is there or not."""
        cache = self._prefix
        if cache is None:
            return
        self._prefix = None
        self._prefix_degraded = True
        try:
            cache.clear()
        except Exception:
            pass
        record_event("prefix_degraded", site="serving.prefix",
                     model=self.name, phase=phase, error=repr(exc))
        self._update_prof(gen_prefix_degraded=1)

    def _unshare_for_write(self, table, start, upto):
        """Copy-on-write: before a step writes positions ``[start,
        upto)``, each covering page that is still shared (another table
        or the prefix cache pins it) is replaced by a private copy: one
        page allocated, copied on the device on the engine thread's
        stream (so before the step that writes it), swapped into the
        table, and the shared original freed of this table's reference.
        May raise :class:`PoolExhausted` part way; pages already copied
        stay consistently private."""
        T = self.pool.page_tokens
        last = min((upto - 1) // T + 1, len(table.pages))
        copies = 0
        for i in range(start // T, last):
            old = table.pages[i]
            if self.pool.refcount(old) <= 1:
                continue
            new = self.pool.alloc(1)[0]
            self._kp[:, new] = self._kp[:, old]
            self._vp[:, new] = self._vp[:, old]
            table.pages[i] = new
            self.pool.free([old])
            copies += 1
        if copies:
            with self._cond:
                self._counts["cow_copies"] += copies
            self._update_prof(gen_cow_copies=copies)

    def _install_handoff(self, table, artifact):
        """The decode tier's receive side of the hop: write the
        artifact's ``n`` exported K/V pages into this pool at the
        table's first ``n`` pages, one ``index_copy_`` along the page
        axis each, on the pool's device (the engine thread's stream)."""
        k, v = artifact.k_pages, artifact.v_pages
        pool = self.pool
        n = int(k.shape[1])
        expect = (pool.num_layers, n, pool.page_tokens, pool.num_heads,
                  pool.head_dim)
        if tuple(k.shape) != expect or tuple(v.shape) != expect:
            raise ServingError(
                "handoff page content shape %r/%r does not match the "
                "pool layout %r" % (tuple(k.shape), tuple(v.shape),
                                    expect))
        if n > len(table.pages):
            raise ServingError(
                "handoff carries %d page(s) but the table only holds "
                "%d" % (n, len(table.pages)))
        ids = torch.as_tensor(np.asarray(table.pages[:n], np.int64)).to(
            self.device)
        for pages, content in ((self._kp, k), (self._vp, v)):
            pages.index_copy_(1, ids, torch.as_tensor(
                np.ascontiguousarray(content)).to(self.device,
                                                  pages.dtype))

    def _evict(self, s, counter=None, requeue=False):
        """The one eviction primitive: release the row's pages on both
        pools, recycle its slot, optionally count it and re-queue its
        request at the front, and wake drain()/admission waiters."""
        s.table.release()
        if self._spec is not None:
            self._spec.release_slot(s.slot)
        with self._cond:
            if s in self._seqs:
                self._seqs.remove(s)
            self._free_slots.append(s.slot)
            self._free_slots.sort()
            if counter is not None:
                self._counts[counter] += 1
            if requeue:
                self._queue.appendleft(s.req)
            self._cond.notify_all()

    def _preempt(self, s):
        """Recompute-on-resume: free the row's pages and re-queue the
        request carrying its progress."""
        record_event("kv_pool_exhausted", site="serving.generate",
                     action="preempt", model=self.name,
                     generated=len(s.req.tokens),
                     preemptions=s.req.preemptions + 1)
        s.req.preemptions += 1
        self._evict(s, counter="preemptions", requeue=True)
        self._update_prof(gen_preemptions=1)

    def _shed_pool(self, s):
        record_event("kv_pool_exhausted", site="serving.generate",
                     action="shed", model=self.name,
                     generated=len(s.req.tokens))
        self._evict(s, counter="shed_pool")
        self._update_prof(gen_shed_pool=1)
        s.req.fail(PoolExhausted(
            "kv page pool exhausted mid-flight after %d generated "
            "token(s) and preemption could not help — shrink "
            "max_new_tokens, raise FLAGS.serve_kv_pages, or use "
            "reserve='full' admission" % len(s.req.tokens)))

    # -- sampling / retirement --------------------------------------------------
    def _accept_token(self, s, logits):
        """Host-sampling path: sample from the [V] logits row."""
        tok = sample_token(logits, s.req.temperature, s.req._rng)
        self._record_token(s, tok, None)

    def _record_token(self, s, tok, logp=None, gap_ms=None):
        """Bookkeeping for one accepted token: append it, stamp latency
        (``gap_ms``, when given, is its inter-token gap), retire on
        eos/length/deadline."""
        req = s.req
        now = time.monotonic()
        req.tokens.append(tok)
        if logp is not None:
            req.logprobs.append(logp)
        s.last_token = tok
        if req._ttft_ms is None:
            req._ttft_ms = (now - req.enqueue_t) * 1e3
            self._ttft_ms.append(req._ttft_ms)
        else:
            self._intertoken_ms.append(
                (now - s.last_t) * 1e3 if gap_ms is None else gap_ms)
        s.last_t = now
        if self.eos_id is not None and tok == self.eos_id:
            self._retire(s, "eos")
        elif req.budget_left <= 0:
            self._retire(s, "length")
        elif AdmissionController.expired(req):
            self._evict(s)
            self._shed_deadline(req, generated=len(req.tokens))

    def _retire(self, s, reason):
        self._evict(s, counter="completed")
        self._update_prof(gen_completed=1)
        s.req.resolve(reason)

    def _shed_deadline(self, req, generated=0):
        late_ms = (time.monotonic() - req.deadline_t) * 1e3
        record_event("request_shed", site="serving.generate",
                     reason="deadline", model=self.name, late_ms=late_ms,
                     generated=generated)
        with self._cond:
            self._counts["shed_deadline"] += 1
        self._update_prof(gen_shed_deadline=1)
        req.fail(DeadlineExceededError(
            "generation deadline exceeded %.1f ms ago (%d token(s) "
            "generated); shed instead of serving a dead client"
            % (late_ms, generated)))

    def _fail_running(self, exc):
        """A raise in a step fails the running sequences (their cache
        rows are suspect) and the loop keeps serving."""
        seqs = list(self._seqs)
        if not seqs:
            return
        record_event("generate_failed", site="serving.generate",
                     model=self.name, phase="decode",
                     sequences=len(seqs), error=repr(exc))
        for s in seqs:
            self._evict(s, counter="failed")
            s.req.fail(exc)
        self._update_prof(gen_failed=len(seqs))

    @staticmethod
    def _update_prof(**kw):
        _prof.update_generation_counters(**kw)

    # -- metrics --------------------------------------------------------------
    @property
    def stats(self):
        """Snapshot of the generation metrics."""
        with self._cond:
            c = dict(self._counts)
            steps = c.get("decode_steps", 0)
            ttft = list(self._ttft_ms)
            itl = list(self._intertoken_ms)
            drafted = c.get("draft_tokens", 0)
            snap = {
                "submitted": c.get("submitted", 0),
                "completed": c.get("completed", 0),
                "failed": c.get("failed", 0),
                "shed_overload": c.get("shed_overload", 0),
                "shed_deadline": c.get("shed_deadline", 0),
                "shed_pool": c.get("shed_pool", 0),
                "preemptions": c.get("preemptions", 0),
                "prefills": c.get("prefills", 0),
                "decode_steps": steps,
                "tokens_generated": c.get("tokens", 0),
                "prompt_tokens": c.get("prompt_tokens", 0),
                "queued": len(self._queue),
                "running": len(self._seqs),
                "max_running": self.max_running,
                "max_running_seen": self._max_running_seen,
                "running_occupancy": (self._occupancy_sum / steps
                                      if steps else 0.0),
                "page_utilization": self.pool.utilization(),
                "page_utilization_max": self._page_util_max,
                "ttft_ms_p50": _percentile(ttft, 0.50),
                "ttft_ms_p99": _percentile(ttft, 0.99),
                "intertoken_ms_p50": _percentile(itl, 0.50),
                "intertoken_ms_p99": _percentile(itl, 0.99),
                "busy_s": self._busy_s,
                "tokens_per_s": (c.get("tokens", 0) / self._busy_s
                                 if self._busy_s > 0 else 0.0),
                "device_sample": self.device_sample,
                "device_sample_steps": c.get("device_sample_steps", 0),
                "host_logit_syncs": c.get("host_logit_syncs", 0),
                "page_release_rate": self.pool.release_rate(),
                "device": str(self.device),
                "prefix_sharing": self._prefix is not None,
                "prefix_degraded": self._prefix_degraded,
                "prefix_hits": c.get("prefix_hits", 0),
                "prefix_hit_requests": c.get("prefix_hit_requests", 0),
                "prefix_published": c.get("prefix_published", 0),
                "cow_copies": c.get("cow_copies", 0),
                "prefix_cache": (self._prefix.stats()
                                 if self._prefix is not None else None),
                "handoff_installs": c.get("handoff_installs", 0),
                "speculative": self._spec is not None,
                "spec_k": self.spec_k,
                "spec_degraded": self._spec_degraded,
                "spec_steps": c.get("spec_steps", 0),
                "draft_tokens": drafted,
                "accepted_tokens": c.get("accepted_tokens", 0),
                "acceptance_rate": (c.get("accepted_tokens", 0)
                                    / float(drafted) if drafted else 0.0),
                "draft_page_utilization": (
                    self._spec.pool.utilization()
                    if self._spec is not None else None),
            }
        snap["shed"] = (snap["shed_overload"] + snap["shed_deadline"]
                        + snap["shed_pool"])
        return snap
