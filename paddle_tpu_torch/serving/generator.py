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

Left out of this port for now, each listed in ``ROADMAP.md``:
speculative decoding, prefix sharing and copy-on-write, disaggregated
prefill/decode handoff, fault points and the tune-cache lookup.

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
from .admission import (AdmissionController, DeadlineExceededError,
                        OverloadError, ServingError)
from .batcher import bucket_for, padding_buckets
from .kvcache import BlockTable, PagePool, PoolExhausted, pages_for
from .service import _WINDOW, _percentile

__all__ = ["GenRequest", "GenResult", "GenerationEngine", "sample_token",
           "reference_decode"]

# how many preemptions one request may absorb before the engine calls
# the pool too small for it and sheds instead of thrashing
_PREEMPT_LIMIT = 2


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
                 "preemptions", "model_version", "_rng", "_ttft_ms",
                 "_done", "_result", "_error")

    def __init__(self, prompt, max_new_tokens, temperature=0.0, seed=0,
                 deadline_t=None):
        self.prompt = [int(t) for t in prompt]
        # stamped by InferenceService.generate_async
        self.model_version = None
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

    __slots__ = ("req", "slot", "table", "cached", "last_token", "last_t")

    def __init__(self, req, slot, table):
        self.req = req
        self.slot = slot
        self.table = table
        self.cached = 0          # positions written into the paged cache
        self.last_token = None   # next decode step's input token
        self.last_t = time.monotonic()


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
    ``FLAGS.serve_device_sample``). Knobs left None read the
    ``FLAGS.serve_*`` defaults.
    """

    def __init__(self, model, max_running=None, kv_pages=None,
                 page_tokens=None, queue_depth=None, reserve="full",
                 eos_id=None, name="model", warm=False, device_sample=None):
        from ..flags import FLAGS
        if reserve not in ("full", "prompt"):
            raise ValueError("reserve must be 'full' or 'prompt'")
        self.model = model
        self.name = name
        self.reserve = reserve
        self.device = model.device
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
        self.device_sample = bool(FLAGS.serve_device_sample
                                  if device_sample is None
                                  else device_sample)
        self._sample_meta = None   # cached (temps, seeds) device copies
        self._buckets = padding_buckets(self.max_context)
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

    def _prefill(self, padded, length, table_row, temperature, seed):
        """One prefill; returns (token, logprob) on the device-sampling
        path, else the [V] logits as numpy."""
        p = self.model.params
        cfg = self.model.config
        if self.device_sample:
            tok, logp = _tm.prefill_step_sampled(
                p, self._kp, self._vp, self._i32(padded), length,
                self._i32(table_row), temperature, seed, cfg)
            packed = torch.stack([tok.float(), logp]).cpu()
            return int(packed[0]), float(packed[1])
        last = _tm.prefill_step(p, self._kp, self._vp, self._i32(padded),
                                length, self._i32(table_row), cfg)
        return last.cpu().numpy()

    def warm_up(self, buckets=None):
        """Run every prefill bucket and one decode step with all-trash
        block tables, so the kernels are built and loaded before the
        first request; the writes land on the trash page only. Returns
        the wall time in ms. Call before the engine thread starts (the
        constructor's ``warm=True``)."""
        t0 = time.monotonic()
        trash_row = np.full((self.max_blocks,), self.pool.trash_page,
                            np.int32)
        with torch.no_grad():
            for S_b in (self._buckets if buckets is None else buckets):
                self._prefill(np.zeros((S_b,), np.int32), 1, trash_row,
                              0.0, 0)
            R = self.max_running
            self._decode(np.tile(trash_row, (R, 1)),
                         np.zeros((R,), np.int32), np.zeros((R,), np.int32),
                         np.zeros((R,), bool), np.zeros((R,), np.float32),
                         np.zeros((R,), np.int32))
        return (time.monotonic() - t0) * 1e3

    # -- submit side ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, temperature=0.0, seed=0,
               deadline_ms=None):
        """Queue one prompt; returns the :class:`GenRequest` handle.
        Sheds now when the queue is full, the request could never fit
        the pool, or it exceeds the model's context window."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must hold at least one token id")
        V = self.model.config.vocab_size
        if min(prompt) < 0 or max(prompt) >= V:
            raise ValueError("prompt token ids must be in [0, %d)" % V)
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        temperature = float(temperature or 0.0)
        if not np.isfinite(temperature) or temperature < 0.0:
            # reject on the caller's thread: a NaN reaching the sampler
            # would fail every other in-flight generation of the step
            raise ValueError("temperature must be finite and >= 0.0, "
                             "got %r" % temperature)
        total = len(prompt) + max_new_tokens
        if total > self.max_context:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds the model "
                "context window (%d)" % (len(prompt), max_new_tokens,
                                         self.max_context))
        if not self.pool.can_fit(total):
            with self._cond:
                self._counts["shed_pool"] += 1
            raise PoolExhausted(
                "request needs %d token(s) of cache; the pool holds %d "
                "(serve_kv_pages=%d x serve_page_tokens=%d) — shed "
                "instead of wedging the engine"
                % (total, self.pool.num_pages * self.pool.page_tokens,
                   self.pool.num_pages, self.pool.page_tokens))
        req = GenRequest(prompt, max_new_tokens, temperature, seed,
                         AdmissionController.deadline_from(deadline_ms))
        with self._cond:
            if not self._alive:
                raise ServingError("generation engine is closed")
            if self._draining:
                raise ServingError(
                    "generation engine is draining — resubmit to the "
                    "replacement engine")
            if len(self._queue) >= self.queue_depth:
                self._counts["shed_overload"] += 1
                raise OverloadError(
                    "generation queue full (%d pending >= queue_depth="
                    "%d); request shed — retry with backoff or raise "
                    "FLAGS.serve_queue_depth"
                    % (len(self._queue), self.queue_depth))
            self._counts["submitted"] += 1
            self._queue.append(req)
            self._cond.notify_all()
        return req

    def generate(self, prompt, max_new_tokens=16, temperature=0.0, seed=0,
                 deadline_ms=None, timeout=None):
        """Blocking convenience: submit + wait -> :class:`GenResult`."""
        return self.submit(prompt, max_new_tokens, temperature, seed,
                           deadline_ms).wait(timeout)

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
                if pages_for(self._reserve_tokens(req),
                             self.pool.page_tokens) > self.pool.available:
                    return
                self._queue.popleft()
                slot = self._free_slots.pop(0)
                self._admitting += 1
            try:
                self._start(req, slot)
            except PoolExhausted:
                with self._cond:
                    self._queue.appendleft(req)
                    self._free_slots.insert(0, slot)
                    self._free_slots.sort()
                return
            finally:
                with self._cond:
                    self._admitting -= 1
                    self._cond.notify_all()

    def _start(self, req, slot):
        """Prefill ``req`` into a fresh block table and take its first
        token; may retire it at once (budget 1 or eos). The first token's
        sampling counter is its position in the full sequence, so a
        resumed request continues its stream."""
        prompt = req.pending_prompt
        table = BlockTable(self.pool)
        try:
            table.ensure(self._reserve_tokens(req))
        except PoolExhausted:
            table.release()
            raise
        S_b = bucket_for(len(prompt), self._buckets)
        padded = np.zeros((S_b,), np.int32)
        padded[:len(prompt)] = prompt
        t0 = time.monotonic()
        try:
            first = self._prefill(padded, len(prompt),
                                  table.as_row(self.max_blocks),
                                  req.temperature, req.seed & 0x7FFFFFFF)
        except Exception as e:
            table.release()
            with self._cond:
                self._free_slots.append(slot)
                self._free_slots.sort()
                self._counts["failed"] += 1
            req.fail(e)
            return
        self._busy_s += time.monotonic() - t0
        run = _Running(req, slot, table)
        run.cached = len(prompt)
        with self._cond:
            self._counts["prefills"] += 1
            self._counts["prompt_tokens"] += len(prompt)
            self._counts["tokens"] += 1
            self._seqs.append(run)
            self._seqs.sort(key=lambda s: s.slot)
            self._max_running_seen = max(self._max_running_seen,
                                         len(self._seqs))
        if self.device_sample:
            self._record_token(run, first[0], first[1])
        else:
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
        # temps/seeds change only when the running set does: their
        # device copies are cached between steps
        cached = self._sample_meta
        if (cached is None or not np.array_equal(temps, cached[0])
                or not np.array_equal(seeds, cached[1])):
            cached = (temps, seeds,
                      torch.as_tensor(temps).to(self.device),
                      self._i32(seeds))
            self._sample_meta = cached
        toks, logps = _tm.decode_step_sampled(*args, cached[2], cached[3],
                                              cfg)
        # one [2R] float32 row crosses to the host (tokens are exact in
        # float32 up to a vocab of 2**24)
        packed = torch.cat([toks.float(), logps]).cpu().numpy()
        R = toks.shape[0]
        return packed[:R].astype(np.int32), packed[R:]

    def _step(self):
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
        for s in seqs:
            s.cached += 1
            if self.device_sample:
                self._record_token(s, int(out[0][s.slot]),
                                   float(out[1][s.slot]))
            else:
                self._accept_token(s, out[s.slot])

    def _grow_tables(self):
        """Make room for each running row's next position; starvation
        preempts (or sheds, when preemption cannot help)."""
        for s in list(self._seqs):
            try:
                s.table.ensure(s.cached + 1)
            except PoolExhausted:
                if len(self._seqs) > 1 and \
                        s.req.preemptions < _PREEMPT_LIMIT:
                    self._preempt(s)
                else:
                    self._shed_pool(s)

    def _evict(self, s, counter=None, requeue=False):
        """The one eviction primitive: release the row's pages, recycle
        its slot, optionally count it and re-queue its request at the
        front, and wake drain()/admission waiters."""
        s.table.release()
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
        s.req.preemptions += 1
        self._evict(s, counter="preemptions", requeue=True)

    def _shed_pool(self, s):
        self._evict(s, counter="shed_pool")
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

    def _record_token(self, s, tok, logp=None):
        """Bookkeeping for one accepted token: append it, stamp latency,
        retire on eos/length/deadline."""
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
            self._intertoken_ms.append((now - s.last_t) * 1e3)
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
        s.req.resolve(reason)

    def _shed_deadline(self, req, generated=0):
        late_ms = (time.monotonic() - req.deadline_t) * 1e3
        with self._cond:
            self._counts["shed_deadline"] += 1
        req.fail(DeadlineExceededError(
            "generation deadline exceeded %.1f ms ago (%d token(s) "
            "generated); shed instead of serving a dead client"
            % (late_ms, generated)))

    def _fail_running(self, exc):
        """A raise in a step fails the running sequences (their cache
        rows are suspect) and the loop keeps serving."""
        for s in list(self._seqs):
            self._evict(s, counter="failed")
            s.req.fail(exc)

    # -- metrics --------------------------------------------------------------
    @property
    def stats(self):
        """Snapshot of the generation metrics."""
        with self._cond:
            c = dict(self._counts)
            steps = c.get("decode_steps", 0)
            ttft = list(self._ttft_ms)
            itl = list(self._intertoken_ms)
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
            }
        snap["shed"] = (snap["shed_overload"] + snap["shed_deadline"]
                        + snap["shed_pool"])
        return snap
