"""InferenceService: the in-process serving front end (counterpart of
``paddle_tpu/serving/service.py``).

Two request families share it:

- one-shot inference (:meth:`InferenceService.infer` /
  :meth:`~InferenceService.infer_async`) over compiled artifacts
  (``inference.export_compiled``) through the model registry and the
  micro-batcher (``registry.py``, ``batcher.py``), with admission
  control (``admission.py``);
- autoregressive generation (:meth:`~InferenceService.generate` /
  :meth:`~InferenceService.generate_async`) over generative artifacts,
  one :class:`~paddle_tpu_torch.serving.generator.GenerationEngine` per
  model name.

:meth:`~InferenceService.load_model` tells the two kinds apart by the
directory's files; a name is one kind at a time. The metrics surface
(:attr:`~InferenceService.stats`) holds the request and shed counts,
batch occupancy, queue wait and p50 / p99 latency of the ``:predict``
path, mirrored into ``profiler.serving_counters()`` and the timeline's
``serving`` section, and each engine's stats.

For a disaggregated fleet (``serving/disagg.py``) a service carries a
tier class (``tier``, default ``FLAGS.serve_tier``): :meth:`prefill`
runs the prompt pass on a
:class:`~paddle_tpu_torch.serving.disagg.PrefillEngine` over the served
model and returns the handoff artifact, and :meth:`decode_handoff`
installs one into the model's engine and decodes. The class is
advertised through :attr:`stats` and :meth:`readiness`; a replica of
either class still serves every path.

The HTTP endpoint (:mod:`~paddle_tpu_torch.serving.httpd`) and the
``serve`` CLI verb are thin shells over this class.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from .. import profiler as _prof
from .admission import (AdmissionController, ModelUnavailableError,
                        OverloadError, ServingError)
from .batcher import MicroBatcher, Request, padding_buckets

__all__ = ["InferenceService", "GenEntry"]

# bounded latency reservoirs: a long-lived server must not grow a list
# per request; percentiles over the most recent window are the ones an
# operator acts on anyway
_WINDOW = 4096


def _percentile(values, q):
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(int(q * len(s)), len(s) - 1)]


class GenEntry(object):
    """One published generative model: name, version, source, engine."""

    __slots__ = ("name", "version", "dirname", "engine", "loaded_at")

    def __init__(self, name, version, dirname, engine):
        self.name = name
        self.version = version
        self.dirname = dirname
        self.engine = engine
        self.loaded_at = time.time()

    @property
    def warmup_ms(self):
        return self.engine.warmup_ms

    def describe(self):
        eng = self.engine
        return {"version": self.version, "dirname": self.dirname,
                "loaded_at": self.loaded_at, "kind": "generative",
                "warmup_ms": round(eng.warmup_ms, 3),
                "max_running": eng.max_running,
                "kv_pages": eng.pool.num_pages,
                "page_tokens": eng.pool.page_tokens,
                "max_context": eng.max_context,
                "device": str(eng.device)}


class InferenceService(object):
    """Online inference over compiled and generative models.

    Usage::

        svc = InferenceService()                  # knobs from FLAGS
        svc.load_model("resnet", "./compiled_dir", device="cuda")
        outs = svc.infer("resnet", {"x": image})  # host arrays, a fetch each
        svc.reload_model("resnet", "./compiled_v2")   # atomic hot swap
        svc.load_model("lm", "./generative_dir", device="cuda")
        res = svc.generate("lm", [1, 2, 3], max_new_tokens=8)
        svc.stats
        svc.close()          # fails queued requests, drains generations

    Knob defaults come from ``FLAGS.serve_max_batch``,
    ``serve_batch_timeout_ms`` and ``serve_queue_depth``.
    """

    # cap on how long close() waits for an engine's in-flight generations
    _DRAIN_TIMEOUT_S = 60.0

    def __init__(self, registry=None, max_batch=None, batch_timeout_ms=None,
                 queue_depth=None, tier=None):
        from ..flags import FLAGS
        from .registry import ModelRegistry
        self.tier = str(tier if tier is not None else FLAGS.serve_tier)
        if self.tier not in ("", "prefill", "decode"):
            raise ValueError("tier must be '', 'prefill' or 'decode', "
                             "got %r" % self.tier)
        self.max_batch = int(max_batch if max_batch is not None
                             else FLAGS.serve_max_batch)
        self.batch_timeout_ms = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else FLAGS.serve_batch_timeout_ms)
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else FLAGS.serve_queue_depth)
        self.registry = registry or ModelRegistry(
            warm_buckets=padding_buckets(self.max_batch))
        self.admission = AdmissionController(self.queue_depth)
        self._lock = threading.Lock()
        self._counts = collections.Counter()
        self._occupancy_sum = 0
        self._max_occupancy = 0
        self._padded_rows = 0
        self._queue_wait_ms = collections.deque(maxlen=_WINDOW)
        self._latency_ms = collections.deque(maxlen=_WINDOW)
        self._batcher = MicroBatcher(
            self.registry, self.max_batch, self.batch_timeout_ms,
            self.admission, on_shed=self._on_shed,
            on_batch=self._on_batch, on_fail=self._on_fail)
        self._generators = {}       # name -> GenEntry
        self._versions = collections.Counter()
        # name -> (entry version, PrefillEngine): the prefill-tier face
        # over the model an entry serves, built on the first prefill;
        # keyed by version, so a replaced model never exports K/V of the
        # previous weights
        self._prefill_engines = {}
        self._closed = False

    # -- model management ----------------------------------------------------
    def load_model(self, name, dirname, warm=True, device="cuda",
                   **engine_kwargs):
        """Load (or hot-reload) the artifact ``dirname`` onto ``device``
        as ``name``. A compiled artifact goes through the registry
        (validate, load, warm up and capture, publish; ``engine_kwargs``
        are refused, there is no engine to configure) and returns its
        ``ModelEntry``. A generative one stands its engine up under
        ``name`` with ``engine_kwargs`` (max_running, kv_pages, ...); a
        name already served is replaced: the previous engine drains,
        then closes. A name changing kind retires the other kind's
        entry.

        A speculative pairing (``inference.export_speculative``) pairs
        itself: its draft and k go to the engine, unless the caller
        passed ``draft_model`` (an explicit ``spec_k`` still wins over
        the pairing's k)."""
        from ..inference import (is_generative_artifact,
                                 is_speculative_artifact, load_generative,
                                 load_speculative)
        if not is_generative_artifact(dirname):
            if engine_kwargs:
                raise TypeError(
                    "%r is a compiled artifact; generation engine knobs %s "
                    "do not apply" % (dirname, sorted(engine_kwargs)))
            if self._closed:
                raise RuntimeError("InferenceService is closed")
            entry = self.registry.load(name, dirname, warm=warm,
                                       device=device)
            self._drop_generative(name)
            return entry
        if is_speculative_artifact(dirname) and \
                "draft_model" not in engine_kwargs:
            model, draft, spec_k = load_speculative(dirname, device=device)
            engine_kwargs["draft_model"] = draft
            engine_kwargs.setdefault("spec_k", spec_k)
        else:
            model = load_generative(dirname, device=device)
        entry = self._publish(name, dirname, model, warm, engine_kwargs)
        self.registry.unload(name)
        return entry

    def reload_model(self, name, dirname, warm=True, device=None,
                     **engine_kwargs):
        """Atomic hot reload; on failure the previous version keeps
        serving and the error reaches this caller alone. ``device``
        defaults to the served version's (``cuda`` for a new name)."""
        if device is None:
            device = self._served_device(name)
        return self.load_model(name, dirname, warm=warm, device=device,
                               **engine_kwargs)

    def _served_device(self, name):
        try:
            return self.registry.get(name).model.device
        except ModelUnavailableError:
            pass
        with self._lock:
            gen = self._generators.get(name)
        return gen.engine.device if gen is not None else "cuda"

    def _drop_generative(self, name):
        """Retire ``name``'s engine (a compiled model took the name),
        draining its in-flight generations first."""
        with self._lock:
            entry = self._generators.pop(name, None)
            cached = self._prefill_engines.pop(name, None)
        if cached is not None:
            cached[1].close()
        if entry is not None:
            entry.engine.drain(timeout=self._DRAIN_TIMEOUT_S)
            entry.engine.close()

    def register_generative(self, name, model, warm=False,
                            **engine_kwargs):
        """Stand an engine up over an already-built
        :class:`~paddle_tpu_torch.models.transformer.TransformerLM`."""
        return self._publish(name, "<in-process>", model, warm,
                             engine_kwargs)

    def _publish(self, name, dirname, model, warm, engine_kwargs):
        from .generator import GenerationEngine
        engine_kwargs.setdefault("queue_depth", self.queue_depth)
        engine = GenerationEngine(model, name=name, warm=warm,
                                  **engine_kwargs)
        with self._lock:
            if self._closed:
                closed = True
            else:
                closed = False
                self._versions[name] += 1
                entry = GenEntry(name, self._versions[name], dirname,
                                 engine)
                prev = self._generators.get(name)
                self._generators[name] = entry
        if closed:
            engine.close()
            raise RuntimeError("InferenceService is closed")
        if prev is not None:
            prev.engine.drain(timeout=self._DRAIN_TIMEOUT_S)
            prev.engine.close()
        return entry

    def _gen_entry(self, name):
        with self._lock:
            entry = self._generators.get(name)
            known = sorted(self._generators) if entry is None else None
        if entry is None:
            raise ModelUnavailableError(
                "no generative model registered under %r (registered: "
                "%s)" % (name, known or "none"))
        return entry

    def model_info(self):
        """{name: description} of every served model, both kinds."""
        info = self.registry.info()
        with self._lock:
            gens = dict(self._generators)
        info.update({n: e.describe() for n, e in gens.items()})
        return info

    def readiness(self):
        """Per-model readiness detail for ``/healthz``: kind, version,
        queue depth, and for a generative model its page utilization and
        whether it drains."""
        out = {}
        for name in self.registry.names():
            try:
                entry = self.registry.get(name)
            except ModelUnavailableError:
                continue
            out[name] = {"kind": "compiled", "version": entry.version,
                         "queued": self._batcher.pending_for(name),
                         "draining": False}
        with self._lock:
            gens = dict(self._generators)
        for name, e in gens.items():
            st = e.engine.stats
            out[name] = {"kind": "generative", "version": e.version,
                         "queued": st["queued"], "running": st["running"],
                         "page_utilization": round(
                             st["page_utilization"]["frac"], 4),
                         "draining": e.engine.draining}
        return out

    def retry_after_ms(self, model=None):
        """Back-off hint for a 429: the queue wait the ``:predict`` path
        delivers now (its p99, at least one batch-formation window); for
        a generative model also its inter-token p50 times its queued
        depth and, when pages are coming back, the time the queued
        requests' pages take at the observed release rate. Clamped to
        [1 ms, 30 s]."""
        with self._lock:
            qw = list(self._queue_wait_ms)
            gen = self._generators.get(model) if model else None
        est = max(self.batch_timeout_ms, _percentile(qw, 0.99))
        if gen is not None:
            st = gen.engine.stats
            est = max(est, st["intertoken_ms_p50"] * (st["queued"] + 1))
            rate = st["page_release_rate"]
            if rate > 0.0:
                est = max(est, 1000.0 * (st["queued"] + 1) / rate)
        return min(max(est, 1.0), 30000.0)

    # -- the :predict path ---------------------------------------------------
    def infer_async(self, name, feed, deadline_ms=None):
        """Queue one request; returns its
        :class:`~paddle_tpu_torch.serving.batcher.Request` (``.wait()``
        for the rows). Raises :class:`OverloadError` now when the queue
        is full. ``feed`` maps each feed name of the model to one
        request's array (the exported shape, no extra batch axis)."""
        entry = self.registry.get(name)   # fail fast on unknown models
        feed = self._checked_feed(name, entry.model, feed)
        req = Request(name, feed,
                      self.admission.deadline_from(deadline_ms))
        with self._lock:
            self._counts["requests"] += 1
        try:
            self._batcher.submit(req)
        except OverloadError:
            with self._lock:
                self._counts["shed_overload"] += 1
            _prof.update_serving_counters(shed_overload=1)
            raise
        return req

    @staticmethod
    def _checked_feed(name, model, feed):
        """Check one request against the artifact's signature before it
        queues, so that a malformed feed fails its own submit and not
        the batch it would join. Array-likes are checked by attribute
        (a tensor on the card is not copied to the host); plain lists
        and scalars become arrays of the exported dtype here."""
        spec = model.feed_spec
        out = {}
        for fn, (shape, dtype) in spec.items():
            if fn not in feed:
                raise ValueError(
                    "feed for model %r is missing %r (wants %s)"
                    % (name, fn, sorted(spec)))
            v = feed[fn]
            if not hasattr(v, "shape"):
                v = np.asarray(v, dtype=dtype)
            if tuple(v.shape) != tuple(shape):
                raise ValueError(
                    "feed %r for model %r has shape %s; the artifact was "
                    "exported for %s (one request = one exported feed, "
                    "no extra batch axis)"
                    % (fn, name, tuple(v.shape), tuple(shape)))
            got = str(getattr(v, "dtype", dtype)).replace("torch.", "")
            if got != dtype:
                raise ValueError(
                    "feed %r for model %r has dtype %s; the artifact was "
                    "exported for %s" % (fn, name, got, dtype))
            out[fn] = v
        return out

    def infer(self, name, feed, deadline_ms=None, timeout=None):
        """Blocking inference: a host array a fetch, bit-identical to
        ``CompiledModel.run(feed)`` on the served version."""
        return self.infer_async(name, feed, deadline_ms).wait(timeout)

    # -- request path --------------------------------------------------------
    def generate_async(self, name, tokens, max_new_tokens=16,
                       temperature=0.0, seed=0, deadline_ms=None,
                       spec_k=None):
        """Queue one generation on ``name``'s engine; returns its
        :class:`~paddle_tpu_torch.serving.generator.GenRequest` (``.wait()``
        for the result). Sheds raise now (OverloadError, PoolExhausted).
        The handle's ``model_version`` is the version that took it.
        ``spec_k`` caps the request's speculation depth on a speculative
        engine (0: plain decode)."""
        entry = self._gen_entry(name)
        try:
            req = entry.engine.submit(
                tokens, max_new_tokens=max_new_tokens,
                temperature=temperature, seed=seed, deadline_ms=deadline_ms,
                spec_k=spec_k)
        except ServingError as e:
            if not entry.engine.draining:
                raise
            # lost the race with a replacement: retry once on the engine
            # published now
            entry = self._gen_entry(name)
            if entry.engine.draining:
                raise e
            req = entry.engine.submit(
                tokens, max_new_tokens=max_new_tokens,
                temperature=temperature, seed=seed, deadline_ms=deadline_ms,
                spec_k=spec_k)
        req.model_version = entry.version
        return req

    def generate(self, name, tokens, max_new_tokens=16, temperature=0.0,
                 seed=0, deadline_ms=None, timeout=None, spec_k=None):
        """Blocking generation -> GenResult."""
        return self.generate_async(name, tokens, max_new_tokens,
                                   temperature, seed, deadline_ms,
                                   spec_k=spec_k).wait(timeout)

    # -- disaggregated tier path ---------------------------------------------
    def _prefill_for(self, entry):
        """The prefill engine for ``entry``, built on first use over the
        entry's own model, page geometry and sampling path; a stale one
        (an earlier version of the name) is closed."""
        with self._lock:
            cached = self._prefill_engines.get(entry.name)
            if cached is not None and cached[0] == entry.version:
                return cached[1]
        from .disagg import PrefillEngine
        eng = entry.engine
        pre = PrefillEngine(eng.model, page_tokens=eng.pool.page_tokens,
                            name=entry.name, eos_id=eng.eos_id,
                            device_sample=eng.device_sample,
                            device=eng.device)
        with self._lock:
            cached = self._prefill_engines.get(entry.name)
            if cached is not None and cached[0] == entry.version:
                stale, pre = pre, cached[1]   # lost a build race
            else:
                stale = cached[1] if cached is not None else None
                self._prefill_engines[entry.name] = (entry.version, pre)
        if stale is not None:
            stale.close()
        return pre

    def prefill(self, name, tokens, max_new_tokens=16, temperature=0.0,
                seed=0):
        """Prefill-tier entry point (``:prefill``): run only the prompt
        pass on ``name``'s weights and return the
        :class:`~paddle_tpu_torch.serving.disagg.HandoffArtifact`."""
        entry = self._gen_entry(name)
        return self._prefill_for(entry).prefill(
            tokens, max_new_tokens=max_new_tokens,
            temperature=temperature, seed=seed)

    def decode_handoff_async(self, name, payload, deadline_ms=None):
        """Decode-tier entry point (``:decode``): ship an artifact (a
        wire payload or a HandoffArtifact) into ``name``'s engine and
        return the request handle. A failed hop prefills here again
        (``disagg.ship``); overload and pool exhaustion propagate. A
        malformed payload raises ValueError."""
        from .disagg import HandoffArtifact, ship
        artifact = (payload if isinstance(payload, HandoffArtifact)
                    else HandoffArtifact.from_payload(payload))
        entry = self._gen_entry(name)
        try:
            req = ship(artifact, entry.engine, deadline_ms=deadline_ms)
        except ServingError:
            # lost the race with a replacement: retry once on the engine
            # published now
            entry = self._gen_entry(name)
            req = ship(artifact, entry.engine, deadline_ms=deadline_ms)
        req.model_version = entry.version
        return req

    def handoff_body_limit(self, name):
        """Bytes a ``:decode`` body for ``name`` may take: the largest
        handoff payload of its engine's pool geometry
        (``disagg.max_payload_bytes``). ModelUnavailableError for a name
        not served."""
        from .disagg import max_payload_bytes
        eng = self._gen_entry(name).engine
        return max_payload_bytes(eng.pool, eng.max_context)

    def decode_handoff(self, name, payload, deadline_ms=None, timeout=None):
        """Blocking :meth:`decode_handoff_async` -> GenResult."""
        return self.decode_handoff_async(
            name, payload, deadline_ms=deadline_ms).wait(timeout)

    # -- observer hooks (dispatch thread) ------------------------------------
    def _on_batch(self, requests, bucket):
        n = len(requests)
        with self._lock:
            self._counts["completed"] += n
            self._counts["batches"] += 1
            self._occupancy_sum += n
            self._max_occupancy = max(self._max_occupancy, n)
            self._padded_rows += bucket - n
            for r in requests:
                self._queue_wait_ms.append(r.queue_wait_ms)
                self._latency_ms.append(r.latency_ms)
        _prof.update_serving_counters(
            requests=n, batches=1, padded_rows=bucket - n,
            max_occupancy=n,
            queue_wait_ms=sum(r.queue_wait_ms for r in requests))

    def _on_shed(self, request, reason):
        with self._lock:
            self._counts["shed_" + reason] += 1
        _prof.update_serving_counters(**{"shed_" + reason: 1})

    def _on_fail(self, requests, exc):
        with self._lock:
            self._counts["failed"] += len(requests)
        _prof.update_serving_counters(failed=len(requests))

    # -- metrics -------------------------------------------------------------
    @property
    def stats(self):
        """The ``:predict`` path's counts, occupancy, queue wait and
        p50 / p99 latency (the JAX service's keys); ``models`` {name:
        version} of both kinds; ``tier``; ``generation`` {name: engine
        stats}; and ``prefill`` {name: prefill engine stats} once a
        prefill ran."""
        with self._lock:
            c = dict(self._counts)
            batches = c.get("batches", 0)
            qw = list(self._queue_wait_ms)
            lat = list(self._latency_ms)
            snap = {
                "requests": c.get("requests", 0),
                "completed": c.get("completed", 0),
                "failed": c.get("failed", 0),
                "shed_overload": c.get("shed_overload", 0),
                "shed_deadline": c.get("shed_deadline", 0),
                "pending": self._batcher.pending(),
                "max_batch": self.max_batch,
                "batches": batches,
                "batch_occupancy": (self._occupancy_sum / batches
                                    if batches else 0.0),
                "max_occupancy": self._max_occupancy,
                "padded_rows": self._padded_rows,
                "queue_wait_ms_p50": _percentile(qw, 0.50),
                "queue_wait_ms_p99": _percentile(qw, 0.99),
                "latency_ms_p50": _percentile(lat, 0.50),
                "latency_ms_p99": _percentile(lat, 0.99),
                "tier": self.tier,
            }
            gens = dict(self._generators)
            pre = {n: v[1] for n, v in self._prefill_engines.items()}
        snap["shed"] = snap["shed_overload"] + snap["shed_deadline"]
        snap["models"] = self.registry.versions()
        snap["models"].update({n: e.version for n, e in gens.items()})
        snap["generation"] = {n: e.engine.stats
                              for n, e in sorted(gens.items())}
        if pre:
            snap["prefill"] = {n: e.stats for n, e in sorted(pre.items())}
        return snap

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        """Fail the queued ``:predict`` requests, stop the dispatch
        thread, drain every engine (bounded) and close it; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            gens = list(self._generators.values())
            self._generators.clear()
            pre = [v[1] for v in self._prefill_engines.values()]
            self._prefill_engines.clear()
        self._batcher.close()
        for p in pre:
            p.close()
        for e in gens:
            e.engine.drain(timeout=self._DRAIN_TIMEOUT_S)
            e.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
