"""InferenceService: the in-process serving front end for generative
models (the generative half of ``paddle_tpu/serving/service.py``).

It holds one :class:`~paddle_tpu_torch.serving.generator.GenerationEngine`
per model name, with a blocking :meth:`InferenceService.generate`, a
non-blocking :meth:`InferenceService.generate_async` and a metrics
surface (:attr:`InferenceService.stats`). The HTTP endpoint
(:mod:`~paddle_tpu_torch.serving.httpd`) and the ``serve`` CLI verb are
thin shells over it.

For a disaggregated fleet (``serving/disagg.py``) a service carries a
tier class (``tier``, default ``FLAGS.serve_tier``): :meth:`prefill`
runs the prompt pass on a
:class:`~paddle_tpu_torch.serving.disagg.PrefillEngine` over the served
model and returns the handoff artifact, and
:meth:`decode_handoff` installs one into the model's engine and
decodes. The class is advertised through :attr:`stats` and
:meth:`readiness`; a replica of either class still serves every path.

The JAX service's ``update_serving_counters`` sites are on its
``:predict`` path (the micro-batcher: requests, batches, padded rows,
sheds), which the port has not yet (ROADMAP.md Queue 1 item 6); the
generative path counts in the profiler's generation section, through
the engine.
"""
from __future__ import annotations

import collections
import threading
import time

from .admission import ModelUnavailableError, ServingError

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
    """Online generation over registered generative models.

    Usage::

        svc = InferenceService()
        svc.load_model("lm", "./artifact_dir", device="cuda")
        res = svc.generate("lm", [1, 2, 3], max_new_tokens=8)
        svc.stats
        svc.close()                  # drains in-flight generations
    """

    # cap on how long close() waits for an engine's in-flight generations
    _DRAIN_TIMEOUT_S = 60.0

    def __init__(self, queue_depth=None, tier=None):
        from ..flags import FLAGS
        self.tier = str(tier if tier is not None else FLAGS.serve_tier)
        if self.tier not in ("", "prefill", "decode"):
            raise ValueError("tier must be '', 'prefill' or 'decode', "
                             "got %r" % self.tier)
        self.queue_depth = int(queue_depth if queue_depth is not None
                               else FLAGS.serve_queue_depth)
        self._lock = threading.Lock()
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
        """Load the generative artifact ``dirname`` onto ``device`` and
        stand its engine up under ``name``; ``engine_kwargs``
        (max_running, kv_pages, ...) go to the engine. A name already
        served is replaced: the previous engine drains, then closes.

        A speculative pairing (``inference.export_speculative``) pairs
        itself: its draft and k go to the engine, unless the caller
        passed ``draft_model`` (an explicit ``spec_k`` still wins over
        the pairing's k)."""
        from ..inference import (is_speculative_artifact, load_generative,
                                 load_speculative)
        if is_speculative_artifact(dirname) and \
                "draft_model" not in engine_kwargs:
            model, draft, spec_k = load_speculative(dirname, device=device)
            engine_kwargs["draft_model"] = draft
            engine_kwargs.setdefault("spec_k", spec_k)
        else:
            model = load_generative(dirname, device=device)
        return self._publish(name, dirname, model, warm, engine_kwargs)

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
        """{name: description} of every served model."""
        with self._lock:
            gens = dict(self._generators)
        return {n: e.describe() for n, e in gens.items()}

    def readiness(self):
        """Per-model readiness detail for ``/healthz``."""
        with self._lock:
            gens = dict(self._generators)
        out = {}
        for name, e in gens.items():
            st = e.engine.stats
            out[name] = {"kind": "generative", "version": e.version,
                         "queued": st["queued"], "running": st["running"],
                         "page_utilization": round(
                             st["page_utilization"]["frac"], 4),
                         "draining": e.engine.draining}
        return out

    def retry_after_ms(self, model=None):
        """Back-off hint for a 429: the engine's inter-token p50 times
        its queued depth, and, when pages are coming back, the time the
        queued requests' pages take at the observed release rate.
        Clamped to [1 ms, 30 s]."""
        est = 1.0
        with self._lock:
            gen = self._generators.get(model) if model else None
        if gen is not None:
            st = gen.engine.stats
            est = max(est, st["intertoken_ms_p50"] * (st["queued"] + 1))
            rate = st["page_release_rate"]
            if rate > 0.0:
                est = max(est, 1000.0 * (st["queued"] + 1) / rate)
        return min(est, 30000.0)

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

    # -- metrics -------------------------------------------------------------
    @property
    def stats(self):
        """{"models": {name: version}, "tier": class, "generation": {name:
        engine stats}}, and "prefill": {name: prefill engine stats} once
        a prefill ran."""
        with self._lock:
            gens = dict(self._generators)
            pre = {n: v[1] for n, v in self._prefill_engines.items()}
        snap = {"models": {n: e.version for n, e in gens.items()},
                "tier": self.tier,
                "generation": {n: e.engine.stats
                               for n, e in sorted(gens.items())}}
        if pre:
            snap["prefill"] = {n: e.stats for n, e in sorted(pre.items())}
        return snap

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        """Drain every engine (bounded), then close it; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            gens = list(self._generators.values())
            self._generators.clear()
            pre = [v[1] for v in self._prefill_engines.values()]
            self._prefill_engines.clear()
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
