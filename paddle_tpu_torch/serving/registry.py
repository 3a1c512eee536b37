"""Model registry: named, versioned compiled artifacts with warm-up and
hot reload (counterpart of ``paddle_tpu/serving/registry.py``).

- Load = validate + deserialize + warm up + publish. The warm-up runs
  the freshly loaded :class:`~paddle_tpu_torch.inference.CompiledModel`
  on zero feeds shaped from its own signature: ``run`` twice (the
  Executor's eager warm-up, then the capture of the one-request step's
  CUDA graph). ``run_many`` at every padding bucket replays that graph,
  so every bucket is warm after it and no capture happens on the request
  path: the first real request replays.
- Hot reload is atomic and behind in-flight requests: the new version
  is built, warmed and captured before one dict assignment publishes
  it; batches that took the old entry finish on the old weights, and
  the old version's graph pool is freed when its last reference goes.
- A failed load of a name already served rolls back: fault site
  ``serving.reload`` fires first in the warm-up, the serving version
  stays published, a ``reload_rollback`` event is recorded, and the
  error reaches the reloader alone.
"""
from __future__ import annotations

import threading
import time

from ..inference import load_compiled
from ..resilience import fault_point, record_event
from .admission import ModelUnavailableError
from .batcher import padding_buckets

__all__ = ["ModelEntry", "ModelRegistry"]


class ModelEntry(object):
    """One published (name, version): immutable once published."""

    __slots__ = ("name", "version", "dirname", "model", "loaded_at",
                 "warmup_ms", "warm_buckets")

    def __init__(self, name, version, dirname, model, warmup_ms,
                 warm_buckets):
        self.name = name
        self.version = version
        self.dirname = dirname
        self.model = model
        self.loaded_at = time.time()
        self.warmup_ms = warmup_ms
        self.warm_buckets = tuple(warm_buckets)

    def describe(self):
        return {"version": self.version, "dirname": self.dirname,
                "loaded_at": self.loaded_at,
                "warmup_ms": round(self.warmup_ms, 3),
                "warm_buckets": list(self.warm_buckets),
                "feed_names": list(self.model.feed_names),
                "fetch_names": list(self.model.fetch_names),
                "kind": "compiled", "device": str(self.model.device)}


class ModelRegistry(object):
    def __init__(self, warm_buckets=None):
        """``warm_buckets``: the stack depths an entry reports warm (each
        replays the one-request graph the warm-up captured); by default
        ``padding_buckets(FLAGS.serve_max_batch)``, so the registry and
        the micro-batcher agree without plumbing."""
        if warm_buckets is None:
            from ..flags import FLAGS
            warm_buckets = padding_buckets(FLAGS.serve_max_batch)
        self.warm_buckets = tuple(sorted(set(int(b) for b in warm_buckets)))
        self._models = {}       # name -> ModelEntry
        self._versions = {}     # name -> last assigned version int
        self._lock = threading.Lock()

    # -- lookup (reads snapshot under the lock: a concurrent first load
    # of a NEW name mutates the dict mid-iteration otherwise) ---------------
    def get(self, name):
        with self._lock:
            entry = self._models.get(name)
            registered = sorted(self._models) if entry is None else None
        if entry is None:
            raise ModelUnavailableError(
                "no model registered under %r (registered: %s)"
                % (name, registered or "none"))
        return entry

    def names(self):
        with self._lock:
            return sorted(self._models)

    def versions(self):
        """{name: published version} snapshot."""
        with self._lock:
            return {n: e.version for n, e in self._models.items()}

    def info(self):
        with self._lock:
            entries = sorted(self._models.items())
        return {n: e.describe() for n, e in entries}

    # -- load / reload -------------------------------------------------------
    def load(self, name, dirname, warm=True, device="cuda"):
        """Load (or hot-reload) ``dirname`` as ``name`` onto ``device``.
        Blocks the caller for the whole validate, load and warm-up; the
        request path never blocks, it serves the previous version until
        the one-assignment publish below. Raises (with a rollback event
        when a previous version keeps serving) on any failure."""
        with self._lock:
            prev = self._models.get(name)
        try:
            model = load_compiled(dirname, device=device)
            warmup_ms = self._warm_up(model, name) if warm else 0.0
        except BaseException as e:
            if prev is not None:
                record_event("reload_rollback", site="serving.reload",
                             model=name, kept_version=prev.version,
                             dirname=dirname, error=repr(e))
            raise
        with self._lock:
            version = self._versions.get(name, 0) + 1
            self._versions[name] = version
            entry = ModelEntry(name, version, dirname, model, warmup_ms,
                               self.warm_buckets if warm else ())
            # the publish: one dict assignment, atomic under the GIL —
            # in-flight batches hold the old entry and finish on it
            self._models[name] = entry
        record_event("model_loaded", site="serving.reload", model=name,
                     version=version, dirname=dirname,
                     warmup_ms=round(warmup_ms, 3))
        return entry

    reload = load

    def unload(self, name):
        with self._lock:
            return self._models.pop(name, None) is not None

    def _warm_up(self, model, name):
        """Run the one-request step twice (its warm-up, then its capture),
        on zeros shaped from the artifact's signature; every bucket's
        ``run_many`` replays that one graph. ``serving.reload`` fires
        first, so a chaos spec fails a reload where a bad artifact
        would."""
        import numpy as np
        t0 = time.monotonic()
        fault_point("serving.reload")
        zeros = {n: np.zeros(shape, dtype=dtype)
                 for n, (shape, dtype) in model.feed_spec.items()}
        model.run(zeros)
        outs = model.run(zeros)
        # a warm-up that produced nothing is a broken artifact
        if not list(outs):
            raise ValueError("warm-up of %r produced no outputs" % name)
        return (time.monotonic() - t0) * 1e3
