"""Dynamic micro-batching: concurrent ``:predict`` requests coalesced
into one dispatch (counterpart of ``paddle_tpu/serving/batcher.py``:
``padding_buckets``, ``bucket_for``, ``feed_shape_sig``, ``Request``,
``MicroBatcher``; the generation engine uses the buckets alone).

Requests enter bounded queues keyed by (model, feed-shape signature), so
a batch is shape-homogeneous by construction. One dispatch thread takes
the queue whose head has waited longest, gives later arrivals up to
``batch_timeout_ms`` (from that head) to join, stacks up to
``max_batch`` of them and drives one ``CompiledModel.run_many`` (a batch
of one: ``run``). ``run_many`` is R replays of the one-request step, so
each row is bit-identical to ``run`` of that request alone, and a batch
costs the card what its requests cost one by one: the JAX package pads
the stack to a bucket for its scan's shape, and the port runs only the
live rows. The bucket (the smallest that fits) is still what the
``padded_rows`` and occupancy counters report, as in the JAX package.
Results come back to the requests as host arrays.

Failures: the dispatch edge is fault site ``serving.dispatch``; a raise
there, or in the model (a kernel that fails to build or launch), fails
that batch's requests with a ``batch_failed`` event and the loop goes
on. Expired requests are shed at dispatch by the
:class:`~paddle_tpu_torch.serving.admission.AdmissionController`.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from ..resilience import fault_point, record_event
from .admission import ModelUnavailableError, ServingError

__all__ = ["padding_buckets", "bucket_for", "feed_shape_sig", "Request",
           "MicroBatcher"]


def padding_buckets(max_batch):
    """Powers of two with ``max_batch`` itself as the cap
    (8 -> [1, 2, 4, 8]; 6 -> [1, 2, 4, 6])."""
    max_batch = max(int(max_batch), 1)
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def bucket_for(r, buckets):
    """Smallest bucket that fits ``r``."""
    for b in buckets:
        if b >= r:
            return b
    return buckets[-1]


def _host(t):
    """A result as a host numpy array."""
    if hasattr(t, "detach"):
        from ..core.executor import _to_numpy
        return _to_numpy(t)
    return np.asarray(t)


def _stack(values):
    """One feed's requests stacked on a new leading axis: tensors stay
    tensors (on their device), anything else becomes numpy."""
    if all(hasattr(v, "detach") for v in values):
        import torch
        return torch.stack(values)
    return np.stack([_host(v) for v in values])


def feed_shape_sig(feed):
    """Canonical (name, shape) signature of one request's feed — the
    shape-bucket routing key. Attribute-only on array-likes (never
    np.asarray a possibly device-resident value); plain lists fall back
    to np.shape."""
    sig = []
    for fn in sorted(feed):
        v = feed[fn]
        shape = getattr(v, "shape", None)
        if shape is None:
            shape = np.shape(v)
        sig.append((fn, tuple(int(d) for d in shape)))
    return tuple(sig)


class Request(object):
    """One queued inference request; resolves to a list of per-fetch
    arrays (no leading batch axis added or removed — the rows are
    exactly what ``run()`` would have returned). ``version`` is the
    model version that served it, set at dispatch: a request admitted
    before a hot reload and dispatched after it is served, and labelled,
    by the new version (ROADMAP.md Queue 3 #40)."""

    __slots__ = ("model", "feed", "shape_sig", "deadline_t", "enqueue_t",
                 "dequeue_t", "done_t", "version", "_done", "_result",
                 "_error")

    def __init__(self, model, feed, deadline_t=None):
        self.model = model
        self.feed = feed
        self.shape_sig = feed_shape_sig(feed)
        self.deadline_t = deadline_t
        self.enqueue_t = time.monotonic()
        self.dequeue_t = None
        self.done_t = None
        self.version = None
        self._done = threading.Event()
        self._result = None
        self._error = None

    def resolve(self, result):
        self._result = result
        self.done_t = time.monotonic()
        self._done.set()

    def fail(self, exc):
        self._error = exc
        self.done_t = time.monotonic()
        self._done.set()

    @property
    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block for the result; re-raises the shed/dispatch error."""
        if not self._done.wait(timeout):
            raise TimeoutError("inference request still pending after "
                               "%.3fs (model %r)" % (timeout, self.model))
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def queue_wait_ms(self):
        end = self.dequeue_t or self.done_t or time.monotonic()
        return (end - self.enqueue_t) * 1e3

    @property
    def latency_ms(self):
        end = self.done_t or time.monotonic()
        return (end - self.enqueue_t) * 1e3


class MicroBatcher(object):
    """Bounded per-model request queues and the one dispatch thread.

    ``admission`` bounds the total queued depth (checked under the queue
    lock, so the bound is exact) and sheds expired requests at dispatch.
    ``on_shed(request, reason)`` / ``on_batch(requests, bucket)`` /
    ``on_fail(requests, exc)`` are observer hooks the owning service
    uses for metrics; they run on the dispatch thread and must be cheap.
    """

    def __init__(self, registry, max_batch, batch_timeout_ms, admission,
                 on_shed=None, on_batch=None, on_fail=None):
        self.registry = registry
        self.max_batch = max(int(max_batch), 1)
        self.batch_timeout_s = max(float(batch_timeout_ms), 0.0) / 1e3
        self.buckets = padding_buckets(self.max_batch)
        self.admission = admission
        self._on_shed = on_shed or (lambda req, reason: None)
        self._on_batch = on_batch or (lambda reqs, bucket: None)
        self._on_fail = on_fail or (lambda reqs, exc: None)
        # shape-bucket routing: queues are keyed (model, feed shape
        # signature), so a formed batch is shape-homogeneous BY
        # CONSTRUCTION — mixed-shape traffic to one model coalesces
        # into per-shape full batches instead of poisoning np.stack
        self._queues = {}           # (model, shape_sig) -> deque[Request]
        self._cond = threading.Condition()
        self._running = True
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="paddle_tpu_torch-dispatch",
                                        daemon=True)
        self._thread.start()

    # -- producer side -------------------------------------------------------
    def submit(self, request):
        """Enqueue under the admission bound; raises
        :class:`OverloadError` on a full queue, :class:`ServingError`
        after close()."""
        with self._cond:
            if not self._running:
                raise ServingError("serving dispatch loop is closed")
            self.admission.check_queue(self._pending_locked(),
                                       model=request.model)
            self._queues.setdefault(
                (request.model, request.shape_sig),
                collections.deque()).append(request)
            self._cond.notify_all()
        return request

    def pending(self):
        with self._cond:
            return self._pending_locked()

    def pending_for(self, model):
        """Queued requests for ONE model (summed over its shape-bucket
        queues) — the per-model queue depth the /healthz readiness
        detail reports."""
        with self._cond:
            return sum(len(q) for (m, _sig), q in self._queues.items()
                       if m == model)

    def _pending_locked(self):
        return sum(len(q) for q in self._queues.values())

    # -- dispatch loop -------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            batch = self._form_batch()
            if batch is None:
                return
            (name, _sig), requests = batch
            if requests:
                self._run_batch(name, requests)

    def _form_batch(self):
        """Block for work, then give later arrivals up to
        ``batch_timeout_s`` (measured from the OLDEST queued request) to
        coalesce. Returns ((model, shape_sig), [requests]) or None at
        shutdown."""
        with self._cond:
            while self._running and self._pending_locked() == 0:
                self._cond.wait(0.1)
            if not self._running and self._pending_locked() == 0:
                return None
            # serve the (model, shape) queue whose head has waited
            # longest — later same-shape arrivals coalesce behind it
            key = min((k for k, q in self._queues.items() if q),
                      key=lambda k: self._queues[k][0].enqueue_t)
            q = self._queues[key]
            form_deadline = q[0].enqueue_t + self.batch_timeout_s
            while self._running and len(q) < self.max_batch:
                rem = form_deadline - time.monotonic()
                if rem <= 0:
                    break
                self._cond.wait(rem)
            if not self._running:
                # close() ran while we waited (the wait releases the
                # lock): it already collected and failed these requests
                # as shutdown orphans — popping our stale deque ref
                # would dispatch work whose futures are dead
                return key, []
            now = time.monotonic()
            take = min(len(q), self.max_batch)
            requests = [q.popleft() for _ in range(take)]
            for r in requests:
                r.dequeue_t = now
            if not q:
                del self._queues[key]
            self._cond.notify_all()
        return key, requests

    def _run_batch(self, name, requests):
        # shed what is already dead, then dispatch the rest as one stack
        live = []
        for r in requests:
            if self.admission.expired(r):
                self.admission.shed_deadline(r)
                self._on_shed(r, "deadline")
            else:
                live.append(r)
        if not live:
            return
        try:
            entry = self.registry.get(name)
        except ModelUnavailableError as e:
            for r in live:
                r.fail(e)
            self._on_fail(live, e)
            return
        model = entry.model
        n_live = len(live)
        bucket = bucket_for(n_live, self.buckets)
        try:
            fault_point("serving.dispatch")
            if n_live == 1:
                rows = [[_host(o) for o in model.run(live[0].feed)]]
            else:
                stacked = {fn: _stack([r.feed[fn] for r in live])
                           for fn in model.feed_names}
                outs = [_host(o) for o in model.run_many(stacked)]
                rows = [[o[i] for o in outs] for i in range(n_live)]
        except BaseException as e:
            record_event("batch_failed", site="serving.dispatch",
                         model=name, version=entry.version,
                         requests=n_live, error=repr(e))
            for r in live:
                r.fail(e)
            self._on_fail(live, e)
            return
        for r, row in zip(live, rows):
            r.version = entry.version
            r.resolve(row)
        self._on_batch(live, bucket)

    # -- shutdown ------------------------------------------------------------
    def close(self):
        """Stop the dispatch thread; queued-but-undispatched requests
        fail with :class:`ServingError` (idempotent)."""
        with self._cond:
            self._running = False
            orphans = [r for q in self._queues.values() for r in q]
            self._queues.clear()
            self._cond.notify_all()
        for r in orphans:
            r.fail(ServingError("service shut down before dispatch"))
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
