"""Admission control: the serving tier's errors and the queue-depth and
deadline policy (counterpart of ``paddle_tpu/serving/admission.py``).

- queue-depth backpressure: a request past ``queue_depth`` waiting ones
  is rejected now with :class:`OverloadError` (the micro-batcher checks
  under its queue lock; the generation engine's ``submit`` checks its
  own queue);
- per-request deadlines: a request already late when it would start is
  shed with :class:`DeadlineExceededError`;
- every shed of the micro-batcher's path is a recorded
  ``request_shed`` event (``resilience/events.py``), at site
  ``serving.admission`` (overload) or ``serving.dispatch`` (deadline).
"""
from __future__ import annotations

import time

from ..resilience import record_event

__all__ = ["ServingError", "OverloadError", "DeadlineExceededError",
           "ModelUnavailableError", "AdmissionController"]


class ServingError(RuntimeError):
    """Base of the serving tier's request-rejection errors."""


class OverloadError(ServingError):
    """Shed at admission: the bounded request queue is full."""


class DeadlineExceededError(ServingError):
    """Shed at dispatch: the request's deadline passed while it queued."""


class ModelUnavailableError(ServingError):
    """No model (or no live version) registered under the requested
    name."""


class AdmissionController(object):
    """The policy consulted at the two shed points. It keeps no state
    beyond its knob: the queue it bounds lives in the batcher, whose lock
    makes the depth check exact."""

    def __init__(self, queue_depth):
        self.queue_depth = max(int(queue_depth), 1)

    def check_queue(self, pending, model=None):
        """Raise :class:`OverloadError` when ``pending`` queued requests
        leave no room for one more; records the shed."""
        if pending >= self.queue_depth:
            record_event("request_shed", site="serving.admission",
                         reason="overload", model=model,
                         queue_depth=self.queue_depth)
            raise OverloadError(
                "serving queue full (%d pending >= queue_depth=%d); "
                "request shed — retry with backoff or raise "
                "FLAGS.serve_queue_depth" % (pending, self.queue_depth))

    @staticmethod
    def deadline_from(deadline_ms, now=None):
        """Absolute monotonic deadline for a relative ``deadline_ms``
        budget (None = no deadline)."""
        if deadline_ms is None:
            return None
        now = time.monotonic() if now is None else now
        return now + float(deadline_ms) / 1e3

    @staticmethod
    def expired(request, now=None):
        if request.deadline_t is None:
            return False
        now = time.monotonic() if now is None else now
        return now > request.deadline_t

    def shed_deadline(self, request, now=None):
        """Fail an expired request with a recorded event."""
        now = time.monotonic() if now is None else now
        late_ms = (now - request.deadline_t) * 1e3
        record_event("request_shed", site="serving.dispatch",
                     reason="deadline", model=request.model,
                     late_ms=late_ms)
        request.fail(DeadlineExceededError(
            "request deadline exceeded %.1f ms before dispatch "
            "(model %r); shed instead of serving a dead client"
            % (late_ms, request.model)))
