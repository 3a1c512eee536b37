"""Admission control: the serving tier's errors and the queue-depth and
deadline policy (a copy of ``paddle_tpu/serving/admission.py`` without
its event recording).

- queue-depth backpressure: a request past ``queue_depth`` waiting ones
  is rejected now with :class:`OverloadError` (the engine's ``submit``
  checks its own queue);
- per-request deadlines: a request already late when it would start is
  shed with :class:`DeadlineExceededError`.
"""
from __future__ import annotations

import time

__all__ = ["ServingError", "OverloadError", "DeadlineExceededError",
           "ModelUnavailableError", "AdmissionController"]


class ServingError(RuntimeError):
    """Base of the serving tier's request-rejection errors."""


class OverloadError(ServingError):
    """Shed at admission: the bounded request queue is full."""


class DeadlineExceededError(ServingError):
    """Shed at dispatch: the request's deadline passed while it queued."""


class ModelUnavailableError(ServingError):
    """No model registered under the requested name."""


class AdmissionController(object):
    """Deadline policy, stateless."""

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
