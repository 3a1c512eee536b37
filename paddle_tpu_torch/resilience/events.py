"""Structured, process-local event log (counterpart of
``paddle_tpu/resilience/events.py:30-99``: ``record_event``, ``events``,
``clear_events``).

Every degraded-mode continuation is recorded here, so a test can prove
that a failure was handled rather than swallowed: a tune candidate that
failed (``tune_candidate_failed``), a corrupt winner cache
(``tune_cache_corrupt``), a fired fault (``fault_injected``).
"""
from __future__ import annotations

import collections
import threading
import time

__all__ = ["clear_events", "events", "record_event"]

# bounded: the log must not become a leak of its own; oldest drop first
_MAX_EVENTS = 10_000

_lock = threading.Lock()
_events = collections.deque(maxlen=_MAX_EVENTS)


def record_event(kind, site=None, **info):
    """Append one event: ``kind`` is a short tag, ``site`` the code
    location in the fault-site naming scheme (``tune.cache``)."""
    ev = {"kind": kind, "site": site, "time": time.time()}
    ev.update(info)
    with _lock:
        _events.append(ev)
    return ev


def events(kind=None, site=None):
    """Snapshot of the recorded events, optionally filtered."""
    with _lock:
        out = list(_events)
    if kind is not None:
        out = [e for e in out if e["kind"] == kind]
    if site is not None:
        out = [e for e in out if e["site"] == site]
    return out


def clear_events():
    with _lock:
        _events.clear()
