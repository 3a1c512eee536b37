"""Structured, process-local event log (counterpart of
``paddle_tpu/resilience/events.py``: ``record_event``,
``record_durable_event``, ``events``, ``clear_events``).

Every degraded-mode continuation is recorded here, so a test can prove
that a failure was handled rather than swallowed: a tune candidate that
failed (``tune_candidate_failed``), a corrupt winner cache
(``tune_cache_corrupt``), a fired fault (``fault_injected``), a
checkpoint that fell back past a corrupt one (``checkpoint_fallback``),
a preemption checkpoint (``preempt_checkpoint``). An event that must
outlive the process (``preempt_truncated``: SIGKILL may follow) is also
appended to ``<state_dir>/events.jsonl``.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import types

__all__ = ["clear_events", "events", "record_durable_event",
           "record_event"]

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


def _json_line(ev):
    """Strict JSON for the file: a non-finite float is written as its
    repr string (``json.dumps`` would write bare ``NaN``)."""
    try:
        return json.dumps(ev, allow_nan=False)
    except ValueError:
        def fix(v):
            if isinstance(v, float) and (v != v or v in
                                         (float("inf"), float("-inf"))):
                return repr(v)
            if isinstance(v, dict):
                return {k: fix(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [fix(x) for x in v]
            return v
        return json.dumps(fix(ev), allow_nan=False)


def record_durable_event(kind, site=None, state_dir=None, **info):
    """:func:`record_event`, and one line appended (and fsynced) to
    ``<state_dir>/events.jsonl`` when there is a state directory:
    ``state_dir`` or ``PADDLE_TPU_ELASTIC_STATE``. A failure to write
    leaves the in-memory record standing."""
    ev = record_event(kind, site=site, **info)
    state_dir = state_dir or os.environ.get("PADDLE_TPU_ELASTIC_STATE")
    if state_dir:
        try:
            os.makedirs(state_dir, exist_ok=True)
            with open(os.path.join(state_dir, "events.jsonl"), "a") as f:
                f.write(_json_line(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass
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


class _EventsModule(types.ModuleType):
    """This module, callable as its :func:`events`: the package exports
    it as ``resilience.events``, which the JAX package's callers call."""

    def __call__(self, kind=None, site=None):
        return events(kind=kind, site=site)


sys.modules[__name__].__class__ = _EventsModule
