"""Deterministic fault injection keyed by site name (counterpart of
``paddle_tpu/resilience/faults.py:293-407``).

Code calls ``fault_point("site.name", payload)`` at a failure-relevant
edge; a test arms the site to raise, or to corrupt the payload, at the
Nth hit. A disarmed site costs one dict lookup. The port has seven sites:

``tune.candidate``     the autotune loop, once per candidate before it
                       is built (``tune/loop.py``): a raise is a
                       candidate failure, recorded and skipped
``tune.cache``         the winner cache's bytes between their CRC and the
                       disk (``tune/cache.py``): a corrupt models bit rot
                       after the integrity data was derived
``serving.generate``   the generation engine's device edges
                       (``serving/generator.py``), once per prefill and
                       once per decode step or speculative round: a raise
                       at a prefill fails that request, at a step the
                       running sequences (``generate_failed`` event), and
                       the engine keeps serving
``serving.speculate``  the draft side of speculative decoding
                       (``serving/speculative.py``), at the draft
                       engine's build, per draft prefill and per propose
                       round: a raise degrades that engine to plain decode
                       for its lifetime (``speculation_degraded`` event);
                       running sequences and greedy output are unchanged
``serving.prefix``     copy-on-write prefix sharing
                       (``serving/prefix.py``), at the cache's build and
                       per match: a raise degrades that engine to private
                       pages for its lifetime (``prefix_degraded`` event);
                       greedy output is unchanged
``serving.ship``       the disaggregated hop (``serving/disagg.ship``),
                       once per handoff: a raise re-submits the prompt to
                       the decode engine, which prefills it again
                       (``handoff_failed`` event); tokens are unchanged
``pipeline.feed_next`` the feed thread of ``pipeline.FeedPipeline``, once
                       per batch before it is prepared: a raise degrades
                       the pass to synchronous feeding from that batch
                       (``pipeline_degraded`` event); no batch is lost

The ``delay`` action and the ``PADDLE_TPU_FAULT_SPEC`` grammar of the
JAX package are not ported.
"""
from __future__ import annotations

import random
import threading

from .events import record_event

__all__ = ["FaultError", "SITES", "arm", "disarm", "fault_point", "hits",
           "reset"]

SITES = ("tune.candidate", "tune.cache", "serving.generate",
         "serving.speculate", "serving.prefix", "serving.ship",
         "pipeline.feed_next")
_ACTIONS = ("raise", "corrupt")


class FaultError(RuntimeError):
    """Default exception an armed 'raise' site throws."""


class _Fault(object):
    __slots__ = ("site", "action", "nth", "times", "message", "exc", "seed",
                 "hits", "fired")

    def __init__(self, site, action, nth, times, message, exc, seed):
        self.site = site
        self.action = action
        self.nth = nth          # 1-based first firing hit
        self.times = times      # None = unbounded window
        self.message = message
        self.exc = exc
        self.seed = seed
        self.hits = 0           # counted from arming time
        self.fired = 0

    def should_fire(self):
        if self.hits < self.nth:
            return False
        return self.times is None or self.hits < self.nth + self.times


_lock = threading.Lock()
_faults = {}          # site -> _Fault


def arm(site, action="raise", nth=1, times=1, message=None, exc=None,
        seed=0):
    """Arm ``site``: the fault fires on hits ``nth .. nth+times-1``
    (1-based, counted from now); ``times=None`` fires forever."""
    if site not in SITES:
        raise ValueError("unknown fault site %r (have: %s)"
                         % (site, ", ".join(SITES)))
    if action not in _ACTIONS:
        raise ValueError("action must be one of %r" % (_ACTIONS,))
    if nth < 1:
        raise ValueError("nth is 1-based")
    if exc is not None and not (isinstance(exc, type)
                                and issubclass(exc, BaseException)):
        raise ValueError("exc must be an exception class")
    f = _Fault(site, action, int(nth), None if times is None else int(times),
               message, exc or FaultError, int(seed))
    with _lock:
        _faults[site] = f
    return f


def disarm(site):
    with _lock:
        return _faults.pop(site, None) is not None


def reset():
    """Disarm everything and forget the counters."""
    with _lock:
        _faults.clear()


def hits(site):
    """Hits at ``site`` since it was armed (0 when it is not)."""
    with _lock:
        f = _faults.get(site)
        return f.hits if f else 0


def _corrupt_bytes(data, rng):
    """Flip a deterministic handful of bytes: enough to break any CRC,
    few enough to keep the size."""
    buf = bytearray(data)
    for _ in range(min(8, len(buf))):
        buf[rng.randrange(len(buf))] ^= 0xFF
    return bytes(buf)


def fault_point(site, payload=None):
    """Declare a failure-relevant edge. Returns ``payload`` (corrupted
    when the site is armed to corrupt and fires); raises when it is armed
    to raise and fires."""
    if site not in _faults:
        return payload
    with _lock:
        f = _faults.get(site)
        if f is None:
            return payload
        f.hits += 1
        if not f.should_fire():
            return payload
        f.fired += 1
        action, hit, fired = f.action, f.hits, f.fired
        exc, message, seed = f.exc, f.message, f.seed
    record_event("fault_injected", site=site, action=action, hit=fired)
    if action == "raise":
        raise exc(message or "injected fault at %r (hit %d)" % (site, hit))
    if payload is None:
        return payload
    if not isinstance(payload, (bytes, bytearray)):
        raise TypeError("cannot corrupt payload of type %s at %r"
                        % (type(payload).__name__, site))
    return _corrupt_bytes(payload, random.Random(hash((seed, fired))))
