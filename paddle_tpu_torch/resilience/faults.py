"""Deterministic fault injection keyed by site name (counterpart of
``paddle_tpu/resilience/faults.py``).

Code calls ``fault_point("site.name", payload)`` at a failure-relevant
edge; a test, or an operator through the ``PADDLE_TPU_FAULT_SPEC``
environment variable, arms the site to raise, to delay, or to corrupt
the payload at the Nth hit. A disarmed site costs one dict lookup. The
port has twelve sites:

``tune.candidate``     the autotune loop, once per candidate before it
                       is built (``tune/loop.py``): a raise is a
                       candidate failure, recorded and skipped
``tune.cache``         the winner cache's bytes between their CRC and the
                       disk (``tune/cache.py``): a corrupt models bit rot
                       after the integrity data was derived
``serving.dispatch``   the micro-batcher's dispatch of a compiled
                       model (``serving/batcher.py``), once per batch
                       before ``run`` / ``run_many``: a raise fails that
                       batch's requests (``batch_failed`` event) and the
                       dispatch loop keeps serving; a delay models a slow
                       device and backs the queue up into admission
                       control
``serving.reload``     the model registry's warm-up
                       (``serving/registry.py``), once per (re)load
                       before the buckets are run: a raise on a hot
                       reload keeps the serving version
                       (``reload_rollback`` event)
``serving.generate``   the generation engine's device edges
                       (``serving/generator.py``), once per prefill and
                       once per decode step or speculative round: a raise
                       at a prefill fails that request, at a step the
                       running sequences (``generate_failed`` event), and
                       the engine keeps serving; a delay models a slow
                       device and stretches inter-token latency into the
                       deadline shed path
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
``checkpoint.write``   ``checkpoint.py``, once per shard and once for the
                       manifest, between the bytes' CRC32 and the disk: a
                       corrupt is the bit rot the load's CRC check finds
``checkpoint.load``    ``checkpoint.py``, once per shard read: a raise is
                       a failed read of the checkpoint
``trainer.step``       the ``Trainer.train`` loop (``trainer.py``), once
                       per training step before the Executor runs it: a
                       delay models a wedged step (a stalled device, a
                       hung reader); with ``FLAGS.step_timeout_s`` set
                       the step watchdog fires, records a durable
                       ``step_hung`` event, writes the profiler timeline
                       and exits 75. A raise models a step failure and
                       propagates out of ``train()``

Spec grammar (the environment variable, read once at the first
``fault_point``, or a ``load_fault_spec`` string)::

    site:action[:key=value[,key=value...]][;site:action[...]]...

    action  = raise | delay | corrupt
    nth     = 1-based hit that fires (default 1); '*' = every hit
    times   = how many consecutive hits fire (default 1); '*' = unbounded
    delay   = seconds (delay action)
    exc     = exception class name from builtins (raise action;
              default FaultError)
    message = exception text (raise action; '_' stands for a space)
    seed    = corruption determinism seed (corrupt action)

e.g. ``PADDLE_TPU_FAULT_SPEC="trainer.step:delay:nth=3,delay=3600"``.
Hit counting starts when a site is armed; ``fault_point`` is
thread-safe.
"""
from __future__ import annotations

import builtins
import random
import threading
import time

from .events import record_event

__all__ = ["FaultError", "SITE_TABLE", "arm", "armed", "disarm",
           "fault_point", "hits", "load_fault_spec", "parse_fault_spec",
           "reset"]

_ENV_VAR = "PADDLE_TPU_FAULT_SPEC"
_ACTIONS = ("raise", "delay", "corrupt")

# The machine-readable face of the docstring table: site -> (defining
# module under paddle_tpu_torch/, armable, delay_documented), as the JAX
# package's SITE_TABLE; every site of the port is a fault_point.
SITE_TABLE = {
    "tune.candidate": ("tune/loop.py", True, False),
    "tune.cache": ("tune/cache.py", True, False),
    "serving.dispatch": ("serving/batcher.py", True, True),
    "serving.reload": ("serving/registry.py", True, False),
    "serving.generate": ("serving/generator.py", True, True),
    "serving.speculate": ("serving/speculative.py", True, False),
    "serving.prefix": ("serving/prefix.py", True, False),
    "serving.ship": ("serving/disagg.py", True, False),
    "pipeline.feed_next": ("pipeline.py", True, False),
    "checkpoint.write": ("checkpoint.py", True, False),
    "checkpoint.load": ("checkpoint.py", True, False),
    "trainer.step": ("trainer.py", True, True),
}


class FaultError(RuntimeError):
    """Default exception an armed 'raise' site throws."""


class _Fault(object):
    __slots__ = ("site", "action", "nth", "times", "delay", "message", "exc",
                 "seed", "hits", "fired")

    def __init__(self, site, action, nth, times, delay, message, exc, seed):
        self.site = site
        self.action = action
        self.nth = nth          # 1-based first firing hit
        self.times = times      # None = unbounded window
        self.delay = delay
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
_env_loaded = False


def arm(site, action="raise", nth=1, times=1, delay=0.0, message=None,
        exc=None, seed=0):
    """Arm ``site``: the fault fires on hits ``nth .. nth+times-1``
    (1-based, counted from now); ``times=None`` fires forever. A
    ``delay`` fault sleeps ``delay`` seconds at each firing hit."""
    if site not in SITE_TABLE:
        raise ValueError("unknown fault site %r (have: %s)"
                         % (site, ", ".join(SITE_TABLE)))
    if action not in _ACTIONS:
        raise ValueError("action must be one of %r" % (_ACTIONS,))
    if nth < 1:
        raise ValueError("nth is 1-based")
    if exc is not None and not (isinstance(exc, type)
                                and issubclass(exc, BaseException)):
        raise ValueError("exc must be an exception class")
    f = _Fault(site, action, int(nth), None if times is None else int(times),
               float(delay), message, exc or FaultError, int(seed))
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


def armed():
    """Snapshot {site: action} of the armed faults."""
    with _lock:
        return {s: f.action for s, f in _faults.items()}


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
    to raise and fires; sleeps when it is armed to delay and fires. The
    first call arms ``PADDLE_TPU_FAULT_SPEC``."""
    if not _env_loaded:
        _load_env_once()
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
        exc, message, seed, delay = f.exc, f.message, f.seed, f.delay
    record_event("fault_injected", site=site, action=action, hit=fired)
    if action == "raise":
        raise exc(message or "injected fault at %r (hit %d)" % (site, hit))
    if action == "delay":
        time.sleep(delay)
        return payload
    if payload is None:
        return payload
    if not isinstance(payload, (bytes, bytearray)):
        raise TypeError("cannot corrupt payload of type %s at %r"
                        % (type(payload).__name__, site))
    return _corrupt_bytes(payload, random.Random(hash((seed, fired))))


# -- the spec grammar ---------------------------------------------------------

def parse_fault_spec(spec):
    """Parse the grammar into a list of ``arm()`` keyword dicts (a pure
    function; raises ValueError naming the entry at fault)."""
    out = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":", 2)
        if len(parts) < 2:
            raise ValueError("bad fault entry %r (want site:action[:kv])"
                             % entry)
        site, action = parts[0].strip(), parts[1].strip()
        if action not in _ACTIONS:
            raise ValueError("bad action %r in %r" % (action, entry))
        kw = {"site": site, "action": action}
        if len(parts) == 3 and parts[2].strip():
            for pair in parts[2].split(","):
                if "=" not in pair:
                    raise ValueError("bad key=value %r in %r"
                                     % (pair, entry))
                k, v = (x.strip() for x in pair.split("=", 1))
                if k == "nth":
                    if v == "*":
                        kw["nth"], kw["times"] = 1, None
                    else:
                        kw["nth"] = int(v)
                elif k == "times":
                    kw["times"] = None if v == "*" else int(v)
                elif k == "delay":
                    kw["delay"] = float(v)
                elif k == "seed":
                    kw["seed"] = int(v)
                elif k == "message":
                    kw["message"] = v.replace("_", " ")
                elif k == "exc":
                    e = getattr(builtins, v, None)
                    if not (isinstance(e, type)
                            and issubclass(e, BaseException)):
                        raise ValueError("exc %r is not a builtin "
                                         "exception (in %r)" % (v, entry))
                    kw["exc"] = e
                else:
                    raise ValueError("unknown key %r in %r" % (k, entry))
        out.append(kw)
    return out


def load_fault_spec(spec=None):
    """Arm every entry of ``spec`` (default: the ``PADDLE_TPU_FAULT_SPEC``
    environment variable). Returns the number of sites armed."""
    import os
    if spec is None:
        spec = os.environ.get(_ENV_VAR, "")
    entries = parse_fault_spec(spec)
    for kw in entries:
        arm(**kw)
    return len(entries)


def _load_env_once():
    """The first fault_point arms the environment's spec, so a chaos run
    needs no change of code."""
    global _env_loaded
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
    try:
        load_fault_spec()
    except ValueError as e:
        import warnings
        warnings.warn("ignoring malformed %s: %s" % (_ENV_VAR, e))
