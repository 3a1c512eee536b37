"""Kernel autotuning: searched tilings of the port's CUDA kernels with a
persistent per-(device, shape) winner cache (counterpart of
``paddle_tpu/tune``).

- **Search spaces** (``tune/space.py``): a :class:`KernelSpace` declares
  a kernel's compiled tilings, their validity and shared-memory
  footprint, the stock rung and deterministic operands; matmul and
  conv3x3 ship.
- **Autotune loop** (``tune/loop.py``): enumerate -> build -> parity
  with the stock rung (an eligibility gate) -> time (the wall clock on
  the card, the deterministic model timer on the CPU) -> winner. The
  stock rung is always in the race; a candidate's failure is recorded
  at fault site ``tune.candidate`` and skipped.
- **Winner cache** (``tune/cache.py``): ``winners.torch.json`` in
  ``FLAGS.tune_cache_dir``, keyed ``device_kind|kernel|signature``,
  entry-CRC checked (fault site ``tune.cache``), fronted by a
  process-level in-memory layer.
- **Dispatch** (:func:`lookup`, called by ``ops/math_ops.py`` for
  ``mul`` and ``ops/nn_ops.py`` for ``conv2d``): a cached winner runs
  the kernel with the winning config; a miss runs the kernel's default
  config where a flag already enables the kernel, and the stock PyTorch
  lowering otherwise. The counters ``tune_hits``, ``tune_misses`` and
  ``tune_fallbacks`` surface through ``Executor.stats`` and the
  profiler's ``tune`` section (``profiler.tune_counters()``, which the
  ``tune`` verb adds ``tune_loops`` / ``tune_candidates`` to);
  :func:`reset_counters` clears both.

Counting follows the JAX package's, where dispatch happens while a
program traces, so a counter moves once per compile. The Executor's
compiled path counts the first lowering pass of a step key (the warm-up
on the card, the first run on the CPU) and runs its captures, replays
and the CPU's stand-in for a replay under :func:`quiet`, which counts
nothing; the per-op path (``use_jit=False``), which the JAX package runs
op by op too, counts every run.

Surface: ``python -m paddle_tpu_torch tune <config.py>`` (``cli.py``)
tunes the kernels a train config's program uses.
"""
from __future__ import annotations

import contextlib
import threading

from .. import profiler
from .cache import (WinnerCache, cache_key, clear_memory_cache,
                    default_cache_dir)
from .loop import TuneResult, XLA_CONFIG, autotune, default_timer
from .results import device_kind
from .space import (Conv3x3Space, KernelSpace, MatmulSpace, get_space,
                    signature, space_names)
from .timer import (model_timer, parity_ok, parity_report, table_timer,
                    time_best, wall_timer)

__all__ = [
    "KernelSpace", "Conv3x3Space", "MatmulSpace", "get_space",
    "space_names", "signature", "autotune", "TuneResult", "XLA_CONFIG",
    "default_timer", "WinnerCache", "cache_key", "default_cache_dir",
    "clear_memory_cache", "wall_timer", "model_timer", "table_timer",
    "time_best", "parity_ok", "parity_report", "lookup", "record_fallback",
    "counters", "quiet", "reset_counters",
]

_counters_lock = threading.Lock()
_counters = {"tune_hits": 0, "tune_misses": 0, "tune_fallbacks": 0}


# per thread: a lowering pass under quiet() (a capture, a replay's
# stand-in) consults the cache but counts nothing
_quiet = threading.local()


def _bump(name):
    if getattr(_quiet, "depth", 0):
        return
    with _counters_lock:
        _counters[name] += 1
    # the profiler's tune timeline section mirrors the tally
    profiler.update_tune_counters(**{name: 1})


@contextlib.contextmanager
def quiet():
    """Consults in this thread count nothing while the block runs: a
    lowering pass of a step key after its first is a replay of that
    trace, which the JAX package does not trace again."""
    _quiet.depth = getattr(_quiet, "depth", 0) + 1
    try:
        yield
    finally:
        _quiet.depth -= 1


def counters():
    """Snapshot of the process-level dispatch counters."""
    with _counters_lock:
        return dict(_counters)


def reset_counters():
    with _counters_lock:
        for k in _counters:
            _counters[k] = 0
    profiler.reset_tune_counters()


def lookup(kernel, key, enabled=False, valid=None):
    """Kernel-dispatch decision for one call.

    ``key`` is the shape key dict (see tune/space.py); ``enabled`` says
    whether the call site's flag (``conv_impl=pallas3x3``) already opts
    this kernel in. Returns the config dict to run the kernel with, or
    None for the stock PyTorch lowering:

    - a cached winner for (device, kernel, signature) -> that config
      (``tune_hits``; a winner of ``{"use": "xla"}`` says the stock
      lowering is fastest: None, still a hit);
    - a cached winner that ``valid(config)`` refuses (a tiling the
      kernel does not compile, say one cached before its tilings
      changed)                                  -> ``{}``, the kernel's
      default config (``tune_misses``): what runs is not what was
      cached, so it is not a hit;
    - no winner, the site enabled              -> ``{}``, the kernel's
      default config (``tune_misses``);
    - no winner, not enabled (or FLAGS.tune 0) -> None
      (``tune_fallbacks``).

    Never raises: an unreadable cache behaves as all-miss (the cache
    records the corruption). After the first call the cache read is a
    dict hit of the in-memory layer.
    """
    from ..flags import FLAGS
    if FLAGS.tune:
        try:
            cfg = WinnerCache().get_config(
                cache_key(device_kind(), kernel, signature(key)))
        except Exception:
            cfg = None  # cache trouble must never fail a step
        if cfg is not None:
            if cfg.get("use") == "xla":
                _bump("tune_hits")
                return None
            if valid is not None and not valid(cfg):
                _bump("tune_misses")
                return {}
            _bump("tune_hits")
            return cfg
    if enabled:
        _bump("tune_misses")
        return {}
    _bump("tune_fallbacks")
    return None


def record_fallback(kernel):
    """Count a tunable call site where no kernel applies (a shape outside
    the kernel's population): it runs the stock lowering."""
    del kernel  # one gauge for all kernels, as in the JAX package
    _bump("tune_fallbacks")
