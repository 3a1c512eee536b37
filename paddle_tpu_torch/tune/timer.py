"""Benchmark timers and numeric-parity helpers (counterpart of
``paddle_tpu/tune/timer.py``).

A *timer* is any callable ``timer(fn, operands, candidate=None,
space=None, key=None) -> seconds``:

- :func:`wall_timer`: the host clock over windows of calls, each window
  ended by ``torch.cuda.synchronize()`` on a CUDA operand (a launch
  returns before the card has run it). The only timer whose numbers
  mean anything about speed, and only on the card.
- :func:`model_timer`: a deterministic stand-in for the CPU tests:
  seconds are a pure function of the candidate (the space's
  shared-memory footprint), never of the clock, so the loop, the cache
  and the dispatch are testable without a card. Winners record which
  timer produced them; a model-timed winner is no claim about speed.
- :func:`table_timer`: seconds looked up from a table, for tests.

Parity: :func:`parity_report` / :func:`parity_ok` compare a candidate's
output with the stock rung's on the host, with dtype-aware tolerances;
agreement is the loop's eligibility gate. An element passes when
``|got - ref| <= atol * max(1, max|ref|) + rtol * |ref|``: the JAX
package's absolute term is scaled here by the largest magnitude of the
reference (at least 1), because float32 sum-order noise grows with the
partial sums of the whole row, not with each output: in a deep gemm an
output near 0 moves between two correct summation orders about as much
as the largest one does, which an unscaled 1e-5 can reject. A TF32
product (~1e-3 of the scale) still fails.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["default_tolerance", "model_timer", "parity_ok", "parity_report",
           "table_timer", "time_best", "wall_timer"]


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _sync(out):
    t = _first(out)
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_best(fn, *args, iters=8, trials=3):
    """Best of ``trials`` windows of the mean seconds over ``iters``
    calls of ``fn``; every window ends in a device synchronisation."""
    _sync(fn(*args))
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def wall_timer(iters=8, trials=3):
    """Timer factory: the host clock via :func:`time_best`."""

    def timer(fn, operands, candidate=None, space=None, key=None):
        return time_best(fn, *operands, iters=iters, trials=trials)

    timer.kind = "wall"
    return timer


def model_timer():
    """Deterministic timer: the stock rung scores 0.5; a kernel candidate
    scores ``1.0 - 0.8 * frac`` with ``frac`` its shared-memory footprint
    over the budget (the JAX rule over VMEM), so the largest valid
    working set wins among candidates and a small one loses to stock."""

    def timer(fn, operands, candidate=None, space=None, key=None):
        if candidate is None or candidate.get("use") == "xla":
            return 0.5
        from .space import SMEM_BUDGET
        frac = min(float(space.smem_bytes(candidate, key)) / SMEM_BUDGET,
                   1.0)
        return 1.0 - 0.8 * frac

    timer.kind = "model"
    return timer


def table_timer(table, default=1.0):
    """Timer factory for tests: seconds from ``{frozenset(config.items()):
    seconds}`` (missing -> ``default``)."""

    def timer(fn, operands, candidate=None, space=None, key=None):
        return table.get(frozenset((candidate or {}).items()), default)

    timer.kind = "table"
    return timer


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def default_tolerance(dtype):
    """(rtol, atol) for parity with the stock rung, by compute dtype."""
    if _dtype_name(dtype) in ("bfloat16", "float16"):
        return 2e-2, 2e-2
    return 2e-4, 1e-5


def _host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def parity_report(ref, got, rtol=None, atol=None):
    """None when ``got`` matches ``ref`` within tolerance, else a short
    description of the mismatch. A tuple output compares its first
    element. CUDA tensors are copied to the host first."""
    ref, got = _first(ref), _first(got)
    if rtol is None or atol is None:
        d_rtol, d_atol = default_tolerance(getattr(ref, "dtype", "float32"))
        rtol = d_rtol if rtol is None else rtol
        atol = d_atol if atol is None else atol
    r, g = _host(ref), _host(got)
    if r.shape != g.shape:
        return "shape mismatch: ref %s vs got %s" % (r.shape, g.shape)
    if not np.all(np.isfinite(g)):
        return "non-finite values in candidate output"
    err = np.abs(g - r)
    scale = max(1.0, float(np.abs(r).max())) if r.size else 1.0
    bound = atol * scale + rtol * np.abs(r)
    bad = err > bound
    if bad.any():
        return ("%d/%d elements outside rtol=%g atol=%g x %g (worst "
                "excess %g)" % (int(bad.sum()), bad.size, rtol, atol,
                                scale, float((err - bound).max())))
    return None


def parity_ok(ref, got, rtol=None, atol=None):
    return parity_report(ref, got, rtol=rtol, atol=atol) is None
