"""The autotune loop: enumerate, build, parity-check, time, pick
(counterpart of ``paddle_tpu/tune/loop.py``).

For each candidate config of a :class:`~paddle_tpu_torch.tune.space.KernelSpace`:

1. ``fault_point("tune.candidate")``: an armed raise here is a
   candidate failure like any real one;
2. build and run it (a kernel that fails to build or launch raises
   here);
3. numeric parity with the stock rung (the eligibility gate: a
   candidate that computes wrong is recorded and skipped, never timed);
4. time it (the wall clock on the card, the deterministic model timer
   on the CPU).

The stock rung is always candidate 0, spelled ``{"use": "xla"}`` as in
the JAX package so that a cached entry reads the same; in the port it is
the plain library call (``torch.matmul``, ``F.conv2d``). If it wins, the
cached winner says so and dispatch keeps the library call for that
shape.

A candidate that fails parity, and any failure on the CPU or injected
at ``tune.candidate`` (``FaultError``), appends a record and a ``tune_candidate_failed`` event, and the loop
moves on. Any other exception on a CUDA device is raised: a kernel that
fails to build or launch on the card is a fault of the port, and skipping
it would hand its shapes to the stock rung unseen. With zero survivors it returns a result
without a winner instead of raising; the caller decides (the CLI exits
1, dispatch keeps the stock lowering).
"""
from __future__ import annotations

import time

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..resilience.events import record_event
from ..resilience.faults import FaultError, fault_point
from . import cache as cache_mod
from . import timer as timer_mod
from .space import get_space, signature

__all__ = ["TuneResult", "XLA_CONFIG", "autotune", "default_timer"]

XLA_CONFIG = {"use": "xla"}


def default_timer(device=DEFAULT_DEVICE):
    """The wall clock on a CUDA device, the deterministic model timer on
    the CPU (where wall times say nothing about the card)."""
    if resolve_device(device).type == "cuda":
        return timer_mod.wall_timer()
    return timer_mod.model_timer()


def _skippable(exc, dev):
    """Whether a candidate's exception is recorded and skipped: an
    injected fault anywhere, any failure on the CPU; on the card a real
    build or launch failure propagates."""
    return isinstance(exc, FaultError) or dev.type != "cuda"


class TuneResult(object):
    """Outcome of one autotune() call."""

    __slots__ = ("kernel", "key", "sig", "winner", "winner_seconds",
                 "records", "timer_kind", "cache_key", "wall_s")

    def __init__(self, kernel, key, sig, winner, winner_seconds, records,
                 timer_kind, cache_key, wall_s):
        self.kernel = kernel
        self.key = key
        self.sig = sig
        self.winner = winner            # config dict or None
        self.winner_seconds = winner_seconds
        self.records = records          # [{config, status, seconds, note}]
        self.timer_kind = timer_kind
        self.cache_key = cache_key
        self.wall_s = wall_s

    @property
    def ok(self):
        return self.winner is not None

    def row(self):
        """One benchmark row (results.bench_record)."""
        return {"kernel": self.kernel, "sig": self.sig,
                "winner": self.winner, "winner_s": self.winner_seconds,
                "timer": self.timer_kind,
                "candidates": len(self.records),
                "failed": sum(1 for r in self.records
                              if r["status"] != "ok"),
                "records": [dict(r) for r in self.records],
                "wall_s": round(self.wall_s, 3)}


def autotune(kernel, key, timer=None, budget=None, cache=None,
             persist=True, seed=0, rtol=None, atol=None, device_kind=None,
             device=DEFAULT_DEVICE):
    """Search ``kernel``'s space at shape ``key`` on ``device``; persist
    and return the winner. ``budget`` caps the candidates, stock rung
    included (None -> FLAGS.tune_budget; 0 = unlimited); ``timer`` is any
    ``(fn, operands, candidate=, space=, key=) -> seconds`` callable."""
    from ..flags import FLAGS
    from .results import device_kind as _device_kind

    t_start = time.time()
    dev = resolve_device(device)
    space = get_space(kernel)
    sig = signature(key)
    if timer is None:
        timer = default_timer(dev)
    if budget is None:
        budget = FLAGS.tune_budget
    kind = device_kind or _device_kind()
    ckey = cache_mod.cache_key(kind, kernel, sig)

    records = []
    best_cfg, best_s = None, float("inf")
    with torch.no_grad():
        operands = space.make_operands(key, seed=seed, device=dev)
        ref_fn = space.reference(key)
        ref_out = ref_fn(*operands)
        # budget 1 times the stock rung alone; None / 0 is uncapped
        kernel_cands = space.candidates(
            key, budget=(budget - 1) if budget else None)
        for cfg in [dict(XLA_CONFIG)] + kernel_cands:
            rec = {"config": dict(cfg), "status": "ok", "seconds": None,
                   "note": None}
            records.append(rec)
            is_stock = cfg.get("use") == "xla"
            try:
                fault_point("tune.candidate")
                fn = ref_fn if is_stock else space.build(cfg, key)
                out = fn(*operands)
                if not is_stock:
                    report = timer_mod.parity_report(ref_out, out,
                                                     rtol=rtol, atol=atol)
                    if report is not None:
                        rec["status"] = "parity_fail"
                        rec["note"] = report
                        record_event("tune_candidate_failed",
                                     site="tune.candidate", kernel=kernel,
                                     sig=sig, status="parity_fail",
                                     config=dict(cfg), note=report)
                        continue
                secs = float(timer(fn, operands, candidate=cfg,
                                   space=space, key=key))
                rec["seconds"] = secs
                if secs < best_s:
                    best_cfg, best_s = dict(cfg), secs
            except Exception as e:
                if not _skippable(e, dev):
                    raise
                rec["status"] = "error"
                rec["note"] = "%s: %s" % (type(e).__name__, str(e)[:200])
                record_event("tune_candidate_failed", site="tune.candidate",
                             kernel=kernel, sig=sig, status="error",
                             config=dict(cfg), note=rec["note"])
        del operands, ref_out

    result = TuneResult(kernel, dict(key), sig, best_cfg,
                        None if best_cfg is None else best_s, records,
                        getattr(timer, "kind", "custom"), ckey,
                        time.time() - t_start)
    if persist and result.ok:
        if cache is None:
            cache = cache_mod.WinnerCache()
        cache.put(ckey, best_cfg, time_ms=best_s * 1e3,
                  timer=result.timer_kind,
                  meta={"kernel": kernel, "sig": sig, "device": kind})
    return result
