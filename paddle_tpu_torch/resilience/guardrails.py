"""Numeric guardrails: loss-driven batch skip, bounded checkpoint
rewind (counterpart of ``paddle_tpu/resilience/guardrails.py``).

``FLAGS.check_nan_inf`` is a debugger: it forces the per-op path and
raises on the first non-finite intermediate. This module is the
production policy: a training loop that treats one poisoned batch (a
corrupt record, a floating-point blow-up, a loss spike) as an event to
survive, not a verdict.

:class:`NumericGuard` watches the per-batch loss (already fetched; under
the pipeline the check is a declared per-batch sync point) and
classifies each batch:

- **accept**: finite and, when ``FLAGS.loss_spike_factor`` > 0, below
  ``factor x`` the running median of recently accepted losses;
- **skip**: non-finite, or a spike: the batch's cost stays out of the
  pass metrics and a ``batch_skipped`` event is recorded (durably, when
  a state directory exists). Only ``FLAGS.loss_skip_budget``
  consecutive skips are tolerated, because a non-finite loss usually
  means the step already applied non-finite gradients: the parameters
  are poisoned and every later batch skips too;
- **rewind**: budget exhausted: the trainer's ``rewind_fn`` restores
  the model and optimizer state from the last checkpoint, a
  ``guard_rewind`` event is recorded, and training goes on. One rewind
  a budget window: a second exhaustion with no accepted batch in
  between means the problem is not transient, and the guard gives up
  with ``FloatingPointError`` (the skip and rewind trail behind it).

The guard never mutates training state itself; the trainer owns the
rewind (and quiesces in-flight async work first). Counters:
``profiler.trainer_counters()`` ``batches_skipped`` / ``guard_rewinds``.
"""
from __future__ import annotations

import math

from .. import profiler as _prof
from .events import record_durable_event

__all__ = ["NumericGuard"]

# spike detection starts once the baseline median has this many
# accepted samples — comparing against a 1-sample "median" would shed
# normal early-training variance
_SPIKE_WARMUP = 3


class NumericGuard(object):
    """Per-batch loss policy: accept / skip / rewind / give up.

    ``skip_budget`` — consecutive skips tolerated before a rewind
    (must be >= 1; a guard with budget 0 should not be constructed —
    the trainer reads that as "guardrails off").
    ``spike_factor`` — 0 disables spike detection (non-finite only).
    ``rewind_fn`` — zero-arg callable restoring model state from the
    last checkpoint, returning True when a restore actually happened
    (False/None = nothing to rewind to → give up instead).
    """

    def __init__(self, skip_budget, spike_factor=0.0, rewind_fn=None,
                 history=16):
        self.skip_budget = int(skip_budget)
        if self.skip_budget < 1:
            raise ValueError("skip_budget must be >= 1, got %d"
                             % self.skip_budget)
        self.spike_factor = float(spike_factor)
        self._rewind_fn = rewind_fn
        self._history = int(history)
        self._accepted = []          # recent accepted losses (baseline)
        self._consecutive = 0
        self._rewound_in_window = False
        self.skips = 0
        self.rewinds = 0
        # True while the model may carry a skipped batch's (possibly
        # non-finite) update with no accepted batch or rewind since:
        # checkpoints must not persist this state
        self.tainted = False

    # -- classification ------------------------------------------------------
    def _reason(self, loss):
        if not math.isfinite(loss):
            return "nonfinite"
        if self.spike_factor > 0 and len(self._accepted) >= _SPIKE_WARMUP:
            base = sorted(self._accepted)[len(self._accepted) // 2]
            # median of a young run can legitimately sit at ~0; the
            # tiny floor keeps the comparison meaningful there
            if loss > self.spike_factor * max(abs(base), 1e-12):
                return "spike"
        return None

    def baseline(self):
        """Current spike baseline (median of recent accepted losses),
        or None before warmup."""
        if len(self._accepted) < _SPIKE_WARMUP:
            return None
        return sorted(self._accepted)[len(self._accepted) // 2]

    # -- the per-batch verdict ----------------------------------------------
    def check(self, loss, pass_id=None, batch_id=None):
        """Classify one batch's materialized loss. Returns ``"ok"``
        (count it) or ``"skip"`` (exclude it; a rewind may have
        happened — the trainer's ``rewind_fn`` already ran). Raises
        ``FloatingPointError`` when the guard gives up."""
        loss = float(loss)
        reason = self._reason(loss)
        if reason is None:
            self._accepted.append(loss)
            if len(self._accepted) > self._history:
                del self._accepted[:-self._history]
            self._consecutive = 0
            self._rewound_in_window = False
            self.tainted = False
            return "ok"

        self.skips += 1
        self._consecutive += 1
        self.tainted = True
        _prof.update_trainer_counters(batches_skipped=1)
        record_durable_event(
            "batch_skipped", site="trainer.guard", reason=reason,
            loss=loss, baseline=self.baseline(), pass_id=pass_id,
            batch_id=batch_id, consecutive=self._consecutive,
            budget=self.skip_budget)

        if self._consecutive < self.skip_budget:
            return "skip"

        # budget exhausted: one bounded rewind per window, then give up
        if not self._rewound_in_window and self._rewind_fn is not None:
            if self._rewind_fn():
                self.rewinds += 1
                self._rewound_in_window = True
                self._consecutive = 0
                self.tainted = False     # the restore discarded the poison
                _prof.update_trainer_counters(guard_rewinds=1)
                record_durable_event(
                    "guard_rewind", site="trainer.guard", reason=reason,
                    loss=loss, pass_id=pass_id, batch_id=batch_id,
                    skips=self.skips, budget=self.skip_budget)
                return "skip"
        raise FloatingPointError(
            "numeric guardrail gave up: %d consecutive skipped batches "
            "(last reason %r, loss %r) %s — see the batch_skipped/"
            "guard_rewind events for the trail"
            % (self._consecutive, reason, loss,
               "after a checkpoint rewind already spent this window"
               if self._rewound_in_window else
               "and no checkpoint to rewind to"))
