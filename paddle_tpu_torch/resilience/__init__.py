"""Framework-wide fault tolerance (counterpart of
``paddle_tpu/resilience``):

- :mod:`.events`: the process-local record of every degradation, and
  ``record_durable_event`` for the ones that must outlive the process
  (``$PADDLE_TPU_ELASTIC_STATE/events.jsonl``). ``resilience.events``
  is that module and, called, its ``events(kind=, site=)`` snapshot, as
  the JAX package's ``resilience.events`` function.
- :mod:`.faults`: deterministic injection at ten named sites; tests and
  the ``PADDLE_TPU_FAULT_SPEC`` environment variable arm a site to
  raise, delay or corrupt at the Nth hit.
- :mod:`.watchdog`: ``StepWatchdog``, the per-step progress deadline
  that turns a wedged training step into a durable ``step_hung`` event,
  a timeline artifact and exit code 75 (``STEP_HUNG_EXIT``).
- :mod:`.guardrails`: ``NumericGuard``: non-finite or spiking losses
  skip the batch under a consecutive-skip budget; exhaustion rewinds to
  the last checkpoint once a window before giving up.

Not ported yet: ``retry.py`` (``RetryPolicy``), ``grayfail.py``
(``SkewDetector``) and ``supervise.py`` (``SlotSupervision``), whose
only consumers are the elastic supervisor, the replica pool and the
router (ROADMAP.md Queue 1 item 6).
"""
from . import events, faults  # noqa: F401
from .events import (  # noqa: F401
    clear_events, record_durable_event, record_event,
)
from .faults import (  # noqa: F401
    SITE_TABLE, FaultError, arm, armed, disarm, fault_point, hits,
    load_fault_spec, parse_fault_spec, reset,
)
from .guardrails import NumericGuard  # noqa: F401
from .watchdog import STEP_HUNG_EXIT, StepWatchdog  # noqa: F401

__all__ = [
    "record_event", "record_durable_event", "events", "clear_events",
    "FaultError", "SITE_TABLE", "arm", "disarm", "reset", "hits",
    "armed", "fault_point", "parse_fault_spec", "load_fault_spec",
    "StepWatchdog", "STEP_HUNG_EXIT", "NumericGuard",
]
