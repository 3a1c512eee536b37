"""Step-hang watchdog (counterpart of
``paddle_tpu/resilience/watchdog.py``): a wedged step becomes exit code
75, never a process that holds its card and makes no progress.

A training step can stop making progress without dying: a kernel that
never finishes, a reader stalled on a hung filesystem, a card that
stopped answering. Process exit is a supervisor's only liveness signal,
so such a step holds the job until someone notices.

:class:`StepWatchdog` closes that gap from the inside. ``Trainer.train``
arms a deadline per step (``FLAGS.step_timeout_s``; default off) and
pings it at every progress point: each batch, the guardrail's sync
point and the progress line, since under the pipeline a wedged card
surfaces where a fetch is materialized. A monitor thread (a daemon,
one comparison a poll) fires when the deadline lapses:

1. records a durable ``step_hung`` event (``record_durable_event``: one
   line appended to ``$PADDLE_TPU_ELASTIC_STATE/events.jsonl`` outlives
   the process);
2. writes the profiler's timeline artifact beside it (else to the
   temporary directory): the post-mortem, which phase the loop died in
   and every subsystem's counters;
3. calls ``os._exit(STEP_HUNG_EXIT)``: a non-zero exit that is not a
   signal's, which a supervisor reads as transient and restarts from
   the last checkpoint. ``os._exit`` is deliberate: the main thread is
   stuck (perhaps in a CUDA synchronize), so the interpreter's normal
   teardown could hang too.

The action is injectable (``on_hang=``) so that a test sees the firing
without losing its process. Fault site ``trainer.step`` with a ``delay``
action is the seeded hang
(``PADDLE_TPU_FAULT_SPEC="trainer.step:delay:nth=3,delay=3600"``).
"""
from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

from .. import profiler as _prof
from .events import record_durable_event

__all__ = ["StepWatchdog", "STEP_HUNG_EXIT"]

# EX_TEMPFAIL: distinctive, non-zero, not 128+N: a supervisor reads any
# rc > 0 as a transient (restartable) death
STEP_HUNG_EXIT = 75


def _default_on_hang(info):
    """Record durably, dump the post-mortem timeline, exit non-zero.
    Never raises: the watchdog thread is the process's last honest
    reporter and must reach ``os._exit`` no matter what. It imports
    nothing: the main thread may be stuck holding an import lock."""
    try:
        _prof.update_trainer_counters(steps_hung=1)
    except Exception:
        pass
    state_dir = os.environ.get("PADDLE_TPU_ELASTIC_STATE")
    timeline = None
    try:
        out_dir = state_dir if state_dir and os.path.isdir(state_dir) \
            else tempfile.gettempdir()
        timeline = os.path.join(
            out_dir, "step-hung-rank%s-pid%d-timeline.json"
            % (os.environ.get("PADDLE_TPU_PROCESS_ID", "x"), os.getpid()))
        _prof.write_timeline(timeline)
    except Exception:
        timeline = None
    try:
        record_durable_event("step_hung", site="trainer.watchdog",
                             timeline=timeline, **info)
    except Exception:
        pass
    try:
        sys.stderr.write(
            "paddle_tpu_torch step watchdog: no progress for %.1fs at %r — "
            "exiting %d for a supervisor restart (timeline: %s)\n"
            % (info.get("timeout_s", 0.0), info.get("label"),
               STEP_HUNG_EXIT, timeline))
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(STEP_HUNG_EXIT)


class StepWatchdog(object):
    """Per-step progress deadline on a monitor thread.

    ``arm(label)`` starts (or re-starts) the deadline; ``ping(label)``
    re-arms it at every progress point; ``disarm()`` suspends it across
    stretches with no step deadline (checkpoint saves, pass
    boundaries); ``close()`` stops the thread. A lapse calls
    ``on_hang(info)`` exactly once — the default handler never returns.
    """

    def __init__(self, timeout_s, on_hang=None, poll_s=None):
        self.timeout_s = float(timeout_s)
        if self.timeout_s <= 0:
            raise ValueError("step watchdog needs timeout_s > 0, got %r"
                             % timeout_s)
        self._on_hang = on_hang or _default_on_hang
        self._poll_s = (float(poll_s) if poll_s is not None
                        else max(min(self.timeout_s / 4.0, 1.0), 0.02))
        self._lock = threading.Lock()
        self._deadline = None        # None = disarmed
        self._label = None
        self._fired = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, name="paddle_tpu_torch-step-watchdog",
            daemon=True)
        self._thread.start()

    # -- loop-side API -------------------------------------------------------
    def arm(self, label="step"):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
            self._label = label

    ping = arm  # every progress point re-arms the same deadline

    def tick(self, label="wait"):
        """Progress signal that re-arms ONLY an already-armed deadline.
        For waits that are progress-like but must not resurrect a
        deliberately suspended deadline: a concurrent ``disarm`` window
        (a checkpoint save, a rewind) must stay suspended."""
        with self._lock:
            if self._deadline is not None:
                self._deadline = time.monotonic() + self.timeout_s
                self._label = label

    def disarm(self):
        with self._lock:
            self._deadline = None
            self._label = None

    @property
    def fired(self):
        return self._fired

    def close(self):
        self.disarm()
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- monitor thread ------------------------------------------------------
    def _watch(self):
        while not self._stop.wait(self._poll_s):
            with self._lock:
                deadline, label = self._deadline, self._label
                lapsed = (deadline is not None
                          and time.monotonic() > deadline)
                if lapsed:
                    # fire once; suspend so a test-injected on_hang that
                    # RETURNS does not re-fire every poll
                    self._deadline = None
                    self._fired = True
            if lapsed:
                self._on_hang({
                    "label": label, "timeout_s": self.timeout_s,
                    "rank": os.environ.get("PADDLE_TPU_PROCESS_ID"),
                    "generation": os.environ.get(
                        "PADDLE_TPU_ELASTIC_GENERATION"),
                })
