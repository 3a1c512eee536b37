"""Event-driven trainer (counterpart of ``paddle_tpu/trainer.py``):
``Trainer.__init__`` appends the backward and optimizer ops
(``optimizer.minimize``), ``train`` runs the startup program once and
then every batch of the reader through the Executor, firing
``BeginPass``, ``BeginIteration``, ``EndIteration`` and ``EndPass`` into
the handler.

Not ported yet: checkpoints and resume, preemption, the async feed
pipeline, the step watchdog and numeric guardrails, elastic workers and
``test``.
"""
from __future__ import annotations

import numpy as np

from .core import ir
from .core.executor import Executor
from .data_feeder import DataFeeder
from .device import DEFAULT_DEVICE
from .flags import FLAGS

__all__ = ["BeginIteration", "BeginPass", "EndIteration", "EndPass",
           "Trainer"]


class BeginPass(object):
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(object):
    def __init__(self, pass_id, metrics=None):
        self.pass_id = pass_id
        self.metrics = metrics or {}


class BeginIteration(object):
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(object):
    """``cost`` is the batch's loss as a float; ``metrics["fetches"]``
    the other fetches as numpy arrays."""

    def __init__(self, pass_id, batch_id, cost, metrics=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics or {}


class Trainer(object):
    """Drive a built program over a reader with events::

        trainer = Trainer(cost=avg_cost, optimizer=optimizer.Adam(1e-3),
                          feed_list=[x, y], device="cuda")
        trainer.train(reader, num_passes=2, event_handler=handler)
    """

    def __init__(self, cost, optimizer, feed_list, device=DEFAULT_DEVICE,
                 fetch_list=None, main_program=None, startup_program=None):
        self.cost = cost
        self.main_program = main_program or ir.default_main_program()
        self.startup_program = startup_program or \
            ir.default_startup_program()
        self.optimizer = optimizer
        with ir.program_guard(self.main_program, self.startup_program):
            optimizer.minimize(cost)
        self.exe = Executor(device)
        self.feeder = DataFeeder(feed_list, device=self.exe.device,
                                 program=self.main_program)
        self.fetch_list = [cost] + list(fetch_list or [])
        self._initialized = False

    def _maybe_init(self):
        """Run the startup program once."""
        if not self._initialized:
            self.exe.run(self.startup_program)
            self._initialized = True

    def train(self, reader, num_passes=1, event_handler=None):
        """``num_passes`` passes over ``reader`` (a batched reader). Every
        ``FLAGS.log_period`` batches a progress line is printed."""
        self._maybe_init()
        handler = event_handler or (lambda e: None)
        log_period = FLAGS.log_period
        for pass_id in range(num_passes):
            handler(BeginPass(pass_id))
            costs = []
            for batch_id, data in enumerate(reader()):
                handler(BeginIteration(pass_id, batch_id))
                outs = self.exe.run(self.main_program,
                                    feed=self.feeder.feed(data),
                                    fetch_list=self.fetch_list)
                cost = float(np.asarray(outs[0]).reshape(-1)[0])
                costs.append(cost)
                if log_period and (batch_id + 1) % log_period == 0:
                    window = costs[-log_period:]
                    print("pass %d batch %d: cost=%.6f (avg %.6f)"
                          % (pass_id, batch_id, window[-1],
                             float(np.mean(window))))
                handler(EndIteration(pass_id, batch_id, cost,
                                     {"fetches": outs[1:]}))
            handler(EndPass(pass_id, {"avg_cost": float(np.mean(costs))
                                      if costs else float("nan")}))
