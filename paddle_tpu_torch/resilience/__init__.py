"""Degradation events and fault injection (the part of
``paddle_tpu/resilience`` that the autotune loop, the winner cache, the
generation engine, the checkpoints and the Trainer use): :mod:`.events`
records what was handled (durably too, for a preemption), :mod:`.faults`
arms the ``tune.candidate``, ``tune.cache``, ``serving.generate``,
``serving.speculate``, ``serving.prefix``, ``serving.ship``,
``pipeline.feed_next``, ``checkpoint.write`` and ``checkpoint.load``
sites. Retry policies, the other fault sites, the step watchdog, the
numeric guardrails and the gray-failure detector are not ported."""
from . import events, faults  # noqa: F401
