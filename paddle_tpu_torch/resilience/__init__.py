"""Degradation events and fault injection (the part of
``paddle_tpu/resilience`` that the autotune loop, the winner cache and
the generation engine use): :mod:`.events` records what was
handled, :mod:`.faults` arms the ``tune.candidate``, ``tune.cache``,
``serving.generate``, ``serving.speculate``, ``serving.prefix``,
``serving.ship`` and ``pipeline.feed_next`` sites. Retry policies, the other fault sites and the gray-failure
detector are not ported."""
from . import events, faults  # noqa: F401
