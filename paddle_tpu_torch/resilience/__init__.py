"""Degradation events and fault injection (the part of
``paddle_tpu/resilience`` that the autotune loop and the winner cache
use): :mod:`.events` records what was handled, :mod:`.faults` arms the
``tune.candidate`` and ``tune.cache`` sites. Retry policies, the other
fault sites and the gray-failure detector are not ported."""
from . import events, faults  # noqa: F401
