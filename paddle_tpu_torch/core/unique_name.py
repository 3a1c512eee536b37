"""Unique name generator (copy of ``paddle_tpu/core/unique_name.py``).
Build a Program under :func:`guard` in both packages and the auto-named
variables and parameters come out with the same names."""
from __future__ import annotations

import collections
import contextlib

__all__ = ["generate", "guard"]

_counters: dict = collections.defaultdict(int)


def generate(key: str) -> str:
    _counters[key] += 1
    return "%s_%d" % (key, _counters[key] - 1)


@contextlib.contextmanager
def guard(new_state=None):
    """Reset the namespace for the body (programs built inside are
    reproducible)."""
    global _counters
    old = _counters
    _counters = collections.defaultdict(int) if new_state is None \
        else new_state
    try:
        yield
    finally:
        _counters = old
