"""The knobs of the port (the ``serve_*`` part of ``paddle_tpu/flags.py``,
its ``log_period``, ``conv_impl`` and ``lstm_impl``, same names and
defaults).

Read as attributes of :data:`FLAGS`. A value can be overridden per
process with the environment variable ``PADDLE_TPU_FLAG_<NAME>`` (read
at first use, the JAX package's convention) or in code by assignment.
"""
from __future__ import annotations

import os
import threading

__all__ = ["FLAGS"]

_TRUE = frozenset(("1", "true", "yes", "on"))
_FALSE = frozenset(("0", "false", "no", "off", ""))


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    t = str(s).strip().lower()
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    raise ValueError("not a boolean: %r" % (s,))


# name -> (default, parser, help)
_DEFS = {
    "serve_queue_depth": (
        64, int, "bound on generation requests queued per engine; one "
        "more is shed with OverloadError (HTTP 429)"),
    "serve_max_running": (
        8, int, "most sequences decoded together by one decode step"),
    "serve_kv_pages": (
        64, int, "usable pages of the per-model KV pool (one trash page "
        "is added)"),
    "serve_page_tokens": (16, int, "K/V positions per page"),
    "serve_device_sample": (
        True, _parse_bool, "sample the next token on the device inside "
        "the step (only [R] tokens and logprobs reach the host); false "
        "samples on the host from the [R, V] logits"),
    "conv_impl": (
        "conv", str, "dense conv2d lowering: 'conv' (torch's conv2d) or "
        "'pallas3x3' (the hand-written 3x3 / s1 / p1 kernel for that "
        "population, torch's conv2d for the rest); PADDLE_TPU_CONV_IMPL "
        "overrides it, and a conv2d op's own 'conv_impl' attr takes "
        "precedence over it. 'matmul' (shifted matmuls) is not ported"),
    "lstm_impl": (
        "scan", str, "whole-sequence lstm and gru lowering: 'scan' (the "
        "plain time loop) or 'pallas' (the hand-written fused recurrence "
        "kernels, for the standard gate set with no peepholes and a "
        "hidden width that is a multiple of 128; the time loop for the "
        "rest). An lstm or gru op's own 'lstm_impl' attr takes precedence "
        "over it"),
    "log_period": (
        100, int, "Trainer.train prints a progress line every this many "
        "batches (0: never)"),
}


class _Flags(object):
    """Attribute access over the declared knobs; thread-safe writes."""

    def __init__(self):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_lock", threading.Lock())
        object.__setattr__(self, "_env_loaded", False)

    def _load_env_once(self):
        with self._lock:
            if self._env_loaded:
                return
            for name, (_, parse, _h) in _DEFS.items():
                key = "PADDLE_TPU_FLAG_" + name.upper()
                if key in os.environ:
                    self._values[name] = parse(os.environ[key])
            object.__setattr__(self, "_env_loaded", True)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in _DEFS:
            raise AttributeError("undeclared flag %r" % name)
        self._load_env_once()
        return self._values.get(name, _DEFS[name][0])

    def __setattr__(self, name, value):
        if name not in _DEFS:
            raise AttributeError("undeclared flag %r" % name)
        self._load_env_once()
        with self._lock:
            self._values[name] = _DEFS[name][1](value)


FLAGS = _Flags()
