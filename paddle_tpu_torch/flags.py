"""The knobs of the port (the ``serve_*`` part of ``paddle_tpu/flags.py``,
its ``log_period``, ``conv_impl``, ``lstm_impl``, ``tune``,
``tune_cache_dir``, ``tune_budget``, ``memory_budget_gb``,
``check_nan_inf``, ``pipeline`` and ``pipeline_depth``, same names and
defaults).

Read as attributes of :data:`FLAGS`. A value can be overridden per
process through the environment, read at first use as the JAX package
reads it: ``PADDLE_TPU_FLAGS="pipeline=true,pipeline_depth=3"``, or one
flag at a time with ``PADDLE_TPU_FLAG_<NAME>`` (which wins); in code by
assignment, or for a block with :func:`flags_guard`.
"""
from __future__ import annotations

import contextlib
import os
import threading

__all__ = ["FLAGS", "flags_guard"]

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
    "serve_draft_dir": (
        "", str, "directory of a generative artifact to load as the draft "
        "model of speculative decoding (the target's vocabulary, a "
        "context at least as long; typically much smaller). Empty "
        "disables speculation unless the served artifact is a speculative "
        "pairing (inference.export_speculative), which carries its own "
        "draft. The draft gets its own page pool of serve_kv_pages x "
        "serve_page_tokens"),
    "serve_spec_k": (
        4, int, "speculation depth: tokens the draft proposes a round "
        "before one target step verifies them all. A request's spec_k can "
        "only lower it. Greedy output is the plain engine's at any k; a "
        "higher k pays while the draft's acceptance_rate holds up. 0 "
        "disables speculation even with a draft"),
    "serve_prefix_sharing": (
        False, _parse_bool, "key prompt pages by content (a rolling "
        "blake2b chain over serve_page_tokens-sized chunks) and let "
        "requests pin one physical copy of a shared prompt prefix; the "
        "first write into a shared page copies that page. Admission "
        "discounts the cached full pages a request will pin; an LRU keeps "
        "unreferenced prefix pages until allocation pressure reclaims "
        "them. Greedy output is the same with sharing on or off. A "
        "failure in the sharing layer degrades that engine to private "
        "pages with a recorded prefix_degraded event (fault site "
        "serving.prefix)"),
    "serve_tier": (
        "", str, "serving tier class for a disaggregated fleet "
        "(serving/disagg.py): empty = a do-everything replica; 'prefill' "
        "advertises a prefill-class replica (it runs the prompt pass and "
        "exports the finished KV pages with the request state); 'decode' "
        "a decode-class replica (it installs handoff artifacts and runs "
        "the token loop). The class is advertised through /statz and "
        "/healthz; a replica of either class still serves every route"),
    "memory_budget_gb": (
        0.0, float, "per-device memory budget (GiB) the PT034 check "
        "(analysis/memory.py) holds the KV pool plus the weights "
        "against. 0 = the card's memory (torch.cuda.mem_get_info); on "
        "the CPU no budget is known and the check stays silent"),
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
    "tune": (
        True, _parse_bool, "consult the paddle_tpu_torch.tune winner cache "
        "at kernel dispatch sites: a cached per-(device, shape) winner runs "
        "the kernel with the winning config (tune_hits); a miss keeps the "
        "legacy behaviour, the kernel's default config where a flag already "
        "enables the kernel (tune_misses), the stock PyTorch lowering "
        "otherwise (tune_fallbacks). 0 disables the consult"),
    "tune_cache_dir": (
        "~/.cache/paddle_tpu/tune", str, "directory of the persistent "
        "kernel-winner cache; the port's file there is winners.torch.json, "
        "so it never reads or overwrites the JAX package's winners.json"),
    "tune_budget": (
        0, int, "cap on the candidates the autotune loop builds and times "
        "per (kernel, shape), the stock rung included; 0 = the whole valid "
        "space. The CLI's --budget overrides it per run"),
    "log_period": (
        100, int, "Trainer.train prints a progress line every this many "
        "batches (0: never)"),
    "check_nan_inf": (
        False, _parse_bool, "scan every op output for NaN/Inf on the "
        "per-op path (FloatingPointError naming the variable); forces the "
        "eager path and a synchronous Trainer"),
    "pipeline": (
        False, _parse_bool, "default Trainer.train execution mode: True "
        "feeds batch k+1 on a feed thread (DataFeeder.feed and a pinned "
        "host-to-device copy on its own stream) while the card computes "
        "batch k, and leaves fetches on the card until a real sync point "
        "(paddle_tpu_torch.pipeline; Trainer.train(pipeline=...) "
        "overrides it). Losses are bit-identical to the synchronous "
        "mode; check_nan_inf forces synchronous"),
    "pipeline_depth": (
        2, int, "device feed slots the pipeline reuses in a ring (2 = "
        "double buffering; below 1 disables the pipeline)"),
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
            for pair in os.environ.get("PADDLE_TPU_FLAGS", "").split(","):
                k, _, v = pair.strip().partition("=")
                if k.strip() in _DEFS:
                    self._values[k.strip()] = _DEFS[k.strip()][1](v.strip())
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


@contextlib.contextmanager
def flags_guard(**overrides):
    """Set flags for a block and put the old values back after it."""
    saved = {k: getattr(FLAGS, k) for k in overrides}
    try:
        for k, v in overrides.items():
            setattr(FLAGS, k, v)
        yield FLAGS
    finally:
        for k, v in saved.items():
            setattr(FLAGS, k, v)
