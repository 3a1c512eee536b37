"""PT034, the serving KV pool's memory-budget check (the PT034 part of
``paddle_tpu/analysis/memory.py``, same functions, numbers and
messages).

The generation engine preallocates its paged KV pool, K and V of
``[layers, pages + 1, page_tokens, heads, head_dim]`` each (the + 1 is
the trash page), beside the model's weights. :func:`check_kv_pool`
holds the two against a per-device budget, resolved by
:func:`resolve_budget_bytes` in the JAX package's order: an explicit
value, then ``FLAGS.memory_budget_gb``, then the device's memory. The
device's memory is ``torch.cuda.mem_get_info(device)[1]`` on a card
(the JAX package reads ``bytes_limit`` of a TPU); on the CPU there is
none, and the check stays silent.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Diagnostic", "card", "check_kv_pool", "fmt_bytes",
           "kv_pool_bytes", "resolve_budget_bytes"]


class Diagnostic(object):
    """One finding: a stable ``PTxxx`` code, its severity, the message
    and a fix hint; ``str()`` is the JAX package's rendering."""

    __slots__ = ("code", "severity", "message", "hint")

    def __init__(self, code, severity, message, hint=None):
        self.code = code
        self.severity = severity
        self.message = message
        self.hint = hint

    @property
    def is_error(self):
        return self.severity == "error"

    def __str__(self):
        s = "%s %s: %s" % (self.code, self.severity, self.message)
        if self.hint:
            s += " (hint: %s)" % self.hint
        return s

    def __repr__(self):
        return "Diagnostic(%s)" % self


def _dtype_bytes(dtype):
    try:
        return int(np.dtype(getattr(dtype, "name", dtype) or
                            "float32").itemsize)
    except TypeError:
        return 4


def fmt_bytes(n):
    """Human byte count, the formatter of the PT034 messages and the
    serve verb's aggregate verdict."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return ("%.2f %s" % (n, unit)) if unit != "B" \
                else ("%d B" % int(n))
        n /= 1024.0


def kv_pool_bytes(num_layers, num_heads, head_dim, kv_pages, page_tokens,
                  dtype="float32"):
    """Bytes of the paged KV pool the generation engine preallocates:
    K and V, ``[layers, pages + 1, page_tokens, heads, head_dim]`` each
    (the + 1 is the trash page, ``serving/kvcache.py``)."""
    per = (int(num_layers) * (int(kv_pages) + 1) * int(page_tokens)
           * int(num_heads) * int(head_dim) * _dtype_bytes(dtype))
    return 2 * per


def check_kv_pool(num_layers, num_heads, head_dim, kv_pages, page_tokens,
                  dtype="float32", model_bytes=0, budget_bytes=None):
    """PT034: the preallocated KV pool plus the resident model must fit
    the budget. Returns a list of :class:`Diagnostic` ([] when they fit
    or when no budget is known)."""
    if not budget_bytes:
        return []
    pool = kv_pool_bytes(num_layers, num_heads, head_dim, kv_pages,
                         page_tokens, dtype)
    headroom = int(budget_bytes) - int(model_bytes)
    if pool <= headroom:
        return []
    return [Diagnostic(
        "PT034", "error",
        "KV page pool needs %s (%d pages x %d tokens x %d layers x %d "
        "heads x %d head_dim, K+V + trash page) but only %s remain after "
        "the %s model on a %s budget"
        % (fmt_bytes(pool), int(kv_pages), int(page_tokens),
           int(num_layers), int(num_heads), int(head_dim),
           fmt_bytes(max(headroom, 0)), fmt_bytes(model_bytes),
           fmt_bytes(budget_bytes)),
        hint="lower --kv_pages / FLAGS.serve_kv_pages or --page_tokens, "
             "serve a smaller model, or raise FLAGS.memory_budget_gb if "
             "the device really has more")]


def card():
    """The card this process serves on (the current CUDA device), or
    None on a process without one."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def resolve_budget_bytes(budget_gb=None, device=None):
    """The budget the check compares against: an explicit ``budget_gb``
    beats ``FLAGS.memory_budget_gb`` beats the memory of ``device`` (a
    CUDA device's total memory). None when no budget is known (no
    device, or a CPU one): PT034 then stays silent."""
    if budget_gb:
        return int(float(budget_gb) * (1 << 30))
    from ..flags import FLAGS
    if FLAGS.memory_budget_gb > 0:
        return int(float(FLAGS.memory_budget_gb) * (1 << 30))
    if device is not None:
        import torch
        device = torch.device(device)
        if device.type == "cuda":
            try:
                return int(torch.cuda.mem_get_info(device)[1])
            except Exception:
                return None
    return None
