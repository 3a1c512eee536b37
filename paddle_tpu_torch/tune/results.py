"""Device identity and the tune verb's evidence record (counterpart of
``paddle_tpu/tune/results.py``, schema ``paddle_tpu.bench.v1``):

    {"schema": "paddle_tpu.bench.v1", "bench": "<harness name>",
     "device": "<device_kind>", "platform": "cuda|cpu",
     "commit": null, "meta": {...}, "rows": [{...}, ...]}

The port writes its records under ``build/tune/`` of the checkout (a
directory ``.gitignore`` lists), not into ``benchmark/results``.
"""
from __future__ import annotations

import json
import os

import torch

__all__ = ["bench_record", "device_kind", "write_result"]

SCHEMA = "paddle_tpu.bench.v1"

_DEVICE_KIND = None


def device_kind():
    """Canonical device identity for cache keys and result files:
    ``torch.cuda.get_device_name()`` on a card, ``"cpu"`` otherwise.
    Stable for the process, so it is derived once."""
    global _DEVICE_KIND
    if _DEVICE_KIND is None:
        _DEVICE_KIND = (torch.cuda.get_device_name()
                        if torch.cuda.is_available() else "cpu")
    return _DEVICE_KIND


def bench_record(bench, rows, meta=None):
    return {
        "schema": SCHEMA,
        "bench": bench,
        "device": device_kind(),
        "platform": "cuda" if torch.cuda.is_available() else "cpu",
        "commit": None,
        "meta": dict(meta or {}),
        "rows": list(rows),
    }


def write_result(rec, path=None):
    """Write ``rec`` to ``path`` (default
    ``build/tune/<bench>_<device>.json`` of the checkout); returns the
    path."""
    if path is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        safe = rec["device"]
        for ch in " /|":
            safe = safe.replace(ch, "_")
        path = os.path.join(root, "build", "tune",
                            "%s_%s.json" % (rec["bench"], safe))
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path
