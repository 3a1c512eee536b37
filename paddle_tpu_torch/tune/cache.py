"""Persistent per-(device, kernel, shape) winner cache (counterpart of
``paddle_tpu/tune/cache.py``).

Winners live in one JSON file in ``FLAGS.tune_cache_dir``:

    <FLAGS.tune_cache_dir>/winners.torch.json
    {"schema": "paddle_tpu_torch.tune.v1",
     "entries": {"<device_kind>|<kernel>|<sig>":
                 {"config": {...}, "time_ms": ..., "timer": "wall|model",
                  ..., "crc32": <entry CRC>}}}

The JAX package reads the same ``PADDLE_TPU_FLAG_TUNE_CACHE_DIR`` and
keeps ``winners.json`` (schema ``paddle_tpu.tune.v1``) there. Its
configs are TPU tilings that mean nothing to the port's kernels and the
port's mean nothing to the TPU's, so the port has a file and a schema of
its own: in a shared directory neither package reads or overwrites the
other's winners.

Integrity: every entry carries a CRC32 over its canonical JSON, computed
before the bytes leave memory, and the write passes through the
``tune.cache`` fault site between the CRC and the disk (a test can
bit-rot the file after the CRC was derived). The file is replaced
atomically. A corrupt file or entry is detected, recorded as a
``tune_cache_corrupt`` event and read as empty: dispatch then misses,
and the next ``tune`` run re-tunes. Never a crash.

A process-level in-memory layer fronts the file: the first lookup per
cache directory loads and validates it once; every later lookup is a
dict hit.
"""
from __future__ import annotations

import json
import os
import threading
import zlib

from ..resilience.events import record_event
from ..resilience.faults import fault_point

__all__ = ["FILENAME", "SCHEMA", "WinnerCache", "cache_key",
           "clear_memory_cache", "default_cache_dir"]

SCHEMA = "paddle_tpu_torch.tune.v1"
FILENAME = "winners.torch.json"

_mem_lock = threading.Lock()
_mem = {}          # cache_dir -> {key: entry}  (validated, CRC-checked)


def default_cache_dir():
    from ..flags import FLAGS
    return os.path.expanduser(FLAGS.tune_cache_dir)


def cache_key(device_kind, kernel, sig):
    return "%s|%s|%s" % (device_kind, kernel, sig)


def _entry_crc(entry):
    """CRC32 of the entry's canonical JSON without the crc field."""
    body = {k: v for k, v in entry.items() if k != "crc32"}
    raw = json.dumps(body, sort_keys=True).encode("utf-8")
    return zlib.crc32(raw) & 0xFFFFFFFF


def clear_memory_cache():
    """Drop the process-level layer (test isolation, reload after a
    tune run in another process)."""
    with _mem_lock:
        _mem.clear()


class WinnerCache(object):
    """File-backed winner store for one cache directory."""

    def __init__(self, cache_dir=None):
        self.cache_dir = os.path.expanduser(cache_dir or
                                            default_cache_dir())
        self.path = os.path.join(self.cache_dir, FILENAME)

    def _load_validated(self):
        """Read and validate the file: {key: entry} with every surviving
        entry CRC-verified. Corruption is recorded, not raised."""
        if not os.path.exists(self.path):
            return {}
        try:
            with open(self.path, "rb") as f:
                doc = json.loads(f.read().decode("utf-8"))
            if not isinstance(doc, dict):
                raise ValueError("not a JSON object")
            if doc.get("schema") != SCHEMA:
                raise ValueError("schema %r != %r"
                                 % (doc.get("schema"), SCHEMA))
            entries = doc.get("entries", {})
            if not isinstance(entries, dict):
                raise ValueError("entries is not a mapping")
        except (ValueError, OSError, UnicodeDecodeError) as e:
            record_event("tune_cache_corrupt", site="tune.cache",
                         path=self.path, error=str(e)[:200])
            return {}
        out = {}
        for key, entry in entries.items():
            if (not isinstance(entry, dict)
                    or entry.get("crc32") != _entry_crc(entry)):
                record_event("tune_cache_corrupt", site="tune.cache",
                             path=self.path, key=key,
                             error="entry CRC mismatch")
                continue
            out[key] = entry
        return out

    def entries(self):
        """Validated entries through the in-memory layer."""
        with _mem_lock:
            cached = _mem.get(self.cache_dir)
        if cached is not None:
            return cached
        loaded = self._load_validated()
        with _mem_lock:
            return _mem.setdefault(self.cache_dir, loaded)

    def get(self, key):
        return self.entries().get(key)

    def get_config(self, key):
        e = self.get(key)
        return dict(e["config"]) if e and "config" in e else None

    def put(self, key, config, time_ms=None, timer=None, meta=None):
        """Install a winner and persist it. The read-modify-write holds
        the process lock, so two threads tuning against one directory
        keep each other's winners; across processes the last writer
        wins."""
        entry = {"config": dict(config),
                 "time_ms": None if time_ms is None else float(time_ms),
                 "timer": timer}
        if meta:
            entry.update(meta)
        entry["crc32"] = _entry_crc(entry)
        with _mem_lock:
            current = _mem.get(self.cache_dir)
            if current is None:
                current = self._load_validated()
            entries = dict(current)
            entries[key] = entry
            self._write(entries)
            _mem[self.cache_dir] = entries
        return entry

    def _write(self, entries):
        doc = {"schema": SCHEMA, "entries": entries}
        raw = json.dumps(doc, indent=1, sort_keys=True).encode("utf-8")
        # between the CRC and the disk: bit rot after the integrity data
        raw = fault_point("tune.cache", raw)
        os.makedirs(self.cache_dir, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, self.path)

    def drop(self, key):
        """Remove one entry; the same locking as put()."""
        with _mem_lock:
            current = _mem.get(self.cache_dir)
            if current is None:
                current = self._load_validated()
            entries = dict(current)
            if entries.pop(key, None) is None:
                _mem.setdefault(self.cache_dir, current)
                return False
            self._write(entries)
            _mem[self.cache_dir] = entries
        return True
