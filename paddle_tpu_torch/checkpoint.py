"""Training checkpoints: asynchronous, atomic, CRC-checked (counterpart
of ``paddle_tpu/checkpoint.py``).

- **layout**: one ``.npy`` file a shard plus ``_MANIFEST.json`` (each
  variable's shape, dtype and shard files with their index ranges and
  CRC32) and a ``_COMPLETE`` marker written last (the step, every file's
  size and the manifest's CRC32). The port runs on one device, so every
  array is one shard whose index covers it; a checkpoint the JAX package
  wrote on a mesh is reassembled from its shards. The bytes are the JAX
  package's, so either package loads what the other wrote.
- **async**: the device-to-host copy of every persistable happens before
  ``save_checkpoint`` returns (the state is consistent at the call, and
  the compiled step updates the scope's tensors in place right after);
  only the file writing goes to a thread. ``AsyncCheckpoint.result()``
  joins it and re-raises its error.
- **atomic**: the files land in ``<dirname>.tmp``, the old checkpoint is
  moved to ``<dirname>.old``, the new one renamed into place and the old
  one removed: a torn write is never taken for a good checkpoint.
- **hardened**: the CRC32 of every shard and of the manifest is taken
  before the bytes leave memory (the ``checkpoint.write`` fault site sits
  between the CRC and the disk), so bit rot that keeps the size is found
  on load (:class:`CheckpointCorruption`). A corrupt checkpoint inside a
  retention root (``keep_last=``, ``ckpt-<step>`` directories) falls
  back to the newest older complete one, recording a
  ``checkpoint_fallback`` event; nothing is installed into the scope
  until every shard of the checkpoint loaded has verified.
- **bfloat16**: a bfloat16 array is saved as ``ml_dtypes.bfloat16``
  (what the JAX package writes); ``np.load`` gives its bytes back as a
  two-byte void type, which the loader views as the manifest's dtype.

``dist_context`` (a sharded restore) is not ported: passing one raises
``NotImplementedError``.
"""
from __future__ import annotations

import io as _io
import json
import os
import re
import shutil
import threading
import warnings
import zlib

import numpy as np
import torch

from .core.scope import global_scope
from .core.types import VarType, bfloat16, torch_dtype
from .device import DEFAULT_DEVICE, resolve_device
from .resilience.events import record_event
from .resilience.faults import fault_point

__all__ = ["AsyncCheckpoint", "CheckpointCorruption", "latest_checkpoint",
           "load_checkpoint", "load_latest", "save_checkpoint"]

_MANIFEST = "_MANIFEST.json"
_COMPLETE = "_COMPLETE"
_HAVE_BF16 = bfloat16 != np.dtype("float32")


class CheckpointCorruption(IOError):
    """A checkpoint's bytes do not match their recorded CRC32, or its
    manifest or a shard does not parse: the marker said complete, the
    data disagrees."""


def _no_dist_context(dist_context):
    if dist_context is not None:
        raise NotImplementedError(
            "dist_context: a sharded restore is not ported (ROADMAP Queue 1 "
            "item 6, distributed training); the port restores onto one "
            "device")


def _host_array(v):
    """A host numpy copy of tensor ``v``, finished when this returns. A
    bfloat16 tensor becomes an ``ml_dtypes.bfloat16`` array (its raw
    two-byte words without ml_dtypes)."""
    t = v.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy()
        return bits.view(bfloat16 if _HAVE_BF16 else np.dtype("V2"))
    return t.numpy()


def _snapshot(scope, var_names):
    """Device-to-host copy of every named tensor of ``scope``: the
    consistency point of a save."""
    entries = {}
    for name in var_names:
        v = scope.find_var(name)
        if not isinstance(v, torch.Tensor):
            continue
        arr = _host_array(v)
        dtype = "bfloat16" if v.dtype == torch.bfloat16 else str(arr.dtype)
        entries[name] = {"shape": list(arr.shape), "dtype": dtype,
                         "shards": [{"index": [[0, s] for s in arr.shape],
                                     "data": arr}]}
    return entries


def _write(dirname, entries, step):
    tmp = dirname + ".tmp"
    # empty a stale .tmp but keep the directory itself: for a retention
    # save it is the step's reservation, made in save_checkpoint
    if os.path.exists(tmp):
        for f in os.listdir(tmp):
            p = os.path.join(tmp, f)
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.remove(p)
    else:
        os.makedirs(tmp)
    manifest = {"step": step, "vars": {}}
    sizes = {}
    for name, e in entries.items():
        files = []
        for i, sh in enumerate(e["shards"]):
            fn = "%s.shard%d.npy" % (name.replace("/", "__"), i)
            buf = _io.BytesIO()
            np.save(buf, sh["data"])
            raw = buf.getvalue()
            # the CRC is of the bytes meant for the disk; the fault point
            # sits between it and the write, where bit rot lives
            crc = zlib.crc32(raw) & 0xFFFFFFFF
            raw = fault_point("checkpoint.write", payload=raw)
            with open(os.path.join(tmp, fn), "wb") as f:
                f.write(raw)
            files.append({"file": fn, "index": sh["index"], "crc32": crc})
            sizes[fn] = len(raw)
        manifest["vars"][name] = {"shape": e["shape"], "dtype": e["dtype"],
                                  "files": files}
    mraw = json.dumps(manifest).encode("utf-8")
    mcrc = zlib.crc32(mraw) & 0xFFFFFFFF
    mraw = fault_point("checkpoint.write", payload=mraw)
    with open(os.path.join(tmp, _MANIFEST), "wb") as f:
        f.write(mraw)
    # the marker last: it certifies every byte above it
    with open(os.path.join(tmp, _COMPLETE), "w") as f:
        json.dump({"step": step, "sizes": sizes, "manifest_crc32": mcrc}, f)
    # the old good checkpoint goes only once the new one is in place
    aside = dirname + ".old"
    if os.path.exists(aside):
        shutil.rmtree(aside)
    if os.path.exists(dirname):
        os.replace(dirname, aside)
    os.replace(tmp, dirname)
    if os.path.exists(aside):
        shutil.rmtree(aside)


class AsyncCheckpoint(object):
    """Handle of a checkpoint written by a background thread."""

    def __init__(self, thread, state):
        self._thread = thread
        self._state = state

    def result(self, timeout=None):
        """Wait for the write; its directory, or its error raised."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still running")
        if self._state.get("error") is not None:
            raise self._state["error"]
        return self._state["dirname"]

    def done(self):
        return not self._thread.is_alive()


# the step resolution and .tmp reservation of a retention save, so that
# overlapping async saves never take the same step
_reserve_lock = threading.Lock()


def _retained_dir(root, step):
    """The directory of ``step`` under a retention root; with no step,
    the index after the newest taken one (``.tmp`` / ``.old`` count)."""
    if step is None:
        taken = [-1]
        if os.path.isdir(root):
            for d in os.listdir(root):
                for suffix in (".tmp", ".old"):
                    if d.endswith(suffix):
                        d = d[:-len(suffix)]
                        break
                if d.startswith("ckpt-"):
                    try:
                        taken.append(int(d[len("ckpt-"):]))
                    except ValueError:
                        pass
        step = max(taken) + 1
    return os.path.join(root, "ckpt-%08d" % step), step


def _mtime_or_none(path):
    """mtime of ``path``, or None when a concurrent prune removed it."""
    try:
        return os.path.getmtime(path)
    except (FileNotFoundError, NotADirectoryError):
        return None


def _retained_step(path):
    """The step of a ``ckpt-<step>`` basename, -1 for anything else.
    Retention orders by the step first and by mtime only to break a tie:
    a filesystem with one-second mtimes stamps two quick saves alike."""
    name = os.path.basename(os.path.normpath(path))
    if name.startswith("ckpt-"):
        try:
            return int(name[len("ckpt-"):])
        except ValueError:
            pass
    return -1


def _candidates(root):
    return [os.path.join(root, d) for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
            and not d.endswith((".tmp", ".old"))]


def _prune(root, keep_last):
    """Keep the newest ``keep_last`` complete checkpoints under ``root``;
    torn ones stay for inspection. Entries a concurrent prune removed
    are skipped."""
    stamped = []
    for d in _candidates(root):
        if not _is_complete(d):
            continue
        mt = _mtime_or_none(d)
        if mt is not None:
            stamped.append((_retained_step(d), mt, d))
    stamped.sort(reverse=True)
    for _, _, stale in stamped[keep_last:]:
        shutil.rmtree(stale, ignore_errors=True)


def save_checkpoint(dirname, main_program=None, scope=None, step=None,
                    async_=False, keep_last=None):
    """Save every persistable of ``main_program`` from ``scope``.
    ``async_=True`` returns an :class:`AsyncCheckpoint` once the
    device-to-host copy is done; otherwise the checkpoint's directory.

    ``keep_last=N`` takes the retention layout: ``dirname`` is a root of
    ``ckpt-<step>`` directories (``step`` defaults to the next free
    one), of which the newest N complete ones are kept."""
    from .core import ir

    program = main_program or ir.default_main_program()
    scope = scope or global_scope()
    names = [v.name for v in program.list_vars()
             if v.persistable and v.type == VarType.LOD_TENSOR]
    entries = _snapshot(scope, names)  # the consistency point

    root = None
    if keep_last is not None:
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        root = dirname
        os.makedirs(root, exist_ok=True)
        with _reserve_lock:
            dirname, step = _retained_dir(root, step)
            # reserve the step now: the write makes the directory only
            # at its rename
            os.makedirs(dirname + ".tmp", exist_ok=True)

    if not async_:
        _write(dirname, entries, step)
        if root is not None:
            _prune(root, keep_last)
        return dirname

    state = {"dirname": dirname, "error": None}

    def work():
        try:
            _write(dirname, entries, step)
            if root is not None:
                _prune(root, keep_last)
        except BaseException as e:  # re-raised by result()
            state["error"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return AsyncCheckpoint(t, state)


def _is_complete(dirname):
    marker = os.path.join(dirname, _COMPLETE)
    if not os.path.exists(marker):
        return False
    try:
        with open(marker) as f:
            meta = json.load(f)
        for fn, size in meta.get("sizes", {}).items():
            if os.path.getsize(os.path.join(dirname, fn)) != size:
                return False
        return True
    except Exception:
        return False


def latest_checkpoint(root):
    """The newest complete checkpoint directory under ``root`` (torn ones
    skipped), or None."""
    if not os.path.isdir(root):
        return None
    stamped = [(_retained_step(d), _mtime_or_none(d), d)
               for d in _candidates(root) if _is_complete(d)]
    stamped = [(st, mt, d) for st, mt, d in stamped if mt is not None]
    return max(stamped)[2] if stamped else None


def _read_shard(dirname, sh, verify):
    """One shard file as an ndarray, its CRC32 held to the manifest's."""
    path = os.path.join(dirname, sh["file"])
    with open(path, "rb") as f:
        raw = f.read()
    fault_point("checkpoint.load")
    want = sh.get("crc32")  # absent in checkpoints written before CRCs
    if verify and want is not None \
            and (zlib.crc32(raw) & 0xFFFFFFFF) != want:
        raise CheckpointCorruption("checkpoint shard %s fails its CRC32 "
                                   "(stored %d)" % (path, want))
    try:
        return np.load(_io.BytesIO(raw))
    except Exception as e:
        raise CheckpointCorruption("checkpoint shard %s unreadable: %r"
                                   % (path, e))


# the retention entries' names: the corruption fallback walks only these,
# since a stand-alone checkpoint's siblings are not its history
_RETAIN_RE = re.compile(r"^ckpt-\d{8}$")


def _previous_complete(dirname):
    """The newest complete retention sibling older than ``dirname`` by
    (step, mtime, path), or None unless ``dirname`` is a retention
    entry."""
    me = os.path.abspath(dirname)
    if not _RETAIN_RE.match(os.path.basename(me)):
        return None
    root = os.path.dirname(me)
    mine = (_retained_step(me), os.path.getmtime(me), me)
    cands = []
    for d in os.listdir(root):
        p = os.path.abspath(os.path.join(root, d))
        if p == me or not os.path.isdir(p) or not _RETAIN_RE.match(d):
            continue
        if not _is_complete(p):
            continue
        key = (_retained_step(p), os.path.getmtime(p), p)
        if key < mine:
            cands.append((key, p))
    return max(cands)[1] if cands else None


def _staging(dtype):
    """(numpy dtype the array is staged in, torch dtype installed) of a
    manifest dtype: a bfloat16 array is staged as its int16 words."""
    if dtype == "bfloat16":
        return np.dtype(np.int16), torch.bfloat16
    d = np.dtype(dtype)
    return d, torch_dtype(d)


def _as_staging(data, staged):
    """``data`` (a shard as np.load gave it) viewed in the staging dtype
    when it holds the same words: a bfloat16 shard loads as a two-byte
    void type (or as ml_dtypes.bfloat16)."""
    if data.dtype != staged and data.dtype.itemsize == staged.itemsize \
            and (data.dtype.kind == "V" or data.dtype.name == "bfloat16"):
        return data.view(staged)
    return data


def _load_one(dirname, program, scope, device, verify):
    """Read, verify and install one checkpoint directory. Every value is
    staged on the host first and installed only after all verified, so a
    corrupt shard leaves the scope as it was."""
    if not _is_complete(dirname):
        raise IOError("checkpoint %r is missing or torn (no valid %s)"
                      % (dirname, _COMPLETE))
    with open(os.path.join(dirname, _COMPLETE)) as f:
        marker = json.load(f)
    with open(os.path.join(dirname, _MANIFEST), "rb") as f:
        mraw = f.read()
    want = marker.get("manifest_crc32")
    if verify and want is not None \
            and (zlib.crc32(mraw) & 0xFFFFFFFF) != want:
        raise CheckpointCorruption("checkpoint manifest in %r fails its "
                                   "CRC32" % dirname)
    try:
        manifest = json.loads(mraw.decode("utf-8"))
    except ValueError as e:
        raise CheckpointCorruption("checkpoint manifest in %r unreadable: "
                                   "%r" % (dirname, e))
    wanted = {v.name for v in program.list_vars() if v.persistable}
    staged = {}
    for name, e in manifest["vars"].items():
        if name not in wanted:
            continue
        try:
            np_dtype, t_dtype = _staging(e["dtype"])
        except TypeError as err:
            raise CheckpointCorruption("checkpoint var %s has dtype %r: %r"
                                       % (name, e["dtype"], err))
        arr = np.zeros(tuple(e["shape"]), dtype=np_dtype)
        for sh in e["files"]:
            data = _as_staging(_read_shard(dirname, sh, verify), np_dtype)
            sl = tuple(slice(a, b) for a, b in sh["index"])
            try:
                arr[sl] = data
            except (ValueError, TypeError) as err:
                raise CheckpointCorruption(
                    "checkpoint shard %s has wrong shape/dtype: %r"
                    % (sh["file"], err))
        staged[name] = (arr, t_dtype)
    for name, (arr, t_dtype) in staged.items():
        dev = device
        if dev is None:
            cur = scope.find_var(name)
            dev = cur.device if isinstance(cur, torch.Tensor) \
                else resolve_device(DEFAULT_DEVICE)
        # a copy: torch.from_numpy aliases the staged array, and the
        # compiled step writes the scope's tensors in place
        t = torch.from_numpy(arr).to(device=dev, copy=True)
        scope.set_var(name, t.view(t_dtype) if t.dtype != t_dtype else t)
    return manifest.get("step")


def load_checkpoint(dirname, main_program=None, scope=None,
                    dist_context=None, verify=True, fallback=True,
                    device=None):
    """Install the persistables of ``main_program`` that the checkpoint
    in ``dirname`` holds into ``scope``; returns its step. Each value
    goes to ``device``, else to the device of the scope's current value,
    else to the default device.

    Every shard's CRC32 is verified (``verify=False`` skips it). On
    corruption, with ``fallback=True``, the newest older complete
    retention sibling is loaded instead, walking back as far as the
    retention reaches, and a ``checkpoint_fallback`` event records it.
    Without one, :class:`CheckpointCorruption` propagates."""
    from .core import ir

    _no_dist_context(dist_context)
    program = main_program or ir.default_main_program()
    scope = scope or global_scope()
    return _load_with_fallback(dirname, program, scope, device, verify,
                               fallback)[1]


def _load_with_fallback(dirname, program, scope, device, verify, fallback):
    """(the directory loaded, its step), walking back through the
    retention history on corruption when ``fallback`` is set."""
    while True:
        try:
            return dirname, _load_one(dirname, program, scope, device,
                                      verify)
        except CheckpointCorruption as e:
            if not fallback:
                raise
            prev = _previous_complete(dirname)
            if prev is None:
                raise
            record_event("checkpoint_fallback", site="checkpoint.load",
                         bad=os.path.abspath(dirname), used=prev,
                         error=str(e))
            warnings.warn("checkpoint %s is corrupt (%s); falling back to %s"
                          % (dirname, e, prev))
            dirname = prev


def load_latest(root, main_program=None, scope=None, dist_context=None,
                device=None):
    """Load the newest loadable complete checkpoint under the retention
    root ``root``, falling back past corrupt ones: (the directory loaded,
    its step), or None when the root holds no complete checkpoint. A
    newest checkpoint that a concurrent prune removes between the scan
    and the read sends the scan on to the next newest."""
    from .core import ir

    _no_dist_context(dist_context)
    program = main_program or ir.default_main_program()
    scope = scope or global_scope()
    tried = set()
    while True:
        newest = latest_checkpoint(root)
        if newest is None:
            return None
        if newest in tried:
            # the same entry again after a failure: not a prune race
            return _load_with_fallback(newest, program, scope, device, True,
                                       True)
        tried.add(newest)
        try:
            return _load_with_fallback(newest, program, scope, device, True,
                                       True)
        except (IOError, OSError) as e:
            # corruption already walked the retention history
            if isinstance(e, CheckpointCorruption) or os.path.isdir(newest):
                raise
            record_event("checkpoint_pruned_during_load",
                         site="checkpoint.load", bad=newest)
