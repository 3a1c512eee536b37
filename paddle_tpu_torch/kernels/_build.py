"""Build and load the port's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` has a plain C interface and becomes its
own shared library, compiled by ``nvcc`` for ``sm_90a`` into
``build/paddle_tpu_torch/`` at the root of the checkout (the directory
``.gitignore`` lists) on first use, and loaded with ``ctypes``; the
sources include the shared ``csrc/*.cuh`` headers. The file name carries
a hash of the source, every header and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. Nothing here runs
at import time: the CPU tests import every module of the port, and this
host has no ``nvcc``.

:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them; :func:`load` builds one library if it is missing and
returns the loaded ``ctypes.CDLL``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_all", "build_log",
           "check", "check_cuda_operands", "headers", "library_path", "load",
           "refuse_grad", "sources", "stream_handle"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded = {}


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``), sorted."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in %s/bin and on PATH): the CUDA "
            "kernels of paddle_tpu_torch are built on the machine that has "
            "the card" % cuda_home)
    return found


def headers():
    """Names of the shared headers (``csrc/*.cuh``), sorted."""
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` lives for the current
    source, headers and flags."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    for header in headers():
        digest.update(header.encode())
        with open(os.path.join(CSRC_DIR, header), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name,
                                                 digest.hexdigest()[:16]))


def _start(name, out):
    """Start ``nvcc`` for one source into a private temporary file; the
    caller renames it into place, so a reader never sees half a file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.%d.tmp" % (out, os.getpid(), threading.get_ident())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name, out, proc, tmp):
    log, _ = proc.communicate()
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("nvcc failed on csrc/%s.cu (exit %d):\n%s"
                           % (name, proc.returncode, log))
    os.replace(tmp, out)


def build_all():
    """Build every source whose library is missing, one ``nvcc`` each,
    all started together. Returns ``{name: seconds}`` for the sources it
    built (an up-to-date library costs nothing and is left out)."""
    with _lock:
        started = {}
        t0 = time.monotonic()
        for name in sources():
            out = library_path(name)
            if not os.path.exists(out):
                started[name] = (out,) + _start(name, out)
        took, errors = {}, []
        for name, (out, proc, tmp) in started.items():
            try:
                _finish(name, out, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
            took[name] = time.monotonic() - t0
        if errors:
            raise RuntimeError("\n".join(errors))
        return took


def build_log(name):
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) of the current library of ``csrc/<name>.cu``, or None."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built first if it is
    missing. Thread-safe; each library is loaded once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not os.path.exists(out):
            proc, tmp = _start(name, out)
            _finish(name, out, proc, tmp)
        lib = ctypes.CDLL(out)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
        return lib


def check(lib, code, what):
    """Raise when a kernel entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError("%s: CUDA error %d (%s)"
                           % (what, code, lib.error_string(code).decode()))


def refuse_grad(what, *tensors):
    """A wrapper without a backward kernel, called on a tensor that
    requires grad, raises instead of returning an output autograd cannot
    differentiate."""
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "%s has no backward: call it on tensors that do not require "
            "grad" % what)


def check_cuda_operands(what, device, **named):
    """Every operand must be a contiguous CUDA tensor on ``device``;
    raises ``ValueError`` naming the first that is not."""
    for name, t in named.items():
        if t.device != device:
            raise ValueError("%s: %s is on %s, the query on %s"
                             % (what, name, t.device, device))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (what, name))


def stream_handle(device):
    """The current CUDA stream of ``device`` as a pointer-sized int."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
