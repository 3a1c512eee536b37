"""IO and debug ops (counterpart of ``paddle_tpu/ops/io_ops.py``):
``save``, ``load``, ``save_combine`` and ``load_combine`` are host ops,
so a program that holds one runs on the Executor's hybrid path.

A file holds the JAX package's pickle payload, ``{"data": ndarray,
"lod": [offsets of each level]}`` (a list of them for the combined
ops), so a file one package writes loads in the other. A bfloat16 value
is written as an ``ml_dtypes.bfloat16`` array, bit for bit.

``print`` is a host op here too: a captured graph cannot call Python,
where the JAX package lowers ``print`` to ``jax.debug.print`` inside jit
(a deliberate difference, ROADMAP Queue 3).
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..core.executor import (LoDValue, _fetch_to_host, _to_device_value,
                             raw_data)
from ..core.lod import LoDTensor
from ..core.registry import register_op

__all__ = []


def _payload(value):
    host = _fetch_to_host(value) if not isinstance(value, LoDTensor) \
        else value
    if isinstance(host, LoDTensor):
        return {"data": np.asarray(host.numpy()),
                "lod": [list(map(int, l)) for l in host.lod()]}
    return {"data": np.asarray(host), "lod": []}


def _value(item, device):
    if item["lod"]:
        return _to_device_value(LoDTensor(item["data"], item["lod"]), device)
    return _to_device_value(item["data"], device)


def _write(path, payload):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@register_op("save", host=True, no_gradient=True)
def save(ctx):
    path = ctx.attr("file_path")
    if not ctx.attr("overwrite", True) and os.path.exists(path):
        raise IOError("%s exists and overwrite=False" % path)
    _write(path, _payload(ctx.input("X")))


@register_op("load", host=True, no_gradient=True)
def load(ctx):
    ctx.set_output("Out", _value(_read(ctx.attr("file_path")), ctx.device))


@register_op("save_combine", host=True, no_gradient=True)
def save_combine(ctx):
    _write(ctx.attr("file_path"), [_payload(v) for v in ctx.inputs("X")])


@register_op("load_combine", host=True, no_gradient=True)
def load_combine(ctx):
    ctx.set_outputs("Out", [_value(item, ctx.device)
                            for item in _read(ctx.attr("file_path"))])


_PRINT_COUNTS = {}


@register_op("print", host=True, no_gradient=True)
def print_op(ctx):
    """Print a value with its name, dtype, shape and LoD (the JAX
    package's ``print_op``: ``summarize`` caps the elements shown,
    ``first_n`` the prints of this op, ``print_phase`` BACKWARD prints
    nothing here)."""
    x = ctx.input("In") if ctx.has_input("In") else ctx.input("X")
    msg = ctx.attr("message", "")
    summarize = int(ctx.attr("summarize", -1) or -1)
    first_n = int(ctx.attr("first_n", -1) or -1)
    phase = str(ctx.attr("print_phase", "BOTH")).upper()
    slot = "Out" if ctx.output_names("Out") else "Output"
    ctx.set_output(slot, x)
    if phase == "BACKWARD":
        return
    data = raw_data(x)
    host = _fetch_to_host(data)
    shown = host.reshape(-1)[:summarize] if summarize > 0 else host
    out_name = (ctx.output_names(slot) or [msg])[0]
    header = [msg] if msg else []
    if ctx.attr("print_tensor_name", True):
        header.append("name: %s" % out_name)
    if ctx.attr("print_tensor_type", True):
        header.append("dtype: %s" % host.dtype)
    if ctx.attr("print_tensor_shape", True):
        header.append("shape: %s" % (tuple(host.shape),))
    if ctx.attr("print_tensor_lod", True) and isinstance(x, LoDValue) \
            and x.lod:
        header.append("lod: %s" % ([l.cpu().tolist() for l in x.lod],))
    # the first_n budget holds across runs of one program's op
    key = (ctx.block.program._uid, out_name)
    _PRINT_COUNTS[key] = _PRINT_COUNTS.get(key, 0) + 1
    if first_n < 0 or _PRINT_COUNTS[key] <= first_n:
        print("%s %s" % ("  ".join(header), shown), flush=True)
