"""Program serialization, format version 1 (counterpart of
``paddle_tpu/core/serialize.py``).

``program_to_dict`` walks the blocks into a stable, JSON-clean
structure (vars sorted by name, ops in execution order, attrs with
sorted keys), ``program_to_protostr`` renders it canonically (sorted
keys, indent 1) and ``program_from_dict`` / ``program_from_protostr``
rebuild an executable Program. The format is the JAX package's, so a
protostr either package writes loads in the other, and the
``main_program`` / ``startup_program`` dicts of ``tests/golden/`` load
here.
"""
from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

from . import ir
from .types import VarType

__all__ = ["program_from_dict", "program_from_protostr", "program_to_dict",
           "program_to_protostr"]

_FORMAT_VERSION = 1


def _attr_to_json(v):
    if isinstance(v, ir.Block):
        return {"__block__": v.idx}
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (tuple, list)):
        return [_attr_to_json(x) for x in v]
    if isinstance(v, dict):
        return {k: _attr_to_json(x) for k, x in sorted(v.items())}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError("op attr %r (%s) is not serializable"
                    % (v, type(v).__name__))


def _attr_from_json(v, program):
    if isinstance(v, dict):
        if "__block__" in v:
            return program.blocks[v["__block__"]]
        if "__ndarray__" in v:
            return np.asarray(v["__ndarray__"], dtype=v["dtype"])
        return {k: _attr_from_json(x, program) for k, x in v.items()}
    if isinstance(v, list):
        return [_attr_from_json(x, program) for x in v]
    return v


def _var_to_json(v: ir.Variable) -> Dict[str, Any]:
    d = {
        "name": v.name,
        "shape": list(v.shape) if v.shape is not None else None,
        "dtype": str(getattr(v.dtype, "name", v.dtype)),
        "lod_level": v.lod_level,
        "persistable": bool(v.persistable),
        "stop_gradient": bool(v.stop_gradient),
        "type": getattr(v.type, "name", str(v.type)),
    }
    if isinstance(v, ir.Parameter):
        d["is_parameter"] = True
        d["trainable"] = bool(v.trainable)
        if v.optimize_attr and v.optimize_attr != {"learning_rate": 1.0}:
            d["optimize_attr"] = _attr_to_json(v.optimize_attr)
    if getattr(v, "is_data", False):
        d["is_data"] = True
    return d


def program_to_dict(program: ir.Program) -> Dict[str, Any]:
    """Stable, JSON-clean structure of the whole program."""
    blocks = []
    for blk in program.blocks:
        blocks.append({
            "idx": blk.idx,
            "parent_idx": blk.parent_idx,
            "vars": [_var_to_json(v) for _, v in sorted(blk.vars.items())],
            "ops": [{
                "type": op.type,
                "inputs": {s: list(ns)
                           for s, ns in sorted(op.inputs.items())},
                "outputs": {s: list(ns)
                            for s, ns in sorted(op.outputs.items())},
                "attrs": {k: _attr_to_json(v)
                          for k, v in sorted(op.attrs.items())},
            } for op in blk.ops],
        })
    d = {"format_version": _FORMAT_VERSION, "blocks": blocks}
    if program._seed is not None:
        d["random_seed"] = program._seed
    if getattr(program, "_data_vars_order", None):
        d["data_vars_order"] = [v.name for v in program._data_vars_order]
    return d


def program_from_dict(d: Dict[str, Any]) -> ir.Program:
    """Rebuild an executable Program from ``program_to_dict`` output."""
    if d.get("format_version") != _FORMAT_VERSION:
        raise ValueError("unsupported program format %r"
                         % d.get("format_version"))
    program = ir.Program()
    # every block first, so that BLOCK attrs resolve
    for bd in d["blocks"][1:]:
        program.blocks.append(ir.Block(program, bd["idx"], bd["parent_idx"]))
    for bd in d["blocks"]:
        blk = program.blocks[bd["idx"]]
        for vd in bd["vars"]:
            vtype = VarType[vd["type"]] if vd["type"] in \
                VarType.__members__ else vd["type"]
            kwargs = dict(shape=vd["shape"], dtype=vd["dtype"],
                          lod_level=vd["lod_level"],
                          persistable=vd["persistable"],
                          stop_gradient=vd["stop_gradient"],
                          type=vtype, name=vd["name"])
            if vd.get("is_parameter"):
                v = ir.Parameter(blk, kwargs.pop("shape"),
                                 kwargs.pop("dtype"),
                                 trainable=vd.get("trainable", True),
                                 **kwargs)
                if "optimize_attr" in vd:
                    v.optimize_attr = dict(vd["optimize_attr"])
            else:
                v = ir.Variable(blk, **kwargs)
            if vd.get("is_data"):
                v.is_data = True
            blk.vars[v.name] = v
        for od in bd["ops"]:
            op = ir.Operator(blk, od["type"])
            op.inputs = {s: list(ns) for s, ns in od["inputs"].items()}
            op.outputs = {s: list(ns) for s, ns in od["outputs"].items()}
            op.attrs = {k: _attr_from_json(v, program)
                        for k, v in od["attrs"].items()}
            blk.ops.append(op)
            for ns in op.outputs.values():
                for n in ns:
                    v = blk._find_var_recursive(n)
                    if v is not None:
                        v.op = op
    if "random_seed" in d:
        program._seed = d["random_seed"]
    if "data_vars_order" in d:
        gb = program.global_block()
        program._data_vars_order = [gb._find_var_recursive(n)
                                    for n in d["data_vars_order"]]
    program._bump_version()
    return program


def program_to_protostr(program: ir.Program) -> str:
    """Canonical text rendering (sorted keys, indent 1)."""
    return json.dumps(program_to_dict(program), sort_keys=True, indent=1)


def program_from_protostr(text: str) -> ir.Program:
    return program_from_dict(json.loads(text))
