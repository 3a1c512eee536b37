"""Saving and loading variables (counterpart of the first half of
``paddle_tpu/io.py``, :30-112). As in the JAX package, persistence is a
temporary program of ``save`` / ``load`` (or ``save_combine`` /
``load_combine``) ops that an Executor runs: one file a variable under
``dirname``, or every variable in ``dirname/filename``. The files are
the JAX package's pickle payloads, so either package loads what the
other saved.

Not ported yet: ``save_inference_model``, ``load_inference_model`` and
``get_inference_program``, which need ``core/serialize.py``.
"""
from __future__ import annotations

import os

from .core import ir
from .core.types import VarType

__all__ = ["load_params", "load_persistables", "load_vars", "save_params",
           "save_persistables", "save_vars"]


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, ir.Parameter)


def _build_io_program(op_type, dirname, vars, filename):
    prog = ir.Program()
    block = prog.global_block()
    names = []
    for v in vars:
        nv = block.create_var(name=v.name, shape=v.shape, dtype=v.dtype,
                              lod_level=v.lod_level, persistable=True)
        names.append(nv.name)
    if filename is None:
        for n in names:
            path = os.path.join(dirname, n)
            if op_type == "save":
                block.append_op("save", inputs={"X": [n]},
                                attrs={"file_path": path})
            else:
                block.append_op("load", outputs={"Out": [n]},
                                attrs={"file_path": path})
    else:
        path = os.path.join(dirname, filename)
        if op_type == "save":
            block.append_op("save_combine", inputs={"X": names},
                            attrs={"file_path": path})
        else:
            block.append_op("load_combine", outputs={"Out": names},
                            attrs={"file_path": path})
    return prog


def _select(main_program, vars, predicate):
    if vars is None:
        main_program = main_program or ir.default_main_program()
        vars = [v for v in main_program.list_vars()
                if (predicate or is_persistable)(v)]
    return vars


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Save ``vars`` (default: the program's vars ``predicate`` picks,
    persistables when None) from the global scope."""
    vars = [v for v in _select(main_program, vars, predicate)
            if v.type == VarType.LOD_TENSOR]
    executor.run(_build_io_program("save", dirname, vars, filename))


def save_params(executor, dirname, main_program=None, filename=None):
    """Save the Parameters only, not the optimizer's state."""
    save_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Save every persistable: parameters, optimizer accumulators, the
    learning rate; what resuming training needs."""
    save_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Load ``vars`` (chosen as :func:`save_vars` chooses) into the global
    scope."""
    vars = _select(main_program, vars, predicate)
    executor.run(_build_io_program("load", dirname, vars, filename))


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_persistable,
              filename=filename)
