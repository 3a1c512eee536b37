"""Saving and loading variables and inference models (counterpart of
``paddle_tpu/io.py``). As in the JAX package, persistence is a
temporary program of ``save`` / ``load`` (or ``save_combine`` /
``load_combine``) ops that an Executor runs: one file a variable under
``dirname``, or every variable in ``dirname/filename``. The files are
the JAX package's pickle payloads, so either package loads what the
other saved.

An inference model is the program pruned to its feeds and fetches
(``Program.prune``: a test clone, ``batch_norm`` on its running
statistics), pickled as ``{"program", "feed_names", "fetch_names"}`` to
``__model__``, beside the persistables the pruned ops read (no
optimizer state). :func:`load_inference_model` reads a ``__model__``
the JAX package wrote too: its unpickler maps the JAX package's
``core.ir`` and ``core.types`` classes to the port's own, allows the
numpy (and ml_dtypes) dtype types, and refuses every other global
with ``pickle.UnpicklingError``, so loading never imports the JAX
package. The JAX package cannot read a ``__model__`` the port writes,
which names the port's classes (ROADMAP Queue 3 #19); the parameter
files beside it load in either.
"""
from __future__ import annotations

import os
import pickle

from .core import ir
from .core.types import VarType

__all__ = ["get_inference_program", "load_inference_model", "load_params",
           "load_persistables", "load_vars", "save_inference_model",
           "save_params", "save_persistables", "save_vars"]

MODEL_FILENAME = "__model__"


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


def get_inference_program(target_vars, main_program=None):
    """``main_program`` pruned to ``target_vars`` (Variables or names)."""
    main_program = main_program or ir.default_main_program()
    fetches = [v.name if isinstance(v, ir.Variable) else v
               for v in target_vars]
    return main_program.prune(feeds=[], fetches=fetches)


def _read_names(program):
    """Every name an op of ``program``'s global block reads."""
    needed = set()
    for op in program.global_block().ops:
        needed.update(op.input_arg_names)
    return needed


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """Prune ``main_program`` to ``feeded_var_names`` and
    ``target_vars``, pickle it to ``dirname/__model__`` (or
    ``model_filename``) and save the persistables its ops read from the
    global scope. Returns the fetch names."""
    main_program = main_program or ir.default_main_program()
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, ir.Variable):
        target_vars = [target_vars]
    fetch_names = [v.name if isinstance(v, ir.Variable) else v
                   for v in target_vars]
    os.makedirs(dirname, exist_ok=True)
    pruned = main_program.prune(feeds=feeded_var_names, fetches=fetch_names)
    payload = {"program": pruned, "feed_names": list(feeded_var_names),
               "fetch_names": fetch_names}
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "wb") as f:
        pickle.dump(payload, f)
    needed = _read_names(pruned)
    vars = [v for v in main_program.list_vars()
            if v.persistable and v.name in needed]
    save_vars(executor, dirname, vars=vars, filename=params_filename)
    return fetch_names


# the JAX package's modules a __model__ may name -> the port's own
_MODULE_MAP = {"paddle_tpu.core.ir": "paddle_tpu_torch.core.ir",
               "paddle_tpu.core.types": "paddle_tpu_torch.core.types",
               "paddle_tpu_torch.core.ir": "paddle_tpu_torch.core.ir",
               "paddle_tpu_torch.core.types": "paddle_tpu_torch.core.types"}
_IR_CLASSES = {"Program", "Block", "Variable", "Parameter", "Operator",
               "VarType"}
_NUMPY_GLOBALS = {("numpy", "dtype"), ("numpy", "ndarray"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct"),
                  ("numpy.core.multiarray", "scalar"),
                  ("numpy._core.multiarray", "scalar"),
                  ("ml_dtypes", "bfloat16")}


class _ModelUnpickler(pickle.Unpickler):
    """Reads a ``__model__`` of either package: the IR classes map to the
    port's, numpy's array and dtype types pass, anything else is
    refused."""

    def find_class(self, module, name):
        if module in _MODULE_MAP and name in _IR_CLASSES:
            return super().find_class(_MODULE_MAP[module], name)
        if (module, name) in _NUMPY_GLOBALS or module == "numpy.dtypes":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            "__model__ names %s.%s: an inference model may hold only the "
            "Program IR's classes and numpy dtypes" % (module, name))


def _adopt(program):
    """Give an unpickled program the port's own attributes: the shape
    inference record the JAX Program lacks, without the JAX package's
    sharding annotations, under a fresh uid so that no compiled step of a
    live program with the pickled uid is hit."""
    program._shape_infer_failures = getattr(program,
                                            "_shape_infer_failures", [])
    for attr in ("_shardings", "_mesh_axes", "_is_distributed"):
        program.__dict__.pop(attr, None)
    ir.Program._uid_counter[0] += 1
    program._uid = ir.Program._uid_counter[0]
    return program


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Load an inference model saved by either package: its program, with
    the persistables its ops read installed in the global scope, and its
    feed and fetch names: ``(program, feed_names, fetch_names)``."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "rb") as f:
        payload = _ModelUnpickler(f).load()
    program = _adopt(payload["program"])
    needed = _read_names(program)
    vars = [v for v in program.list_vars()
            if v.persistable and v.name in needed]
    load_vars(executor, dirname, vars=vars, filename=params_filename)
    return program, list(payload["feed_names"]), \
        list(payload["fetch_names"])
