"""Program IR (counterpart of ``paddle_tpu/core/ir.py``).

A ``Program`` is a list of ``Block``s; a ``Block`` holds named
``Variable``s and a sequence of ``Operator``s. The port's Executor
interprets a block op by op over ``torch.Tensor``s, so the IR here is
the JAX package's as it is, minus the sharding and mesh annotations and
the operator sugar on ``Variable`` (later slices). A Program carries a
process-unique ``_uid`` (a clone gets a fresh one) and a ``_version``
that every appended or inserted op bumps: the Executor keys its compiled
steps on both, so a mutated program never replays a stale step.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional

from . import unique_name
from .types import VarType, convert_dtype

__all__ = ["GRAD_SUFFIX", "Block", "Operator", "Parameter", "Program",
           "Variable", "default_main_program", "default_startup_program",
           "grad_var_name", "program_guard"]

GRAD_SUFFIX = "@GRAD"

# per-program cap on recorded shape-inference failures
SHAPE_INFER_FAILURE_CAP = 64


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Variable(object):
    """Symbolic variable inside a Block. ``shape`` may hold -1 for the
    batch dimension, resolved when the feed arrives."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 type=VarType.LOD_TENSOR, initializer=None, **kwargs):
        self.block = block
        self.name = name if name is not None \
            else unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if type == VarType.LOD_TENSOR \
            else dtype
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.op = None  # producing operator, set by Block.append_op

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s, lod=%s%s)" % (
            self.name, self.shape, getattr(self.dtype, "name", self.dtype),
            self.lod_level, ", persistable" if self.persistable else "")

    __str__ = __repr__


class Parameter(Variable):
    """Trainable variable; persistable, lives in the global block."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype,
                                        **kwargs)


class Operator(object):
    """One op node: type, named input and output slots (slot -> list of
    var names), attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs: Dict[str, Any] = dict(attrs or {})

        def _names(v):
            if v is None:
                return []
            if isinstance(v, (list, tuple)):
                return [x.name if isinstance(x, Variable) else x for x in v]
            return [v.name if isinstance(v, Variable) else v]

        for slot, v in (inputs or {}).items():
            self.inputs[slot] = _names(v)
        for slot, v in (outputs or {}).items():
            self.outputs[slot] = _names(v)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        ins = ", ".join("%s=%s" % kv for kv in sorted(self.inputs.items()))
        outs = ", ".join("%s=%s" % kv for kv in sorted(self.outputs.items()))
        return "{%s} = %s(%s)" % (outs, self.type, ins)


class Block(object):
    """Vars and an op list; chains to a parent block."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self):
        if self.parent_idx < 0 or self.parent_idx >= len(self.program.blocks):
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        shape = kwargs.pop("shape")
        dtype = kwargs.pop("dtype", "float32")
        param = Parameter(self, shape, dtype, **kwargs)
        gb = self.program.global_block()
        gb.vars[param.name] = param
        param.block = gb
        return param

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError("Variable %r not found in block %d"
                           % (name, self.idx))
        return v

    def has_var(self, name) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name) -> Optional[Variable]:
        blk = self
        seen = set()
        while blk is not None and blk.idx not in seen:
            if name in blk.vars:
                return blk.vars[name]
            seen.add(blk.idx)
            blk = blk.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for names in op.outputs.values():
            for n in names:
                v = self._find_var_recursive(n)
                if v is not None:
                    v.op = op
        self._infer_shape(op)
        self.program._bump_version()
        return op

    def insert_op(self, index, type, inputs=None, outputs=None,
                  attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self._infer_shape(op)
        self.program._bump_version()
        return op

    def _infer_shape(self, op):
        """Best effort: real shapes come from the run. A failure is
        recorded on the program (bounded), never raised."""
        from . import registry
        opdef = registry.lookup(op.type)
        if opdef is None or opdef.infer_shape is None:
            return
        try:
            opdef.infer_shape(op, self)
        except Exception as e:
            rec = self.program._shape_infer_failures
            if len(rec) < SHAPE_INFER_FAILURE_CAP:
                rec.append((op.type, str(e)))

    def __repr__(self):
        lines = ["Block %d (parent %d):" % (self.idx, self.parent_idx)]
        lines += ["  " + repr(v) for v in self.vars.values()]
        lines += ["  " + repr(op) for op in self.ops]
        return "\n".join(lines)


class Program(object):
    """The model: a list of Blocks, block 0 global; a startup program
    holds the init ops, a main program the train step."""

    _uid_counter = [0]

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self._version = 0
        Program._uid_counter[0] += 1
        self._uid = Program._uid_counter[0]  # the Executor's cache identity
        self._seed = None
        self._shape_infer_failures = []

    def _bump_version(self):
        self._version += 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    @property
    def random_seed(self):
        """Seed of the Executor's ``torch.Generator`` for this program's
        random ops (None -> 0)."""
        return self._seed

    @random_seed.setter
    def random_seed(self, s):
        self._seed = s

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def clone(self) -> "Program":
        """A deep copy under a fresh uid (``paddle_tpu/core/ir.py:440``;
        ``for_test`` is not ported yet)."""
        p = copy.deepcopy(self)
        Program._uid_counter[0] += 1
        p._uid = Program._uid_counter[0]
        return p

    def to_string(self, throw_on_error=False):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = to_string
    __repr__ = to_string


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    old_main, old_start = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_start

