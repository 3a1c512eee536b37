"""Program IR (counterpart of ``paddle_tpu/core/ir.py``).

A ``Program`` is a list of ``Block``s; a ``Block`` holds named
``Variable``s and a sequence of ``Operator``s. The port's Executor
interprets a block op by op over ``torch.Tensor``s, so the IR here is
the JAX package's as it is, minus the sharding and mesh annotations; a
``Variable``'s operator sugar (``a + b``, ``1.0 - a``, ``a <= b``)
appends ops through ``layers/math_op_patch.py``. A Program carries a
process-unique ``_uid`` (a clone gets a fresh one) and a ``_version``
that every appended or inserted op bumps: the Executor keys its compiled
steps on both, so a mutated program never replays a stale step.

``Program.clone(for_test=True)`` flips ``is_test`` on the ops that
behave differently in inference (``batch_norm`` here: its running
statistics instead of the batch's), and ``Program.prune(feeds,
fetches)`` keeps only the ops the fetches depend on, on such a clone:
the test program of ``Trainer.test`` and the program of an inference
model (``io.save_inference_model``).
"""
from __future__ import annotations

import contextlib
import copy
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

from . import unique_name
from .types import VarType, convert_dtype

__all__ = ["GRAD_SUFFIX", "Block", "Operator", "Parameter", "Program",
           "Variable", "default_main_program", "default_startup_program",
           "grad_var_name", "program_guard", "sub_block_read_names",
           "switch_main_program"]

GRAD_SUFFIX = "@GRAD"

# per-program cap on recorded shape-inference failures
SHAPE_INFER_FAILURE_CAP = 64


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def sub_block_read_names(op: "Operator", program: "Program") -> set:
    """Every name the sub-blocks of a control-flow op read, recursively
    and cycle-safe: keeping the op keeps its body's producers. A
    sub-block is an attr holding a Block of ``program``, or an int under
    ``sub_block`` / ``block``."""

    def subs(o):
        for key, a in o.attrs.items():
            if isinstance(a, Block) and a.program is program:
                yield a
            elif isinstance(a, int) and not isinstance(a, bool) \
                    and key in ("sub_block", "block") \
                    and 0 <= a < len(program.blocks):
                yield program.blocks[a]

    names, seen = set(), set()
    stack = list(subs(op))
    while stack:
        blk = stack.pop()
        if blk.idx in seen:
            continue
        seen.add(blk.idx)
        for sop in blk.ops:
            names.update(n for n in sop.input_arg_names if n)
            stack.extend(subs(sop))
    return names


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

    def numel(self):
        """Elements of the declared shape (-1 counts as 1); None while
        the shape is unknown."""
        if self.shape is None:
            return None
        n = 1
        for d in self.shape:
            n *= max(d, 1) if d != -1 else 1
        return n

    # operator sugar (``layers/math_op_patch.py``): each appends an op
    def _binary(self, other, op, reverse=False):
        from ..layers import math_op_patch
        return math_op_patch.binary(self, other, op, reverse=reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __lt__(self, other):
        return self._binary(other, "less_than")

    def __le__(self, other):
        return self._binary(other, "less_equal")

    def __gt__(self, other):
        return self._binary(other, "greater_than")

    def __ge__(self, other):
        return self._binary(other, "greater_equal")


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
            existing = self.vars[name]
            self._check_var_redefinition(existing, kwargs)
            return existing
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def _check_var_redefinition(self, existing, kwargs):
        """``create_var`` on an existing name returns the existing var; a
        request with another fixed shape or dtype warns and is recorded
        for the PT012 rule (``paddle_tpu/core/ir.py:245``)."""
        conflicts = []
        shape = kwargs.get("shape")
        if shape is not None and existing.shape is not None:
            req, cur = tuple(shape), tuple(existing.shape)
            # -1 is the batch wildcard: only fixed dims can conflict
            if len(req) != len(cur) or any(
                    a != b for a, b in zip(cur, req) if a != -1 and b != -1):
                conflicts.append(("shape", cur, req))
        dtype = kwargs.get("dtype")
        if dtype is not None and existing.type == VarType.LOD_TENSOR \
                and kwargs.get("type", VarType.LOD_TENSOR) \
                == VarType.LOD_TENSOR:
            req_dt = convert_dtype(dtype)
            if req_dt != existing.dtype:
                conflicts.append(("dtype", existing.dtype, req_dt))
        if not conflicts:
            return
        rec = getattr(self.program, "_var_def_conflicts", None)
        if rec is None:
            rec = self.program._var_def_conflicts = []
        for field, cur, req in conflicts:
            if len(rec) < SHAPE_INFER_FAILURE_CAP:
                rec.append((self.idx, existing.name, field, cur, req))
            warnings.warn(
                "create_var(%r) requested %s %s but an existing var with "
                "%s %s was returned" % (existing.name, field, req, field,
                                        cur), RuntimeWarning)

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
        recorded on the program (bounded, the rest counted in
        ``_shape_infer_dropped``; the PT013 rule reports both), never
        raised; ``FLAGS.debug_shapes`` or ``PADDLE_TPU_DEBUG_SHAPES``
        also warns at the failing op."""
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
            else:
                self.program._shape_infer_dropped = getattr(
                    self.program, "_shape_infer_dropped", 0) + 1
            from ..flags import FLAGS
            if os.environ.get("PADDLE_TPU_DEBUG_SHAPES") or \
                    FLAGS.debug_shapes:
                warnings.warn("shape inference failed for %s: %s"
                              % (op, e), RuntimeWarning)

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

    def create_block(self, parent_idx=None) -> Block:
        """A new block under ``parent_idx`` (default the current block),
        made current; a control-flow op names it in a ``sub_block``
        attr."""
        parent = self._current_block_idx if parent_idx is None \
            else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self._current_block_idx = blk.idx
        return blk

    def rollback(self):
        self._current_block_idx = self.current_block().parent_idx

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

    def clone(self, for_test=False) -> "Program":
        """A deep copy under a fresh uid. ``for_test=True`` sets
        ``is_test`` on every op of ``_TEST_SENSITIVE_OPS`` (inference
        mode)."""
        p = copy.deepcopy(self)
        Program._uid_counter[0] += 1
        p._uid = Program._uid_counter[0]
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if "is_test" in _TEST_SENSITIVE_OPS.get(op.type, ()):
                        op.attrs["is_test"] = True
        return p

    def prune(self, feeds: Sequence[str], fetches: Sequence[str]) \
            -> "Program":
        """A test clone holding only the global block's ops that the
        ``fetches`` depend on, walking back from the last op: an op is
        kept when it writes a needed name, and then its inputs (and its
        sub-blocks' reads) are needed too. Every variable is kept.
        ``feeds`` is the JAX package's argument and cuts nothing there
        either."""
        p = self.clone(for_test=True)
        blk = p.global_block()
        needed, kept = set(fetches), []
        for op in reversed(blk.ops):
            if set(op.output_arg_names) & needed:
                kept.append(op)
                needed |= set(op.input_arg_names)
                needed |= sub_block_read_names(op, p)
        blk.ops = list(reversed(kept))
        return p

    def to_string(self, throw_on_error=False):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = to_string
    __repr__ = to_string


# op type -> the attrs clone(for_test=True) sets; of these the port
# registers batch_norm only
_TEST_SENSITIVE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
    "lrn": ("is_test",),
    "nce": ("is_test",),
}

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program):
    """Make ``program`` the default main program; returns the old one."""
    global _main_program
    old = _main_program
    _main_program = program
    return old


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

