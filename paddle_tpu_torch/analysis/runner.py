"""Verifier pass runner (counterpart of ``paddle_tpu/analysis/runner.py``):
one walk over a Program's blocks and ops, dispatching to registered
rules.

The walk visits ops in execution order, descending into control-flow
sub-blocks at the op that owns them and carrying the set of names
defined so far along the path (the scoping the Executor's flat
environment implements), so dataflow rules see what a run would.
Whole-program rules (shape re-propagation, sharding annotations, dead
ops) run once at the end over facts the same walk collected.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Set

from ..core import ir
from .diagnostics import Diagnostic, ProgramVerifyError, Severity

__all__ = ["Rule", "register_rule", "registered_rules", "resolve_rules",
           "verify", "verify_or_raise", "check_after_pass", "ProgramFacts",
           "STRUCTURAL_CODES"]


def op_sub_blocks(op: ir.Operator, program: ir.Program):
    """(attr key, Block or None, raw attr) for every sub-block attr of
    ``op``. An invalid index resolves to None (PT010 reports it); the
    conventions are ``ir.sub_block_read_names``'s."""
    out = []
    for key, a in op.attrs.items():
        if isinstance(a, ir.Block):
            blk = a if a.program is op.block.program else None
            out.append((key, blk, a))
        elif isinstance(a, int) and not isinstance(a, bool) \
                and key in ("sub_block", "block"):
            blk = program.blocks[a] if 0 <= a < len(program.blocks) else None
            out.append((key, blk, a))
    return out


class ProgramFacts(object):
    """Per-program facts computed once and handed to every rule."""

    def __init__(self, program: ir.Program):
        self.program = program
        # per block idx: name -> first producing op index in that block
        self.first_writer: Dict[int, Dict[str, int]] = {}
        self.produced_anywhere: Set[str] = set()
        self.referenced: Set[str] = set()
        self.persistable: Set[str] = {
            v.name for v in program.list_vars() if v.persistable}
        for blk in program.blocks:
            fw = self.first_writer.setdefault(blk.idx, {})
            for i, op in enumerate(blk.ops):
                for n in op.input_arg_names:
                    if n:
                        self.referenced.add(n)
                for n in op.output_arg_names:
                    if not n:
                        continue
                    self.referenced.add(n)
                    self.produced_anywhere.add(n)
                    fw.setdefault(n, i)

    def scope_var(self, block: ir.Block, name: str) -> Optional[ir.Variable]:
        return block._find_var_recursive(name)


class WalkState(object):
    """What a per-op rule sees at each step of the walk."""

    __slots__ = ("block", "op", "op_idx", "defined", "depth")

    def __init__(self, block, op, op_idx, defined, depth):
        self.block = block
        self.op = op
        self.op_idx = op_idx
        self.defined = defined  # names produced before this op on this path
        self.depth = depth      # 0 = global block, >0 = inside sub-blocks


class Rule(object):
    """Base class: a subclass sets ``code`` / ``name`` and overrides the
    hooks; ``emit`` appends to the sink :func:`verify` installs."""

    code: str = ""
    name: str = ""
    severity: str = Severity.ERROR

    def begin(self, program: ir.Program, facts: ProgramFacts, sink):
        self.program = program
        self.facts = facts
        self._sink = sink

    def emit(self, message, block_idx=None, op_idx=None, var=None,
             hint=None, severity=None, code=None):
        self._sink(Diagnostic(code or self.code, severity or self.severity,
                              message, block_idx=block_idx, op_idx=op_idx,
                              var=var, hint=hint))

    def visit_op(self, walk: WalkState):
        pass

    def finish(self):
        pass


_RULE_CLASSES: List[type] = []


def register_rule(cls):
    _RULE_CLASSES.append(cls)
    return cls


def registered_rules() -> List[type]:
    return list(_RULE_CLASSES)


def resolve_rules(rules=None) -> List[Rule]:
    """None -> every registered rule; otherwise a mix of PT codes, rule
    names, Rule classes or instances."""
    if rules is None:
        return [cls() for cls in _RULE_CLASSES]
    classes: List[type] = []

    def add(cls):
        if cls not in classes:
            classes.append(cls)

    out: List[Rule] = []
    for r in rules:
        if isinstance(r, Rule):
            out.append(r)
        elif inspect.isclass(r) and issubclass(r, Rule):
            add(r)
        elif isinstance(r, str):
            hits = [cls for cls in _RULE_CLASSES
                    if r == cls.name or r in getattr(cls, "emits",
                                                     (cls.code,))]
            if not hits:
                raise ValueError("unknown rule %r (known: %s)" % (
                    r, ", ".join("%s/%s" % (c.code, c.name)
                                 for c in _RULE_CLASSES)))
            for cls in hits:
                add(cls)
        else:
            raise TypeError("can't resolve rule from %r" % (r,))
    return out + [cls() for cls in classes]


# rule codes cheap enough (no deepcopy, one linear walk) to run after
# every program-to-program transform
STRUCTURAL_CODES = ("PT001", "PT002", "PT003", "PT010", "PT011")


def _walk_block(block, defined, depth, rules, program, visited):
    if block.idx in visited:
        return
    visited.add(block.idx)
    for i, op in enumerate(block.ops):
        walk = WalkState(block, op, i, defined, depth)
        for r in rules:
            r.visit_op(walk)
        for _key, sub, _raw in op_sub_blocks(op, program):
            if sub is not None:
                # the sub-block runs inside this op: it sees every name
                # defined so far on this path, its locals do not leak up
                _walk_block(sub, set(defined), depth + 1, rules, program,
                            visited)
        defined.update(n for n in op.output_arg_names if n)


def verify(program: ir.Program, rules=None, strict=False, fetches=None
           ) -> List[Diagnostic]:
    """Run the registered (or selected) rules over ``program`` in one walk.

    ``fetches``: fetch-target names, which turn on the dead-op rule
    (without them every sink op may be a fetch). ``strict=True`` raises
    :class:`ProgramVerifyError` when any ERROR diagnostic is found.
    """
    from . import rules as _builtin  # noqa: F401  (registers built-ins)
    from .. import ops  # noqa: F401  (the lowerings PT003 looks up)
    active = resolve_rules(rules)
    facts = ProgramFacts(program)
    diags: List[Diagnostic] = []
    for r in active:
        r.begin(program, facts, diags.append)
        if fetches is not None and hasattr(r, "set_fetches"):
            r.set_fetches([f.name if isinstance(f, ir.Variable) else f
                           for f in fetches])
    visited: Set[int] = set()
    _walk_block(program.global_block(), set(), 0, active, program, visited)
    # blocks unreachable from block 0 (a sub-block whose owner op a
    # transform deleted) are walked too, seeded with everything their
    # parent chain produces, so only breakage local to them reports
    for blk in program.blocks:
        if blk.idx in visited:
            continue
        defined: Set[str] = set()
        seen_parents: Set[int] = {blk.idx}
        parent = blk.parent_block
        while parent is not None and parent.idx not in seen_parents:
            seen_parents.add(parent.idx)
            for op in parent.ops:
                defined.update(n for n in op.output_arg_names if n)
            parent = parent.parent_block
        _walk_block(blk, defined, 1, active, program, visited)
    for r in active:
        r.finish()
    if strict:
        errors = [d for d in diags if d.is_error]
        if errors:
            raise ProgramVerifyError(diags)
    return diags


def verify_or_raise(program: ir.Program, rules=None, fetches=None,
                    context=None) -> List[Diagnostic]:
    """``verify(strict=True)`` with a context tag in the raised error."""
    diags = verify(program, rules=rules, fetches=fetches)
    if any(d.is_error for d in diags):
        raise ProgramVerifyError(diags, context=context)
    return diags


def check_after_pass(program: ir.Program, pass_name: str,
                     extra_rules=()) -> List[Diagnostic]:
    """Post-transform self-check: the cheap structural rules only
    (linear, no deepcopy), raising if the pass broke the dataflow.
    ``core.backward.append_backward`` calls it with ``extra_rules``
    ("PT007": the orphan-gradient check belongs where gradients are
    made)."""
    return verify_or_raise(
        program, rules=list(STRUCTURAL_CODES) + list(extra_rules),
        context="after pass %r" % pass_name)
