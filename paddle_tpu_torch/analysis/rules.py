"""Built-in verifier rules, the PTxxx code table (counterpart of
``paddle_tpu/analysis/rules.py``: the same rules PT001-PT017, codes,
severities and messages, so that both packages report a defect alike,
word for word).

Each rule is small and selectable on its own: ``verify(p,
rules=["PT006"])`` runs the write-after-write check alone. Severities
follow one principle: ERROR means the program cannot mean what was
written (a run would crash or read garbage); WARNING means it is
suspicious but runs.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core import ir, registry
from ..core.types import is_floating
from .diagnostics import Severity
from .runner import Rule, op_sub_blocks, register_rule

__all__ = ["mark_pipeline_stages"]

GRAD_SUFFIX = ir.GRAD_SUFFIX


@register_rule
class UndefinedVarRule(Rule):
    """PT001 undefined input / PT002 use-before-def.

    Honors the block parent chain and control-flow sub-block attrs: a name
    counts as defined if any op earlier on the walk path produced it, if it
    is persistable (parameters / optimizer state come from the scope), or
    if it is a feed-style var (declared but produced by no op anywhere —
    the executor binds those from the feed dict or leaves them to fail
    with its own readable KeyError)."""

    code = "PT001"
    name = "undefined-var"
    emits = ("PT001", "PT002")

    def visit_op(self, walk):
        facts = self.facts
        fw = facts.first_writer.get(walk.block.idx, {})
        for n in walk.op.input_arg_names:
            if not n or n in walk.defined:
                continue
            v = facts.scope_var(walk.block, n)
            if v is not None and v.persistable:
                continue
            first_local = fw.get(n)
            if first_local is not None and first_local >= walk.op_idx:
                self.emit(
                    "op %r reads %r which is first produced later in the "
                    "same block (op %d)" % (walk.op.type, n, first_local),
                    block_idx=walk.block.idx, op_idx=walk.op_idx, var=n,
                    hint="reorder the ops or wire the producer before this "
                         "use", code="PT002")
            elif v is None and n not in facts.produced_anywhere:
                self.emit(
                    "op %r reads %r which is declared in no enclosing "
                    "block and produced by no op" % (walk.op.type, n),
                    block_idx=walk.block.idx, op_idx=walk.op_idx, var=n,
                    hint="create the variable (block.create_var / "
                         "layers.data) or fix the slot name",
                    code="PT001")


@register_rule
class UnregisteredOpRule(Rule):
    """PT003: op type absent from core.registry — the trace would die in
    lookup_checked mid-compile; report it up front with the op located."""

    code = "PT003"
    name = "unregistered-op"
    emits = ("PT003",)

    def visit_op(self, walk):
        if registry.lookup(walk.op.type) is None:
            self.emit("op type %r has no registered lowering"
                      % walk.op.type,
                      block_idx=walk.block.idx, op_idx=walk.op_idx,
                      hint="register it with core.registry.register_op or "
                           "fix the type name")


@register_rule
class WriteAfterWriteRule(Rule):
    """PT006: a var is written twice with no read in between, and neither
    write goes through a ``stateful_outputs`` slot (in-place contract like
    increment's Out or the optimizer ParamOut slots). The first write is a
    dead store at best and a lost update at worst."""

    code = "PT006"
    name = "write-after-write"
    severity = Severity.WARNING
    emits = ("PT006",)

    def begin(self, program, facts, sink):
        super(WriteAfterWriteRule, self).begin(program, facts, sink)
        # block idx -> name -> (op_idx, was_stateful_slot)
        self._writers: Dict[int, Dict[str, Tuple[int, bool]]] = {}

    def _retire(self, block, names, include_self=True):
        """The executor env is flat: a read (or a sub-block write) of a
        name consumes pending writes in EVERY enclosing block, not just
        the one the op sits in."""
        seen = set()
        blk = block if include_self else block.parent_block
        while blk is not None and blk.idx not in seen:
            seen.add(blk.idx)
            writers = self._writers.get(blk.idx)
            if writers:
                for n in names:
                    writers.pop(n, None)
            blk = blk.parent_block

    def visit_op(self, walk):
        writers = self._writers.setdefault(walk.block.idx, {})
        reads = set(n for n in walk.op.input_arg_names if n)
        self._retire(walk.block, reads)
        if walk.depth > 0:
            # a sub-block write to a parent-pending name counts as a use
            # of the parent's store (loop-carried update), but must not
            # hide double writes WITHIN the sub-block itself
            self._retire(walk.block,
                         set(n for n in walk.op.output_arg_names if n),
                         include_self=False)
        opdef = registry.lookup(walk.op.type)
        stateful = set(opdef.stateful_outputs) if opdef is not None else set()
        for slot, names in walk.op.outputs.items():
            for n in names:
                if not n or n in self.facts.persistable:
                    continue
                prev = writers.get(n)
                is_stateful = slot in stateful
                if prev is not None and not prev[1] and not is_stateful \
                        and n not in reads:
                    self.emit(
                        "%r written by op %d is overwritten by op %d (%s) "
                        "without ever being read" % (n, prev[0],
                                                     walk.op_idx,
                                                     walk.op.type),
                        block_idx=walk.block.idx, op_idx=walk.op_idx,
                        var=n,
                        hint="drop the dead store, or mark the output "
                             "slot stateful_outputs if this is an "
                             "in-place update")
                writers[n] = (walk.op_idx, is_stateful)


@register_rule
class SubBlockRule(Rule):
    """PT010: control-flow structure — sub-block attrs must point at a real
    block of this program (not the op's own block), and the block parent
    chain must be acyclic and in range."""

    code = "PT010"
    name = "invalid-sub-block"
    emits = ("PT010",)

    def visit_op(self, walk):
        nblocks = len(self.program.blocks)
        for key, sub, raw in op_sub_blocks(walk.op, self.program):
            if sub is None:
                what = ("index %r out of range [0, %d)" % (raw, nblocks)
                        if isinstance(raw, int)
                        else "Block of a different Program")
                self.emit("op %r attr %r: sub-block %s"
                          % (walk.op.type, key, what),
                          block_idx=walk.block.idx, op_idx=walk.op_idx,
                          hint="point the attr at a block created by "
                               "program.create_block()")
            elif sub.idx == walk.block.idx:
                self.emit("op %r attr %r: sub-block is the op's own block "
                          "%d (self-recursion)" % (walk.op.type, key,
                                                   sub.idx),
                          block_idx=walk.block.idx, op_idx=walk.op_idx)

    def finish(self):
        nblocks = len(self.program.blocks)
        for blk in self.program.blocks:
            seen = set()
            idx = blk.idx
            while idx >= 0:
                if idx >= nblocks:
                    self.emit("block %d has out-of-range parent %d"
                              % (blk.idx, idx), block_idx=blk.idx)
                    break
                if idx in seen:
                    self.emit("block parent chain starting at block %d "
                              "cycles through block %d"
                              % (blk.idx, idx), block_idx=blk.idx,
                              hint="parent_idx must strictly descend "
                                   "toward block 0")
                    break
                seen.add(idx)
                idx = self.program.blocks[idx].parent_idx


@register_rule
class ShapePropagationRule(Rule):
    """PT004 shape-infer failure / PT005 shape conflict.

    Re-runs every op's registered infer_shape over a scratch deepcopy of
    the program in build order (sub-blocks before the op that owns them,
    matching how append_op interleaved them), reporting exceptions instead
    of swallowing them the way Block._infer_shape must at build time —
    and then diffs the re-propagated shapes/dtypes against the program's
    declared ones, so a transform that invalidated a shape annotation is
    caught before a lowering fails on it with an unrelated-looking
    error. A program that does not deep-copy reports one INFO line
    instead."""

    code = "PT004"
    name = "shape-propagation"
    emits = ("PT004", "PT005")

    def finish(self):
        try:
            scratch = copy.deepcopy(self.program)
        except Exception as e:  # non-copyable attr (e.g. a live handle)
            self.emit("program not deep-copyable (%s); shape "
                      "re-propagation skipped" % e,
                      severity=Severity.INFO)
            return
        visited: Set[int] = set()

        def run_block(blk):
            if blk.idx in visited:
                return
            visited.add(blk.idx)
            for i, op in enumerate(blk.ops):
                for _k, sub, _raw in op_sub_blocks(op, scratch):
                    if sub is not None:
                        run_block(sub)
                opdef = registry.lookup(op.type)
                if opdef is None or opdef.infer_shape is None:
                    continue
                try:
                    opdef.infer_shape(op, blk)
                except Exception as e:
                    self.emit("shape inference for op %r failed: %s"
                              % (op.type, e),
                              block_idx=blk.idx, op_idx=i, code="PT004",
                              hint="fix the input shapes/attrs; run with "
                                   "PADDLE_TPU_DEBUG_SHAPES=1 to catch "
                                   "this at build time")

        run_block(scratch.global_block())
        for blk in scratch.blocks:
            if blk.idx not in visited:
                run_block(blk)
        for orig_blk, new_blk in zip(self.program.blocks, scratch.blocks):
            for name, orig_v in orig_blk.vars.items():
                new_v = new_blk.vars.get(name)
                if new_v is None:
                    continue
                if (orig_v.shape is not None and new_v.shape is not None
                        and tuple(orig_v.shape) != tuple(new_v.shape)):
                    self.emit(
                        "declared shape %s of %r conflicts with "
                        "re-propagated shape %s"
                        % (tuple(orig_v.shape), name, tuple(new_v.shape)),
                        block_idx=orig_blk.idx, var=name, code="PT005",
                        severity=Severity.WARNING,
                        hint="a pass or manual edit stale-d this shape; "
                             "re-run shape inference or fix the producer")


@register_rule
class OrphanGradRule(Rule):
    """PT007: a ``@GRAD`` var whose forward partner does not exist anywhere
    in the var scope chain — backward transforms create grads next to their
    forward var, so an orphan means a rename/prune half-applied."""

    code = "PT007"
    name = "orphan-grad"
    severity = Severity.WARNING
    emits = ("PT007",)

    def finish(self):
        for blk in self.program.blocks:
            for name in blk.vars:
                if GRAD_SUFFIX not in name:
                    continue
                base = name.split(GRAD_SUFFIX)[0]
                if not base:
                    continue
                if blk._find_var_recursive(base) is None \
                        and base not in self.facts.produced_anywhere:
                    self.emit(
                        "gradient var %r has no forward partner %r"
                        % (name, base),
                        block_idx=blk.idx, var=name,
                        hint="the forward var was renamed or pruned "
                             "without its gradient")


@register_rule
class DeadVarRule(Rule):
    """PT008: a var declared in a block but referenced by no op anywhere —
    dead weight from an abandoned edit or a half-removed op."""

    code = "PT008"
    name = "dead-var"
    severity = Severity.WARNING
    emits = ("PT008",)

    def finish(self):
        for blk in self.program.blocks:
            for name, v in blk.vars.items():
                if name in self.facts.referenced or v.persistable \
                        or isinstance(v, ir.Parameter):
                    continue
                self.emit("var %r is referenced by no op" % name,
                          block_idx=blk.idx, var=name,
                          hint="delete it, or wire it to the op that was "
                               "meant to consume it")


@register_rule
class UnusedParameterRule(Rule):
    """PT009: a Parameter no op reads or writes in this program. Its
    tensor still sits in the scope and in every captured step's state —
    wasted device memory."""

    code = "PT009"
    name = "unused-parameter"
    severity = Severity.WARNING
    emits = ("PT009",)

    def finish(self):
        for blk in self.program.blocks:
            for name, v in blk.vars.items():
                if isinstance(v, ir.Parameter) \
                        and name not in self.facts.referenced:
                    self.emit("parameter %r is used by no op" % name,
                              block_idx=blk.idx, var=name,
                              hint="remove the layer that created it or "
                                   "connect it to the graph")


@register_rule
class ShardingRule(Rule):
    """PT011: ``program._shardings`` consistency — every annotated name
    must exist, and the PartitionSpec rank must not exceed the var rank
    (GSPMD would reject it with a mesh-axis error). The port runs on one
    device and writes no ``_shardings``; the rule is inert unless a
    caller sets them."""

    code = "PT011"
    name = "sharding-mismatch"
    emits = ("PT011",)

    def finish(self):
        shardings = getattr(self.program, "_shardings", None) or {}
        declared = {}
        for blk in self.program.blocks:
            declared.update(blk.vars)
        for name, spec in shardings.items():
            v = declared.get(name)
            if v is None:
                self.emit("sharding annotates %r which exists in no block"
                          % name, var=name,
                          hint="drop the stale annotation or fix the name")
                continue
            try:
                spec_rank = len([p for p in tuple(spec)])
            except TypeError:
                continue  # opaque spec object; nothing to check
            if v.shape is not None and spec_rank > len(v.shape):
                self.emit(
                    "sharding spec %s (rank %d) exceeds rank %d of %r"
                    % (tuple(spec), spec_rank, len(v.shape), name),
                    var=name,
                    hint="a PartitionSpec may name at most one mesh axis "
                         "per tensor dimension")


@register_rule
class CreateVarConflictRule(Rule):
    """PT012: surfaces the shape/dtype conflicts Block.create_var recorded
    when a second create_var hit an existing name with different metadata
    (the silent-return trap)."""

    code = "PT012"
    name = "create-var-conflict"
    severity = Severity.WARNING
    emits = ("PT012",)

    def finish(self):
        for (blk_idx, name, field, old, new) in getattr(
                self.program, "_var_def_conflicts", ()):
            self.emit(
                "create_var(%r) requested %s %s but the existing var has "
                "%s; the existing var was returned unchanged"
                % (name, field, new, old),
                block_idx=blk_idx, var=name,
                hint="rename one of the two, or make the declarations "
                     "agree")


@register_rule
class RecordedShapeFailureRule(Rule):
    """PT013: surfaces the bounded Program._shape_infer_failures record —
    build-time inference failures that used to pile up in a list nobody
    read."""

    code = "PT013"
    name = "recorded-shape-failure"
    severity = Severity.WARNING
    emits = ("PT013",)

    def finish(self):
        for (op_type, msg) in getattr(self.program,
                                      "_shape_infer_failures", ()):
            self.emit("shape inference failed while building op %r: %s"
                      % (op_type, msg),
                      hint="run with PADDLE_TPU_DEBUG_SHAPES=1 to raise "
                           "at the failing append_op")
        dropped = getattr(self.program, "_shape_infer_dropped", 0)
        if dropped:
            self.emit("%d additional shape-inference failures were "
                      "recorded and dropped (bounded at %d)"
                      % (dropped, ir.SHAPE_INFER_FAILURE_CAP))


@register_rule
class DeadOpRule(Rule):
    """PT014: ops not reverse-reachable from the fetch targets (plus
    persistable writes and host/side-effect ops). Active only when
    verify() is given ``fetches`` — without them every sink op is a
    potential fetch and reachability is vacuous. Reuses Program.prune's
    sub-block-reads logic so keeping a control-flow op keeps its body's
    upstream producers."""

    code = "PT014"
    name = "dead-op"
    severity = Severity.WARNING
    emits = ("PT014",)

    def __init__(self):
        self._fetches: Optional[List[str]] = None

    def set_fetches(self, fetches):
        self._fetches = list(fetches)

    def finish(self):
        if not self._fetches:
            return
        blk = self.program.global_block()
        needed = set(self._fetches)
        persist = self.facts.persistable
        dead: List[int] = []
        for i in range(len(blk.ops) - 1, -1, -1):
            op = blk.ops[i]
            opdef = registry.lookup(op.type)
            host = opdef is not None and registry.op_is_host(opdef, op)
            outs = set(n for n in op.output_arg_names if n)
            keep = bool(outs & needed) or bool(outs & persist) \
                or host or not outs
            if keep:
                needed.update(n for n in op.input_arg_names if n)
                needed |= ir.sub_block_read_names(op, self.program)
            else:
                dead.append(i)
        for i in reversed(dead):
            op = blk.ops[i]
            self.emit("op %r (outputs %s) is unreachable from the fetch "
                      "targets %s" % (op.type, op.output_arg_names,
                                      self._fetches),
                      block_idx=blk.idx, op_idx=i,
                      hint="prune it (Program.prune) or fetch what it "
                           "computes")


# ---------------------------------------------------------------------------
# dataflow rules (PT015-PT017): dtype flow, LoD levels, pipeline stages


def _canonical_float(dtype):
    """Declared dtype -> canonical float name, or None for non-floats /
    unknown. float64 folds into float32, as in the JAX package (whose x64
    is off), so that both report the same boundaries."""
    if dtype is None:
        return None
    try:
        if not is_floating(dtype):
            return None
        name = str(np.dtype(dtype))
    except Exception:
        return None
    return {"float64": "float32", "float16": "float16"}.get(name, name)


@register_rule
class DtypeFlowRule(Rule):
    """PT015: mixed float widths meet at one op with no ``cast`` between
    — e.g. an fp32 var consumed where bf16 is produced. torch, like jnp,
    promotes silently (bf16 + fp32 -> fp32), so nothing crashes: the
    bf16 savings quietly evaporate, or an intended-fp32 accumulation
    quietly runs reduced. The message is the JAX package's word for
    word. The AMP path is exempt by construction (its lowerings cast
    and declared dtypes stay fp32); ``cast`` itself,
    grad replay ops and the optimizer update ops (whose slots hold
    master-precision state beside compute-precision grads by design)
    are exempt by type."""

    code = "PT015"
    name = "dtype-flow"
    severity = Severity.WARNING
    emits = ("PT015",)

    EXEMPT_TYPES = frozenset(("cast", "generic_grad", "feed", "fetch",
                              "print", "cond", "while"))

    def _exempt(self, op):
        if op.type in self.EXEMPT_TYPES or op.type.endswith("_grad"):
            return True
        opdef = registry.lookup(op.type)
        # optimizer updates: ParamOut-stateful ops legitimately mix a
        # master-precision param with a compute-precision grad
        return opdef is not None and "ParamOut" in opdef.stateful_outputs

    def visit_op(self, walk):
        if self._exempt(walk.op):
            return
        by_float: Dict[str, str] = {}
        for n in walk.op.input_arg_names:
            if not n:
                continue
            v = self.facts.scope_var(walk.block, n)
            f = _canonical_float(getattr(v, "dtype", None)) if v else None
            if f:
                by_float.setdefault(f, n)
        if len(by_float) > 1:
            pairs = ", ".join("%s=%r" % (f, n)
                              for f, n in sorted(by_float.items()))
            self.emit(
                "op %r mixes float widths with no cast between (%s): "
                "jnp promotes silently, so either the reduced-precision "
                "input's savings are lost or an fp32 path quietly runs "
                "narrow" % (walk.op.type, pairs),
                block_idx=walk.block.idx, op_idx=walk.op_idx,
                var=sorted(by_float.values())[0],
                hint="insert a cast op (layers.cast) at the boundary, "
                     "or mark the program AMP so amp.cast_inputs owns "
                     "the cast")


@register_rule
class LoDFlowRule(Rule):
    """PT016: LoD-level consistency across sequence ops. The sequence
    lowerings (ops/sequence_ops.py) call ``seq_offsets`` on specific
    input slots and raise mid-trace when the var carries no LoD; the
    declared ``lod_level`` makes that checkable statically. A pooled
    output (lod_level 0) fed back into a sequence op — the classic
    chain break — lands here at lint time instead of as a trace error."""

    code = "PT016"
    name = "lod-flow"
    emits = ("PT016",)

    # op type -> (input slot that must carry LoD, minimum lod_level) —
    # exactly the slots whose lowering calls seq_offsets on the slot
    LOD_REQUIRED = {
        "sequence_pool": ("X", 1), "sequence_softmax": ("X", 1),
        "sequence_concat": ("X", 1), "sequence_reshape": ("X", 1),
        "sequence_conv": ("X", 1), "sequence_slice": ("X", 1),
        "sequence_erase": ("X", 1), "sequence_reverse": ("X", 1),
        "sequence_expand": ("Y", 1), "row_conv": ("X", 1),
        "lstm": ("Input", 1), "lstmp": ("Input", 1), "gru": ("Input", 1),
        "warpctc": ("Logits", 1),
    }

    def visit_op(self, walk):
        req = self.LOD_REQUIRED.get(walk.op.type)
        if req is None:
            return
        slot, min_level = req
        for n in walk.op.inputs.get(slot, ()):
            if not n:
                continue
            v = self.facts.scope_var(walk.block, n)
            if v is None:
                continue  # PT001's finding, not ours
            level = getattr(v, "lod_level", 0) or 0
            if level < min_level:
                self.emit(
                    "op %r slot %r consumes %r with declared "
                    "lod_level=%d, but the lowering needs a sequence "
                    "(lod_level>=%d) — the trace would die in "
                    "seq_offsets" % (walk.op.type, slot, n, level,
                                     min_level),
                    block_idx=walk.block.idx, op_idx=walk.op_idx, var=n,
                    hint="feed a LoDTensor (layers.data(lod_level=1)) "
                         "or keep lod_level annotations flowing through "
                         "the producing layer")


def mark_pipeline_stages(program, stages):
    """Annotate ``program`` with a pipeline stage split over its global
    block: ``stages`` is a list of ``(start, end)`` half-open op-index
    ranges in stage order (``parallel.pipeline``'s per-stage op
    segments). The PT017 rule verifies the split on the next
    ``verify``; without the annotation the rule is inert."""
    program._pipeline_stages = [(int(a), int(b)) for a, b in stages]
    return program


@register_rule
class PipelineStageRule(Rule):
    """PT017: ``parallel.pipeline`` stage-split verification. Active
    only when the program carries a ``_pipeline_stages`` annotation
    (:func:`mark_pipeline_stages`). The split must partition the global
    block's ops, and every stage's consumed vars must be produced by
    the same/an earlier stage or fed — a var produced in a LATER stage
    (a cross-stage back-edge) cannot flow through the one-directional
    activation channel the pipeline schedule compiles to. A skip over
    non-adjacent stages is legal dataflow but cannot ride the
    stage-to-stage ppermute handoff, so it warns."""

    code = "PT017"
    name = "pipeline-stage-split"
    emits = ("PT017",)

    def finish(self):
        stages = getattr(self.program, "_pipeline_stages", None)
        if not stages:
            return
        blk = self.program.global_block()
        n_ops = len(blk.ops)
        covered = [None] * n_ops  # op idx -> stage idx
        prev_end = 0
        for si, (a, b) in enumerate(stages):
            if not (0 <= a <= b <= n_ops):
                self.emit("stage %d range (%d, %d) is outside the "
                          "global block's %d ops" % (si, a, b, n_ops),
                          block_idx=0)
                return
            if a != prev_end:
                self.emit("stage split has a %s at op %d (stage %d "
                          "starts at %d)"
                          % ("gap" if a > prev_end else "overlap",
                             prev_end, si, a), block_idx=0,
                          hint="stages must partition the block's ops "
                               "contiguously, in order")
                return
            for i in range(a, b):
                covered[i] = si
            prev_end = b
        if prev_end != n_ops:
            self.emit("stage split covers ops [0, %d) but the block has "
                      "%d — trailing ops belong to no stage"
                      % (prev_end, n_ops), block_idx=0)
            return
        producer_stage: Dict[str, int] = {}
        fw = self.facts.first_writer.get(0, {})
        for name, op_idx in fw.items():
            producer_stage[name] = covered[op_idx]
        for i, op in enumerate(blk.ops):
            si = covered[i]
            for n in op.input_arg_names:
                if not n:
                    continue
                ps = producer_stage.get(n)
                if ps is None:
                    continue  # fed / persistable / produced nowhere
                if ps > si:
                    self.emit(
                        "stage %d op %r consumes %r which is first "
                        "produced in LATER stage %d — a cross-stage "
                        "back-edge the pipeline's forward-only "
                        "activation channel cannot carry"
                        % (si, op.type, n, ps),
                        block_idx=0, op_idx=i, var=n,
                        hint="move the producer into an earlier stage "
                             "or redraw the stage boundaries")
                elif ps < si - 1:
                    self.emit(
                        "stage %d op %r consumes %r from non-adjacent "
                        "stage %d: legal dataflow, but the value must "
                        "be re-materialised or carried through every "
                        "intermediate stage's activation payload"
                        % (si, op.type, n, ps),
                        block_idx=0, op_idx=i, var=n,
                        severity=Severity.WARNING)
