"""Static memory planner, PT030-PT034 (counterpart of
``paddle_tpu/analysis/memory.py``: the same walk, classes, summary and
codes).

One walk over the Program IR (op order, descending into control-flow
sub-blocks, each var's last use) gives a byte-resolved residency
timeline:

- **params and optimizer slots**: persistable, live the whole step (the
  in-place ``ParamOut`` update writes the same var, counted once);
- **activations kept for backward**: live from their forward producer
  to their last consumer, for a training program the grad op that reads
  them;
- **gradients**: non-persistable ``@GRAD`` vars, freed as the optimizer
  updates consume them;
- **feeds**: fed tensors, live from the step's start to their last use.

From the timeline: the predicted peak, the high-water op and the
tensors resident there. The JAX package's XLA frees a buffer after its
last use inside the jitted step; the port's Executor does the same by
the schedule :func:`release_schedule` derives from this walk, so the
plan prices what the Executor holds. The per-op kernel scratch is
priced beside it (:func:`_vmem_scratch`).

Checks:

- **PT030** (error): the predicted peak exceeds the budget; names the
  high-water op and the top 5 residents there.
- **PT031** (warning): a large feed dead after its consuming op and
  shape / dtype compatible with one of its outputs, which is not
  donated.
- **PT032** (warning): a persistable that nothing reads (write-only
  state, resident for nothing).
- **PT033** (warning): vars of unknown size (shape inference failed, no
  batch): the peak is then a lower bound, and says so.
- **PT034** (error): the serving KV pool plus the weights against the
  budget (:func:`check_kv_pool`).

Entry points: ``python -m paddle_tpu_torch lint --memory``, and the
Executor's preflight under ``FLAGS.verify`` / ``PADDLE_TPU_VERIFY``,
which raises one :class:`ProgramVerifyError` with the residency table
before a step's first run. The budget is :func:`resolve_budget_bytes`'s:
an explicit value, ``FLAGS.memory_budget_gb``, then the card's memory
(``torch.cuda.mem_get_info``); on the CPU none is known.

Limits, the JAX package's: the estimate is static. It ignores the
temporaries inside a lowering (the generic grad's replay), the
allocator's rounding and fragmentation, and a capture's pool, so it is
a lower bound on what the step needs, not a promise that it fits;
:func:`measure_live_bytes` gives the measured side. ``specs`` /
``mesh_shape`` (sharded residency) need ``parallel.spec_layout`` and
raise until the port has it (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core import ir, registry
from .diagnostics import Diagnostic, ProgramVerifyError, Severity
from .runner import op_sub_blocks

__all__ = ["MemoryPlan", "plan_memory", "check_memory", "check_kv_pool",
           "verify_memory_or_raise", "resolve_budget_bytes",
           "measure_live_bytes", "compute_liveness", "flatten_ops",
           "release_schedule", "MEMORY_CODES", "kv_pool_bytes", "card",
           "fmt_bytes"]

MEMORY_CODES = ("PT030", "PT031", "PT032", "PT033", "PT034")

# below this, a missed feed donation is noise (PT031 stays quiet on toy
# configs)
DONATION_MIN_BYTES = 1 << 20

GRAD_SUFFIX = ir.GRAD_SUFFIX

def _dtype_bytes(dtype):
    try:
        return int(np.dtype(getattr(dtype, "name", dtype) or
                            "float32").itemsize)
    except TypeError:
        return 4


def fmt_bytes(n):
    """Human byte count, the one formatter of every memory surface
    (residency tables, PT030 / PT034 messages, the serve verb)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return ("%.2f %s" % (n, unit)) if unit != "B" \
                else ("%d B" % int(n))
        n /= 1024.0


def flatten_ops(program: ir.Program) -> List[Tuple[ir.Block, int,
                                                   ir.Operator]]:
    """Ops in execution order: each block's ops in sequence, descending
    into control-flow sub-blocks at the op that owns them (the walk
    order of ``runner.verify``, flattened so that every op gets one slot
    of the timeline). Cycle-safe on corrupt sub-block graphs."""
    out: List[Tuple[ir.Block, int, ir.Operator]] = []
    visited: Set[int] = set()

    def walk(block):
        if block.idx in visited:
            return
        visited.add(block.idx)
        for i, op in enumerate(block.ops):
            out.append((block, i, op))
            for _key, sub, _raw in op_sub_blocks(op, program):
                if sub is not None:
                    walk(sub)
    walk(program.global_block())
    return out


def compute_liveness(uses: Sequence[Set[str]], defs: Sequence[Set[str]]
                     ) -> Tuple[List[Set[str]], List[Set[str]]]:
    """Classic backward dataflow over a linear op list: ``(live_in,
    live_out)`` per op."""
    n = len(uses)
    live_in: List[Set[str]] = [set() for _ in range(n)]
    live_out: List[Set[str]] = [set() for _ in range(n)]
    changed = True
    while changed:
        changed = False
        for i in range(n - 1, -1, -1):
            out = set(live_in[i + 1]) if i + 1 < n else set()
            new_in = uses[i] | (out - defs[i])
            if new_in != live_in[i] or out != live_out[i]:
                live_in[i] = new_in
                live_out[i] = out
                changed = True
    return live_in, live_out


def _use_walk(ops):
    """The last-use walk over ``[(block, op_idx, op)]``: (name -> first
    producer's slot, name -> last slot that reads or writes it, name ->
    the block that first names it, the names any op reads)."""
    produced: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    ref_block: Dict[str, ir.Block] = {}
    read_anywhere: Set[str] = set()
    for idx, (block, _opi, op) in enumerate(ops):
        for name in op.input_arg_names:
            if name:
                last_use[name] = idx
                read_anywhere.add(name)
                ref_block.setdefault(name, block)
        for name in op.output_arg_names:
            if name:
                produced.setdefault(name, idx)
                last_use[name] = idx  # a written var lives at least here
                ref_block.setdefault(name, block)
    return produced, last_use, ref_block, read_anywhere


def release_schedule(block, ops, keep) -> List[Tuple[str, ...]]:
    """For each op of ``ops`` (ops of ``block``, in run order), the names
    whose last reader or writer it is: the values the Executor drops
    after the op's lowering, as XLA frees a buffer after its last use.
    Only names an op of ``ops`` produces are ever dropped (a feed or a
    state tensor is the caller's), and never one in ``keep`` (fetches,
    persistables, what a later segment reads)."""
    produced, last_use, _, _ = _use_walk([(block, i, op)
                                          for i, op in enumerate(ops)])
    out: List[List[str]] = [[] for _ in ops]
    for name in produced:
        if name not in keep:
            out[last_use[name]].append(name)
    return [tuple(sorted(names)) for names in out]


class _VarRec(object):
    """One tensor's residency: byte size, class, live interval."""

    __slots__ = ("name", "nbytes", "cls", "start", "end", "exact",
                 "block_idx")

    def __init__(self, name, nbytes, cls, start, end, exact, block_idx):
        self.name = name
        self.nbytes = int(nbytes)
        self.cls = cls
        self.start = int(start)
        self.end = int(end)
        self.exact = bool(exact)
        self.block_idx = block_idx


class MemoryPlan(object):
    """Residency timeline and what follows from it for one (program,
    batch, dp).

    ``peak_bytes`` / ``peak_index`` / ``peak_op``: the high-water mark;
    ``class_bytes``: totals by class (params / optimizer_state /
    gradients / activations / feeds); ``unknown``: vars whose size could
    not be resolved (the peak is then a lower bound and ``exact`` is
    False); ``vmem_scratch``: the worst kernel scratch of the plan's
    tunable ops, (kernel, bytes): on the card the shared memory one
    thread block of the kernel's default tiling takes (the JAX package
    prices TPU VMEM there; the name is kept), or None."""

    def __init__(self, program, records, n_ops, batch, dp, unknown,
                 peak_bytes, peak_index, peak_op, vmem_scratch=None,
                 flat_ops=None, produced=None, read_anywhere=None):
        self.program = program
        self.records: Dict[str, _VarRec] = records
        self.n_ops = n_ops
        self.batch = batch
        self.dp = dp
        self.unknown: List[str] = unknown
        self.peak_bytes = int(peak_bytes)
        self.peak_index = peak_index
        self.peak_op = peak_op  # (block_idx, op_idx, op_type) or None
        self.vmem_scratch = vmem_scratch
        # the walk's own maps, so that check_memory never walks again
        self._flat_ops = flat_ops if flat_ops is not None \
            else flatten_ops(program)
        self._produced: Dict[str, int] = produced or {}
        self._read_anywhere: Set[str] = read_anywhere or set()

    @property
    def exact(self):
        return not self.unknown

    @property
    def class_bytes(self) -> Dict[str, int]:
        out = {"params": 0, "optimizer_state": 0, "gradients": 0,
               "activations": 0, "feeds": 0}
        for r in self.records.values():
            out[r.cls] = out.get(r.cls, 0) + r.nbytes
        return out

    def residents_at(self, index, k=None):
        """Tensors live at timeline slot ``index``, largest first."""
        live = [r for r in self.records.values()
                if r.start <= index <= r.end]
        live.sort(key=lambda r: (-r.nbytes, r.name))
        return live[:k] if k is not None else live

    def top_residents(self, k=5):
        if self.peak_index is None:
            return []
        return self.residents_at(self.peak_index, k)

    def peak_op_ref(self) -> str:
        if self.peak_op is None:
            return "<empty program>"
        blk, opi, optype = self.peak_op
        return "block%d:op%d (%s)" % (blk, opi, optype)

    def summary(self) -> Dict:
        """JSON-able digest of the plan."""
        cb = self.class_bytes
        return {
            "batch_per_device": self.batch,
            "dp": self.dp,
            "param_bytes": cb["params"],
            "optimizer_state_bytes": cb["optimizer_state"],
            "gradient_bytes": cb["gradients"],
            "activation_bytes": cb["activations"],
            "feed_bytes": cb["feeds"],
            "peak_bytes": self.peak_bytes,
            "peak_op": self.peak_op_ref(),
            "exact": self.exact,
            "unknown_vars": len(self.unknown),
            "vmem_scratch_bytes": (self.vmem_scratch[1]
                                   if self.vmem_scratch else 0),
        }

    def table(self, budget_bytes=None) -> str:
        """The residency report (the one the preflight's
        ProgramVerifyError embeds)."""
        cb = self.class_bytes
        lines = ["predicted per-device HBM residency (batch=%s, dp=%d):"
                 % (self.batch if self.batch is not None else "?",
                    self.dp)]
        for label, key in (("params", "params"),
                           ("optimizer state", "optimizer_state"),
                           ("gradients", "gradients"),
                           ("activations", "activations"),
                           ("feeds", "feeds")):
            lines.append("  %-16s %12s" % (label, fmt_bytes(cb[key])))
        peak = "  %-16s %12s at %s" % ("peak", fmt_bytes(self.peak_bytes),
                                       self.peak_op_ref())
        if budget_bytes:
            peak += "  [budget %s]" % fmt_bytes(budget_bytes)
        lines.append(peak)
        for r in self.top_residents(5):
            lines.append("    resident at peak: %-28s %12s  (%s)"
                         % (r.name, fmt_bytes(r.nbytes), r.cls))
        if self.vmem_scratch:
            lines.append("  kernel shared memory a block (worst op %s): %s"
                         % (self.vmem_scratch[0],
                            fmt_bytes(self.vmem_scratch[1])))
        if self.unknown:
            lines.append("  %d unknown-size var(s) (%s%s) — peak is a "
                         "LOWER BOUND"
                         % (len(self.unknown),
                            ", ".join(self.unknown[:4]),
                            ", ..." if len(self.unknown) > 4 else ""))
        return "\n".join(lines)


def _var_nbytes(v, batch):
    """(nbytes, exact) of a declared Variable; ``exact`` is False when a
    dim is unresolved (no shape, or -1 with no batch), which prices as
    1: a bounded lower estimate."""
    shape = getattr(v, "shape", None)
    if shape is None:
        return 0, False
    n, exact = 1, True
    for d in shape:
        d = int(d) if d is not None else -1
        if d == -1:
            if batch is not None:
                n *= max(int(batch), 1)
            else:
                exact = False
        elif d <= 0:
            exact = False
        else:
            n *= d
    return n * _dtype_bytes(getattr(v, "dtype", "float32")), exact


def _vmem_scratch(program, batch):
    """The worst kernel scratch of the program's tunable populations:
    the shared memory one thread block of the kernel's default tiling
    takes, by the model the autotuner prunes candidates with
    (``smem_bytes`` of the matmul and conv3x3 spaces). A population
    whose space the port lacks (flash attention) is not priced; with
    none priced, None. Best effort: a failure prices as None and never
    kills the plan."""
    try:
        from ..cli import _tune_populations
        from ..tune import get_space
        worst = None
        for kernel, key in _tune_populations(program, batch or 1)[0]:
            space = get_space(kernel)
            nb = int(space.smem_bytes(space.default_config(key), key))
            if worst is None or nb > worst[1]:
                worst = (kernel, nb)
        return worst
    except Exception:
        return None


def plan_memory(program: ir.Program, batch=None, fetches=None, dp=1,
                sizes_override=None, vmem=True, specs=None,
                mesh_shape=None) -> MemoryPlan:
    """Build the residency timeline of ``program``.

    ``batch`` stands for the feed wildcard dim (-1); ``dp`` prices the
    per-device shard of the batch of a data-parallel mesh (params
    replicate, batch-dim tensors divide). ``fetches`` live to the step's
    end. ``sizes_override`` maps a var name to its exact bytes (the
    Executor's preflight passes the real sizes of state and feeds).
    ``specs`` / ``mesh_shape`` raise NotImplementedError."""
    if specs or mesh_shape:
        raise NotImplementedError(
            "plan_memory(specs=, mesh_shape=): sharded residency needs "
            "parallel.spec_layout, which the port does not have yet "
            "(ROADMAP.md Queue 1 item 6, collectives and parallelism)")
    fetches = set(f.name if isinstance(f, ir.Variable) else f
                  for f in (fetches or ()))
    sizes_override = sizes_override or {}
    per_dev_batch = batch
    if batch is not None and dp and dp > 1:
        per_dev_batch = -(-int(batch) // int(dp))
    ops = flatten_ops(program)
    n_ops = len(ops)
    produced, last_use, ref_block, read_anywhere = _use_walk(ops)

    records: Dict[str, _VarRec] = {}
    unknown: List[str] = []
    for name in set(produced) | set(last_use):
        block = ref_block[name]
        v = block._find_var_recursive(name)
        persistable = v is not None and v.persistable
        is_param = isinstance(v, ir.Parameter)
        is_grad = GRAD_SUFFIX in name
        if name in sizes_override:
            nbytes, exact = int(sizes_override[name]), True
        elif v is None:
            nbytes, exact = 0, False
        else:
            nbytes, exact = _var_nbytes(v, per_dev_batch)
        if not exact:
            unknown.append(name)
        if persistable:
            cls = "params" if is_param else "optimizer_state"
            start, end = 0, max(n_ops - 1, 0)
        elif name not in produced:
            cls = "feeds"
            start, end = 0, last_use[name]
        else:
            cls = "gradients" if is_grad else "activations"
            start = produced[name]
            end = last_use[name]
            if name in fetches:
                end = max(n_ops - 1, 0)
        records[name] = _VarRec(name, nbytes, cls, start, end, exact,
                                block.idx)

    # the peak by event deltas over the flat timeline
    deltas = [0] * (n_ops + 1)
    for r in records.values():
        deltas[r.start] += r.nbytes
        if r.end + 1 <= n_ops:
            deltas[r.end + 1] -= r.nbytes
    peak, cur, peak_idx = 0, 0, None
    for i in range(n_ops):
        cur += deltas[i]
        if cur > peak:
            peak, peak_idx = cur, i
    if peak_idx is None and records:
        # an op-less program (vars only): everything resident at once
        peak = sum(r.nbytes for r in records.values())
    peak_op = None
    if peak_idx is not None and ops:
        blk, opi, op = ops[peak_idx]
        peak_op = (blk.idx, opi, op.type)
    unknown.sort()
    return MemoryPlan(program, records, n_ops, per_dev_batch, int(dp or 1),
                      unknown, peak, peak_idx, peak_op,
                      vmem_scratch=_vmem_scratch(program, per_dev_batch)
                      if vmem else None,
                      flat_ops=ops, produced=produced,
                      read_anywhere=read_anywhere)


def _diag(code, message, severity=Severity.ERROR, **kw):
    return Diagnostic(code, severity, message, **kw)


def check_memory(program: ir.Program, budget_bytes=None, batch=None,
                 fetches=None, dp=1, plan=None, sizes_override=None,
                 donation_min_bytes=DONATION_MIN_BYTES, vmem=True,
                 specs=None, mesh_shape=None
                 ) -> Tuple[MemoryPlan, List[Diagnostic]]:
    """The whole static memory pass: build (or reuse) the plan and
    return ``(plan, diagnostics)`` for PT030-PT033. ``vmem=False`` skips
    the kernel-scratch pricing (display only; the preflight drops it)."""
    if plan is None:
        plan = plan_memory(program, batch=batch, fetches=fetches, dp=dp,
                           sizes_override=sizes_override, vmem=vmem,
                           specs=specs, mesh_shape=mesh_shape)
    diags: List[Diagnostic] = []

    # PT033 first: it qualifies the PT030 verdict (a lower bound)
    if plan.unknown:
        diags.append(_diag(
            "PT033", "%d var(s) have unresolved sizes (%s%s): the "
            "predicted peak %s is a LOWER BOUND, not the real number"
            % (len(plan.unknown), ", ".join(plan.unknown[:8]),
               ", ..." if len(plan.unknown) > 8 else "",
               fmt_bytes(plan.peak_bytes)),
            severity=Severity.WARNING,
            hint="declare static shapes (or pass --batch so the feed "
                 "wildcard resolves); PT013 lists the shape-inference "
                 "failures that feed this"))

    if budget_bytes and plan.peak_bytes > budget_bytes:
        top = ", ".join("%s=%s (%s)" % (r.name, fmt_bytes(r.nbytes),
                                        r.cls)
                        for r in plan.top_residents(5))
        blk_idx, op_idx = (plan.peak_op[0], plan.peak_op[1]) \
            if plan.peak_op else (None, None)
        diags.append(_diag(
            "PT030", "predicted peak HBM %s exceeds the budget %s "
            "(overflow %s) — high-water op %s; top residents: %s"
            % (fmt_bytes(plan.peak_bytes), fmt_bytes(budget_bytes),
               fmt_bytes(plan.peak_bytes - budget_bytes),
               plan.peak_op_ref(), top or "<none>"),
            block_idx=blk_idx, op_idx=op_idx,
            hint="shrink the batch, shard the params over more devices "
                 "(--mesh dp=N), or raise --budget-gb if the device "
                 "really has more"))

    # PT031: a large FEED dead after its consuming op, shape / dtype
    # compatible with one of that op's outputs: the step frees its own
    # values at their last use, a feed is the caller's and stays
    ops = plan._flat_ops
    for name, rec in sorted(plan.records.items()):
        if rec.cls != "feeds" or rec.nbytes < donation_min_bytes:
            continue
        if rec.end >= len(ops):
            continue
        block, opi, op = ops[rec.end]
        if name not in op.input_arg_names:
            continue
        opdef = registry.lookup(op.type)
        stateful = set(opdef.stateful_outputs) if opdef is not None \
            else set()
        v = block._find_var_recursive(name)
        for slot, outs in op.outputs.items():
            if slot in stateful:
                continue  # already an in-place contract
            for out_name in outs:
                if not out_name or out_name == name:
                    continue
                ov = block._find_var_recursive(out_name)
                if (v is not None and ov is not None
                        and v.shape is not None and ov.shape is not None
                        and tuple(v.shape) == tuple(ov.shape)
                        and v.dtype == ov.dtype):
                    diags.append(_diag(
                        "PT031", "feed %r (%s) is dead after op %r and "
                        "shape/dtype-compatible with its output %r, but "
                        "feed buffers are not donated — both stay "
                        "resident across the step"
                        % (name, fmt_bytes(rec.nbytes), op.type,
                           out_name),
                        severity=Severity.WARNING, block_idx=block.idx,
                        op_idx=opi, var=name,
                        hint="donate the feed's buffer to the op's "
                             "output (the port donates no feed, as the "
                             "JAX package donates none), or reuse the "
                             "feed dict across steps "
                             "(Executor.prepare_feed)"))
                    break
            else:
                continue
            break

    # PT032: a persistable non-Parameter an op writes and no op reads:
    # its marking keeps it resident, and in the step's state, for nothing
    for name, rec in sorted(plan.records.items()):
        if rec.cls != "optimizer_state":
            continue
        v = None
        for blk in program.blocks:
            if name in blk.vars:
                v = blk.vars[name]
                break
        if v is None or isinstance(v, ir.Parameter):
            continue
        if name in plan._produced and name not in plan._read_anywhere:
            diags.append(_diag(
                "PT032", "persistable %r (%s) is written but read by no "
                "op (backward included): its persistable marking keeps "
                "it resident — and in the step's state — across every "
                "step for nothing" % (name, fmt_bytes(rec.nbytes)),
                severity=Severity.WARNING, var=name,
                hint="drop the persistable marking (let it die at its "
                     "last real use) or delete the producer"))
    return plan, diags


# ---------------------------------------------------------------------------
# PT034: serving KV-pool sizing


def kv_pool_bytes(num_layers, num_heads, head_dim, kv_pages, page_tokens,
                  dtype="float32"):
    """Bytes of the paged KV pool the generation engine preallocates:
    K and V, ``[layers, pages + 1, page_tokens, heads, head_dim]`` each
    (the + 1 is the trash page, ``serving/kvcache.py``)."""
    per = (int(num_layers) * (int(kv_pages) + 1) * int(page_tokens)
           * int(num_heads) * int(head_dim) * _dtype_bytes(dtype))
    return 2 * per


def check_kv_pool(num_layers, num_heads, head_dim, kv_pages, page_tokens,
                  dtype="float32", model_bytes=0, budget_bytes=None):
    """PT034: the preallocated KV pool plus the resident model must fit
    the budget. Returns a list of :class:`Diagnostic` ([] when they fit
    or when no budget is known)."""
    if not budget_bytes:
        return []
    pool = kv_pool_bytes(num_layers, num_heads, head_dim, kv_pages,
                         page_tokens, dtype)
    headroom = int(budget_bytes) - int(model_bytes)
    if pool <= headroom:
        return []
    return [_diag(
        "PT034", "KV page pool needs %s (%d pages x %d tokens x %d layers "
        "x %d heads x %d head_dim, K+V + trash page) but only %s remain "
        "after the %s model on a %s budget"
        % (fmt_bytes(pool), int(kv_pages), int(page_tokens),
           int(num_layers), int(num_heads), int(head_dim),
           fmt_bytes(max(headroom, 0)), fmt_bytes(model_bytes),
           fmt_bytes(budget_bytes)),
        hint="lower --kv_pages / FLAGS.serve_kv_pages or --page_tokens, "
             "serve a smaller model, or raise FLAGS.memory_budget_gb if "
             "the device really has more")]


# ---------------------------------------------------------------------------
# budget and measurement


def card():
    """The card this process serves on (the current CUDA device), or
    None on a process without one."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def resolve_budget_bytes(budget_gb=None, device=None) -> Optional[int]:
    """The budget the checks compare against: an explicit ``budget_gb``
    beats ``FLAGS.memory_budget_gb`` beats the memory of ``device`` (a
    CUDA device's total memory, ``torch.cuda.mem_get_info``; the JAX
    package reads a TPU's ``bytes_limit``). None when no budget is known
    (no device, or a CPU one): PT030 and PT034 then stay silent."""
    if budget_gb:
        return int(float(budget_gb) * (1 << 30))
    from ..flags import FLAGS
    if FLAGS.memory_budget_gb > 0:
        return int(float(FLAGS.memory_budget_gb) * (1 << 30))
    if device is not None:
        import torch
        device = torch.device(device)
        if device.type == "cuda":
            try:
                return int(torch.cuda.mem_get_info(device)[1])
            except Exception:
                return None
    return None


def measure_live_bytes(device=None) -> int:
    """Bytes held by live tensors, the measured side of a plan: on a
    card ``torch.cuda.memory_allocated(device)``; on the CPU the sum of
    the distinct storages behind every live tensor the garbage collector
    tracks (the counterpart of the JAX package's ``jax.live_arrays()``
    sum)."""
    import gc

    import torch
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.memory_allocated(device))
    seen, total = set(), 0
    for obj in gc.get_objects():
        # type(), not isinstance(): a lazy module proxy among the objects
        # warns when its __class__ is read
        if not issubclass(type(obj), torch.Tensor) or \
                obj.device.type != "cpu":
            continue
        try:
            st = obj.untyped_storage()
        except (RuntimeError, NotImplementedError):
            continue
        key = st.data_ptr()
        if key in seen or not key:
            continue
        seen.add(key)
        total += int(st.nbytes())
    return total


def verify_memory_or_raise(program, budget_bytes, batch=None, fetches=None,
                           dp=1, sizes_override=None, context=None,
                           vmem=False, specs=None,
                           mesh_shape=None) -> MemoryPlan:
    """The Executor's preflight: :func:`check_memory`, raising one
    :class:`ProgramVerifyError` with the residency table when the
    predicted peak exceeds the budget, before the step runs. The
    kernel-scratch pricing is off by default: it is a display row."""
    plan, diags = check_memory(program, budget_bytes=budget_bytes,
                               batch=batch, fetches=fetches, dp=dp,
                               sizes_override=sizes_override, vmem=vmem,
                               specs=specs, mesh_shape=mesh_shape)
    errors = [d for d in diags if d.is_error]
    if errors:
        ctx = context or "memory preflight"
        raise ProgramVerifyError(
            errors, context="%s\n%s" % (ctx, plan.table(budget_bytes)))
    return plan
