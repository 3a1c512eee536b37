"""Executor: runs a Program block op by op over ``torch.Tensor``s
(counterpart of the eager path of ``paddle_tpu/core/executor.py``).

The JAX Executor traces the whole block into one jitted XLA computation
and keeps an eager per-op path (``_run_eager``) for debugging. PyTorch
runs eagerly, so the port's Executor is that per-op interpreter: feeds
and the scope's persistables seed an environment (name -> tensor),
every op's registered lowering reads its inputs from it and writes its
outputs into it (``trace_ops``), persistables are written back to the
scope, and the fetches are returned. The run is under
``torch.no_grad()``: gradients are ops of the Program (``append_backward``),
and only the generic grad op turns autograd on, around the one forward
op it replays.

A ragged (LoD) feed becomes a :class:`LoDValue`: the data tensor, its
offset tensors on the device and its per-level maximum sequence
lengths as host ints, counted once at feed time, so that no lowering
reads an offset back to the host. Lowerings take ``raw_data`` of their
inputs and wrap a sequence-preserving output with ``with_lod_of``;
fetching a LoD value gives back a host ``LoDTensor``.

Not ported yet (later slices): the jit, hybrid, explicit-comm and
distributed paths, ``repeat``, async fetches, the NaN/Inf scan, the
memory and sharding preflights and the verifier hook.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import ir, registry, types
from .lod import LoDTensor
from .scope import global_scope

__all__ = ["RNG_VAR", "Executor", "FunctionalContext", "LoDValue",
           "LowerContext", "raw_data", "to_lod_value", "trace_ops",
           "with_lod_of"]

RNG_VAR = "@RNG_KEY@"


class LoDValue(object):
    """A ragged value on the device (counterpart of ``TracedLoD``,
    ``paddle_tpu/core/executor.py:40``): ``data`` holds the sequences
    concatenated along dim 0, ``lod`` one int64 offset tensor per level
    on the same device, and ``max_lens`` each level's longest sequence
    as a host int, which is what lets the recurrent ops pad the batch to
    ``[num_seqs, max_len, ...]`` without a copy back to the host."""

    __slots__ = ("data", "lod", "max_lens")

    def __init__(self, data, lod=(), max_lens=None):
        self.data = data
        self.lod = tuple(lod)
        self.max_lens = (tuple(max_lens) if max_lens is not None
                         else (None,) * len(self.lod))

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def __repr__(self):
        return "LoDValue(shape=%s, levels=%d, max_lens=%s)" % (
            tuple(self.data.shape), len(self.lod), self.max_lens)


def raw_data(v):
    """The data tensor of a LoD value; any other value as it is."""
    return v.data if isinstance(v, LoDValue) else v


def with_lod_of(v, data):
    """``data`` with the LoD of ``v`` (a sequence-preserving op's
    output); plain ``data`` when ``v`` carries none."""
    if isinstance(v, LoDValue) and v.lod:
        return LoDValue(data, v.lod, max_lens=v.max_lens)
    return data


def to_lod_value(t, device):
    """A host ``LoDTensor`` -> a :class:`LoDValue` on ``device`` (a plain
    tensor when it has no LoD). The offsets become int64, the index
    type of torch, once here; ``max_lens`` is counted from the host
    offsets (``paddle_tpu/core/executor.py:383-395``)."""
    data = torch.as_tensor(np.asarray(t.numpy()), device=device)
    host_lod = t.lod()
    if not host_lod:
        return data
    lod = tuple(torch.as_tensor(np.asarray(l, dtype=np.int64),
                                device=device) for l in host_lod)
    max_lens = tuple(int(max((b - a for a, b in zip(l, l[1:])), default=0))
                     for l in host_lod)
    return LoDValue(data, lod, max_lens=max_lens)


class LowerContext(object):
    """What an op lowering sees: its input tensors, attrs, an output
    setter, the device and the program's random generator."""

    __slots__ = ("op", "env", "generator", "block", "device")

    def __init__(self, op: ir.Operator, env: Dict[str, Any], generator,
                 block: ir.Block, device):
        self.op = op
        self.env = env
        self.generator = generator
        self.block = block
        self.device = device

    # inputs -----------------------------------------------------------------
    def input(self, slot, idx=0):
        names = self.op.input(slot)
        if len(names) <= idx:
            return None
        return self._lookup(names[idx])

    def inputs(self, slot):
        return [self._lookup(n) for n in self.op.input(slot)]

    def has_input(self, slot):
        return bool(self.op.input(slot))

    def _lookup(self, name):
        if name in self.env:
            return self.env[name]
        raise KeyError(
            "Op %s reads %r which has no runtime value. Did you run the "
            "startup program / feed this variable?" % (self.op, name))

    # outputs ----------------------------------------------------------------
    def set_output(self, slot, value, idx=0):
        names = self.op.output(slot)
        if len(names) <= idx:
            return  # optional output not wired
        self.env[names[idx]] = value

    # misc -------------------------------------------------------------------
    def attr(self, name, default=None):
        return self.op.attr(name, default)

    def next_generator(self):
        if self.generator is None:
            raise RuntimeError(
                "Op %s requires randomness in a context without a "
                "generator (e.g. inside a generic grad replay). Register "
                "a custom grad." % self.op.type)
        return self.generator


def trace_ops(block: ir.Block, env: Dict[str, Any], generator, device):
    """Run every op's lowering over ``env``, in program order."""
    for op in block.ops:
        opdef = registry.lookup_checked(op.type)
        try:
            opdef.lower(LowerContext(op, env, generator, block, device))
        except Exception as e:
            e.add_note("while lowering op %r (inputs=%s -> outputs=%s)"
                       % (op.type, op.input_arg_names,
                          op.output_arg_names))
            raise


class FunctionalContext(LowerContext):
    """LowerContext over explicit value lists: the generic grad op
    replays a forward lowering through it as a pure function."""

    def __init__(self, op, in_values: Dict[str, List[Any]],
                 attrs: Dict[str, Any], device, outputs=None, type=None):
        fake = ir.Operator.__new__(ir.Operator)
        fake.block = op.block
        fake.type = type or op.type
        fake.inputs = {s: ["#%s#%d" % (s, i) for i in range(len(v))]
                       for s, v in in_values.items()}
        fake.outputs = dict(outputs if outputs is not None else op.outputs)
        fake.attrs = attrs
        env = {}
        for s, vals in in_values.items():
            for i, v in enumerate(vals):
                env["#%s#%d" % (s, i)] = v
        super(FunctionalContext, self).__init__(fake, env, None, op.block,
                                                device)
        self.collected: Dict[str, List[Any]] = {}

    def set_output(self, slot, value, idx=0):
        lst = self.collected.setdefault(slot, [])
        while len(lst) <= idx:
            lst.append(None)
        lst[idx] = value


def _to_device_value(v, device):
    """A fed value (numpy array, python scalar or list, tensor,
    ``LoDTensor``, ``LoDValue``) -> a tensor or LoD value on
    ``device``."""
    if isinstance(v, LoDTensor):
        return to_lod_value(v, device)
    if isinstance(v, LoDValue):
        return LoDValue(v.data.to(device), [l.to(device) for l in v.lod],
                        max_lens=v.max_lens)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    if a.dtype == types.bfloat16 and a.dtype.itemsize == 2:
        # numpy has no bfloat16 of its own: through its bits
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def _to_numpy(t):
    """A tensor as a host numpy array; bfloat16 (which ``Tensor.numpy``
    refuses) as an ``ml_dtypes.bfloat16`` array, bit for bit."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16 and types.bfloat16.itemsize == 2:
        return t.view(torch.int16).numpy().view(types.bfloat16)
    return t.numpy()


def _fetch_to_host(v):
    """A fetched value as numpy, or as a host ``LoDTensor`` when it
    carries LoD (``paddle_tpu/core/executor.py:566``)."""
    if isinstance(v, LoDValue):
        return LoDTensor(_to_numpy(v.data),
                         [l.cpu().tolist() for l in v.lod])
    return _to_numpy(v)


class Executor(object):
    """Runs programs on one device: ``device`` is ``"cuda"`` (default,
    raises without a card) or ``"cpu"``, where every kernel wrapper takes
    its plain PyTorch version."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        # eager_runs: run() calls; ops_run: lowerings executed;
        # fetch_sync_count: fetches copied to the host; tune_*: the
        # process-level kernel-dispatch counters of paddle_tpu_torch.tune
        # (hits = a cached winner applied, misses = a flag-enabled
        # kernel's default config, fallbacks = the stock lowering), which
        # move once per dispatching op a run; refreshed after every run()
        self.stats = {"eager_runs": 0, "ops_run": 0, "fetch_sync_count": 0,
                      "tune_hits": 0, "tune_misses": 0, "tune_fallbacks": 0}

    def prepare_feed(self, feed):
        """Move a feed dict to the device once; the result can be passed
        to run() repeatedly without another copy."""
        return {k: _to_device_value(v, self.device) for k, v in feed.items()}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program``'s global block. ``feed``: {name: array or
        tensor, or ``LoDTensor`` for a ragged var}; ``fetch_list``:
        Variables or names. Returns the fetches as numpy arrays (a
        ``LoDTensor`` for a LoD value), or as they are on the device
        with ``return_numpy=False``."""
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, ir.Variable) else f
                       for f in (fetch_list or [])]
        env = self.prepare_feed(feed or {})
        with torch.no_grad():
            outs = self._run_eager(program, env, fetch_names, scope)
        self.stats["eager_runs"] += 1
        from .. import tune
        self.stats.update(tune.counters())
        if return_numpy:
            outs = [_fetch_to_host(o) for o in outs]
            self.stats["fetch_sync_count"] += len(outs)
        return outs

    def _run_eager(self, program, env, fetch_names, scope):
        block = program.global_block()
        persist = self._persistable_names(program)
        for n in self._state_inputs(block, persist, scope, env):
            env[n] = scope.find_var(n)
        generator = self._generator(program, scope)
        trace_ops(block, env, generator, self.device)
        self.stats["ops_run"] += len(block.ops)
        for n, v in env.items():
            if n in persist:
                scope.set_var(n, v)
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch %s: no op of the program produced it "
                           "and it was not fed" % missing)
        return [env[n] for n in fetch_names]

    @staticmethod
    def _persistable_names(program):
        return {v.name for v in program.list_vars() if v.persistable}

    @staticmethod
    def _state_inputs(block, persist, scope, feed):
        refd = set()
        for op in block.ops:
            refd.update(op.input_arg_names)
            refd.update(op.output_arg_names)
        return [n for n in sorted(refd)
                if n not in feed and n in persist
                and scope.find_var(n) is not None]

    def _generator(self, program, scope):
        """The scope's generator, made on first use from the program's
        ``random_seed`` (None -> 0): initialization is a pure function of
        the seed."""
        g = scope.find_var(RNG_VAR)
        if g is None:
            seed = program.random_seed if program.random_seed is not None \
                else 0
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            scope.set_var(RNG_VAR, g)
        return g

