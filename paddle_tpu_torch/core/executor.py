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

Not ported yet (later slices): the jit, hybrid, explicit-comm and
distributed paths, ``repeat``, async fetches, the NaN/Inf scan, the
memory and sharding preflights and the verifier hook.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import ir, registry
from .scope import global_scope

__all__ = ["RNG_VAR", "Executor", "FunctionalContext", "LowerContext",
           "trace_ops"]

RNG_VAR = "@RNG_KEY@"


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
    """A fed value (numpy array, python scalar or list, tensor) -> a
    tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


class Executor(object):
    """Runs programs on one device: ``device`` is ``"cuda"`` (default,
    raises without a card) or ``"cpu"``, where every kernel wrapper takes
    its plain PyTorch version."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        # eager_runs: run() calls; ops_run: lowerings executed;
        # fetch_sync_count: fetches copied to the host
        self.stats = {"eager_runs": 0, "ops_run": 0, "fetch_sync_count": 0}

    def prepare_feed(self, feed):
        """Move a feed dict to the device once; the result can be passed
        to run() repeatedly without another copy."""
        return {k: _to_device_value(v, self.device) for k, v in feed.items()}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        """Run ``program``'s global block. ``feed``: {name: array or
        tensor}; ``fetch_list``: Variables or names. Returns the fetches
        as numpy arrays, or as tensors on the device with
        ``return_numpy=False``."""
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, ir.Variable) else f
                       for f in (fetch_list or [])]
        env = self.prepare_feed(feed or {})
        with torch.no_grad():
            outs = self._run_eager(program, env, fetch_names, scope)
        self.stats["eager_runs"] += 1
        if return_numpy:
            outs = [o.detach().cpu().numpy() for o in outs]
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

