"""Executor: runs a Program block on one device (counterpart of
``paddle_tpu/core/executor.py``).

The JAX Executor traces a block into one jitted XLA computation per
(program, feed signature) and caches it. The port's counterpart is a
step captured once as a CUDA graph and replayed (``use_jit=True``, the
default):

- The first run of a key runs the step eagerly on the card. It is the
  warm-up: lazy kernel builds, library handles and every first-use host
  call happen there. The key is the JAX's: program uid and version,
  feed signature (a LoD feed's ``max_lens`` too, so a ragged step gets
  one graph per shape), fetch names and the state signature, and the
  scope: each scope gets its own static buffers and graph.
- The second run captures the step as a ``torch.cuda.CUDAGraph`` over
  static buffers and replays it. Later runs copy the feeds in and
  replay; ``repeat=K`` replays K times and returns the last fetches.
- Feeds are copied into static input tensors. The state is the scope's
  own tensors: the step ends by copying every written persistable into
  its tensor (the counterpart of JAX donating the state), and a scope
  entry replaced between runs (``set_var``, ``load_persistables``) is
  copied into its tensor before the next replay. Fetches are cloned out
  of the graph's outputs, which the next replay overwrites.
- A capture that fails (a lowering that reads a value back to the host)
  warns with ``RuntimeWarning`` naming the op, counts an eager run and
  finishes the run eagerly; the program stays on the per-op path.
- An Executor's graphs share one memory pool, so the memory they hold
  is about that of its largest step, not the sum over its keys: each
  replay's fetches are cloned at once and nothing else a graph writes
  in the pool is read after another graph runs. The cache keeps the
  ``graph_cache_limit`` most recently used steps and frees the graph of
  the one it evicts; the pool goes with the last graph in it. A kernel
  wrapper runs only at the capture, so
  the Executor takes the kernels' launch counts' delta over it and adds
  it at every replay (``kernels.add_launches``).

On the CPU the same keys, static buffers and copies in and out run, and
a "replay" calls the step function; ``graph_captures`` and
``graph_replays`` stay 0 there.

A program that holds a host op (``save`` / ``load`` / ``print``) runs on
the hybrid path: its runs of device ops are compiled as above, the host
ops run between them. ``use_jit=False`` and ``check_nan_inf`` (which
scans every op output and raises ``FloatingPointError`` naming the
variable) run the per-op interpreter: feeds and the scope's
persistables seed an environment (name -> tensor), every op's
registered lowering reads its inputs from it and writes its outputs
into it (``trace_ops``), persistables are written back to the scope,
and the fetches are returned. A run is under ``torch.no_grad()``:
gradients are ops of the Program (``append_backward``), and only the
generic grad op turns autograd on, around the one forward op it
replays. ``sync=False`` returns :class:`AsyncFetch` handles.

A ragged (LoD) feed becomes a :class:`LoDValue`: the data tensor, its
offset tensors on the device and its per-level maximum sequence
lengths as host ints, counted once at feed time, so that no lowering
reads an offset back to the host. Lowerings take ``raw_data`` of their
inputs and wrap a sequence-preserving output with ``with_lod_of``;
fetching a LoD value gives back a host ``LoDTensor``.

Every path frees a value after its last use, as XLA frees a buffer
inside the JAX package's jitted step: ``trace_ops`` takes a release
schedule (:func:`analysis.memory.release_schedule`, found once per
program version and fetch list) and drops from the environment, after
each op, the names whose last reader or writer that op is. A fetch, a
persistable and what a later host segment reads are never dropped; a
fed value stays the caller's. In a capture, the private pool then reuses
the dropped blocks within the graph. A lowering that reads a dropped
name raises (``KeyError``); nothing falls back to keeping everything.

Under ``FLAGS.verify`` (or ``PADDLE_TPU_VERIFY=1``) ``run`` verifies a
program once per (uid, version) before any path (ProgramVerifyError on
an error, one RuntimeWarning with the warnings), and runs the memory
preflight before the first run of each (program version, feed
signature, fetches): the memory planner prices state and feeds from
their tensors and the rest from declared shapes, and a predicted peak
above ``FLAGS.memory_budget_gb`` (else the card's memory) raises one
ProgramVerifyError with the residency table before the step allocates
anything; ``stats["mem_predicted_peak_bytes"]`` holds the last
prediction, and the profiler's memory section counts the preflight
beside the live bytes then (``torch.cuda.memory_allocated`` on the
card, the scope's tensors' bytes on the CPU).

While the profiler is on (``paddle_tpu_torch.profiler``), ``run``
records each program run's wall time (the card synchronized first),
``trace_ops`` each op's host span (phase ``trace`` inside a capture),
and a compiled step captured then keeps its graph's nodes, from which
its ``programs`` entry is read after its first replay: the kernel nodes
by symbol, the pool's bytes, the feed shapes and the launches a replay.
A materialized ``AsyncFetch`` counts in the profiler's pipeline section.

Not ported yet (ROADMAP.md Queue 1 item 6, which needs collectives and a
mesh): the explicit-comm and distributed paths and the sharding
preflight.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import logging
import os
import threading
import time
import warnings
import weakref
from typing import Any, Dict, List

import numpy as np
import torch

from .. import profiler as _prof
from ..device import DEFAULT_DEVICE, resolve_device
from . import ir, registry, types
from .lod import LoDTensor
from .scope import global_scope

__all__ = ["CAPTURE_LOCK", "GRAPH_CACHE_LIMIT", "RNG_VAR", "AsyncFetch",
           "ConcreteScalar", "Executor", "FunctionalContext", "LoDValue",
           "LowerContext", "concrete_value", "in_compiled_step", "iter_ops",
           "raw_data", "read_on_host", "to_lod_value", "trace_ops",
           "with_lod_of"]

_LOG = logging.getLogger("paddle_tpu_torch.executor")

RNG_VAR = "@RNG_KEY@"

# compiled steps an Executor keeps, the least recently used evicted and
# its graph freed (the JAX package bounds its per-scope memo at 32,
# executor.py:1131); the graphs share one memory pool, so the bound is on
# graphs and their static buffers, not on a pool each
GRAPH_CACHE_LIMIT = 32


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


class ConcreteScalar(object):
    """A scalar whose value is known on the host, riding beside its
    one-element tensor (counterpart of ``ConcreteScalar``,
    ``paddle_tpu/core/executor.py:69``): the reference's ``force_cpu``
    loop counters. ``fill_constant`` of an integer scalar, ``increment``
    of one, the comparisons of two, ``lod_array_length`` and
    ``max_sequence_len`` keep the host value, so that a While condition,
    an array index and a trip count are known while a step is traced and
    the loop unrolls into the step (a captured graph replays the
    unrolled loop). Every other lowering sees ``data``: ``LowerContext``
    hands it the tensor. A concrete scalar never enters the scope or a
    step's state, where a captured graph would freeze its value."""

    __slots__ = ("value", "data")

    def __init__(self, value, data):
        self.value = value
        self.data = data

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def __repr__(self):
        return "ConcreteScalar(%r)" % (self.value,)


def concrete_value(v):
    """The host value of ``v`` when it is a concrete scalar, else None."""
    return v.value if isinstance(v, ConcreteScalar) else None


def _no_host_value(v):
    """``v``, a concrete scalar as its tensor: what the scope, a step's
    state and a fetch hold."""
    return v.data if isinstance(v, ConcreteScalar) else v


def raw_data(v):
    """The data tensor of a LoD value or a concrete scalar; any other
    value as it is."""
    return v.data if isinstance(v, (LoDValue, ConcreteScalar)) else v


def read_on_host(v):
    """The values of tensor ``v`` as a host numpy array, for a lowering
    that decides on them on the host (a While condition computed from
    fed data, an array index that is no counter). In a compiled step it
    raises ``_Fallback``: a capture cannot read the card, and the step's
    warm-up sees the read, so the program runs on the per-op path from
    its first run, as the JAX package's trace falls back from its
    first."""
    if in_compiled_step():
        raise _Fallback("a lowering reads a device value on the host "
                        "(data-dependent control flow)")
    return _to_numpy(raw_data(v))


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

    __slots__ = ("op", "env", "generator", "block", "device", "value_hook")

    def __init__(self, op: ir.Operator, env: Dict[str, Any], generator,
                 block: ir.Block, device, value_hook=None):
        self.op = op
        self.env = env
        self.generator = generator
        self.block = block
        self.device = device
        self.value_hook = value_hook

    # inputs -----------------------------------------------------------------
    def input(self, slot, idx=0):
        """The value of input ``slot`` [``idx``]; a concrete scalar as its
        tensor (:meth:`concrete_input` keeps it)."""
        return _no_host_value(self.concrete_input(slot, idx))

    def concrete_input(self, slot, idx=0):
        """The value as the environment holds it, a concrete scalar too."""
        names = self.op.input(slot)
        if len(names) <= idx:
            return None
        return self._lookup(names[idx])

    def inputs(self, slot):
        return [_no_host_value(self._lookup(n)) for n in self.op.input(slot)]

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
        if self.value_hook is not None:
            value = self.value_hook(names[idx], value)
        self.env[names[idx]] = value

    def set_outputs(self, slot, values):
        for i, v in enumerate(values):
            self.set_output(slot, v, idx=i)

    def output_names(self, slot):
        return self.op.output(slot)

    # misc -------------------------------------------------------------------
    def attr(self, name, default=None):
        return self.op.attr(name, default)

    def sub_block(self, attr_name="sub_block"):
        """The block a control-flow op runs (``sub_block`` holds its index
        or the block)."""
        blk = self.attr(attr_name)
        if isinstance(blk, int):
            blk = self.block.program.blocks[blk]
        return blk

    def next_generator(self):
        if self.generator is None:
            raise RuntimeError(
                "Op %s requires randomness in a context without a "
                "generator (e.g. inside a generic grad replay). Register "
                "a custom grad." % self.op.type)
        return self.generator


def trace_ops(block: ir.Block, env: Dict[str, Any], generator, device,
              value_hook=None, release=None):
    """Run every op's lowering over ``env``, in program order.
    ``value_hook(name, value)`` sees every value an op sets (the NaN/Inf
    scan). ``release``: one tuple of names for each op of the block, the
    names dropped from ``env`` after that op
    (:func:`analysis.memory.release_schedule`); None keeps every value.
    While profiling is on, each op's host span is recorded
    (``profiler.record_op_event``; on the card a span is the launch, not
    the kernel)."""
    timing = _prof.profiler_enabled()
    for i, op in enumerate(block.ops):
        opdef = registry.lookup_checked(op.type)
        t0 = time.perf_counter() if timing else 0.0
        try:
            opdef.lower(LowerContext(op, env, generator, block, device,
                                     value_hook))
        except Exception as e:
            e.add_note("while lowering op %r (inputs=%s -> outputs=%s)"
                       % (op.type, op.input_arg_names,
                          op.output_arg_names))
            raise
        if timing:
            _prof.record_op_event(op.type, op.output_arg_names[0]
                                  if op.output_arg_names else op.type,
                                  t0, time.perf_counter())
        if release is not None:
            for n in release[i]:
                env.pop(n, None)


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
    v = _no_host_value(v)
    if isinstance(v, LoDValue):
        return LoDTensor(_to_numpy(v.data),
                         [l.cpu().tolist() for l in v.lod])
    return _to_numpy(v)




# -- the compiled path's helpers ----------------------------------------------

def _op_sub_blocks(op):
    """The blocks a control-flow op runs (``paddle_tpu/core/executor.py
    :303``): a Block attr, or an int under ``sub_block`` / ``block``."""
    for key, a in op.attrs.items():
        if isinstance(a, ir.Block):
            yield a
        elif isinstance(a, int) and key in ("sub_block", "block"):
            yield op.block.program.blocks[a]


def iter_ops(block):
    """Every op of ``block`` and, depth first after each op, of the
    blocks it runs (``paddle_tpu/core/executor.py:1822``)."""
    for op in block.ops:
        yield op
        for sub in _op_sub_blocks(op):
            yield from iter_ops(sub)


def _has_sub_blocks(block) -> bool:
    return any(True for op in block.ops for _ in _op_sub_blocks(op))


def _is_host_block(block) -> bool:
    """Whether a block, or a block one of its ops runs, holds an op that
    must run on the host (``paddle_tpu/core/executor.py:351``)."""
    for op in iter_ops(block):
        opdef = registry.lookup(op.type)
        if opdef is not None and registry.op_is_host(opdef, op):
            return True
    return False


class _ProgramFacts(object):
    """What a run needs to know of a program's ops and vars, found once
    per (uid, version): whether it holds a host op, its persistables,
    the names its ops read or write, the names they write, and the
    release schedule of each fetch list."""

    __slots__ = ("host", "persist", "referenced", "written", "block",
                 "sub_blocks", "_releases")

    def __init__(self, program):
        block = program.global_block()
        self.block = block
        self.host = _is_host_block(block)
        self.sub_blocks = _has_sub_blocks(block)
        self.persist = frozenset(v.name for v in program.list_vars()
                                 if v.persistable)
        # the names of the ops of the blocks a control-flow op runs too
        # (paddle_tpu/core/executor.py:359): a parameter read only inside
        # a While body is part of the step's state
        self.written = frozenset(n for op in iter_ops(block)
                                 for n in op.output_arg_names)
        self.referenced = tuple(sorted(self.written | {
            n for op in iter_ops(block) for n in op.input_arg_names}))
        self._releases = {}

    def release(self, fetch_names):
        """The global block's release schedule when ``fetch_names`` are
        fetched: fetches and persistables are kept."""
        key = tuple(fetch_names)
        got = self._releases.get(key)
        if got is None:
            from ..analysis.memory import release_schedule
            if len(self._releases) > 16:
                self._releases.clear()
            got = self._releases[key] = release_schedule(
                self.block, self.block.ops, self.persist | set(key))
        return got


def _value_sig(v):
    if isinstance(v, ConcreteScalar):
        return ("concrete", v.value) + _value_sig(v.data)
    if isinstance(v, LoDValue):
        return (tuple(v.data.shape), str(v.data.dtype),
                tuple(int(l.shape[0]) for l in v.lod), v.max_lens)
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype))
    return (type(v).__name__,)


def _feed_signature(feed):
    """(name, shape, dtype[, offsets per level, max_lens]) of every feed,
    sorted by name (``paddle_tpu/core/executor.py:370``)."""
    return tuple((name,) + _value_sig(feed[name]) for name in sorted(feed))


def _static_like(v):
    """A buffer of its own holding ``v`` (a tensor, a LoD value or a
    concrete scalar, whose host value rides on)."""
    if isinstance(v, ConcreteScalar):
        return ConcreteScalar(v.value, _static_like(v.data))
    if isinstance(v, LoDValue):
        return LoDValue(torch.empty_like(v.data).copy_(v.data),
                        [torch.empty_like(l).copy_(l) for l in v.lod],
                        max_lens=v.max_lens)
    return torch.empty_like(v).copy_(v)


def _copy_in(buf, v):
    if buf is v:
        return
    if isinstance(buf, ConcreteScalar):
        # the host value is part of the step's key
        buf.data.copy_(v.data)
    elif isinstance(buf, LoDValue):
        buf.data.copy_(v.data)
        for b, l in zip(buf.lod, v.lod):
            b.copy_(l)
    else:
        buf.copy_(v)


def _own(v):
    """A fetched value that no later run writes into."""
    if isinstance(v, ConcreteScalar):
        return ConcreteScalar(v.value, v.data.clone())
    if isinstance(v, LoDValue):
        return LoDValue(v.data.clone(), [l.clone() for l in v.lod],
                        max_lens=v.max_lens)
    if isinstance(v, torch.Tensor):
        return v.clone()
    return v


def _storage(t):
    return t.untyped_storage().data_ptr()


def _nbytes(v):
    """Bytes of a tensor's (or a LoD value's data tensor's) elements."""
    data = raw_data(v)
    if isinstance(data, torch.Tensor):
        return data.numel() * data.element_size()
    return 0


def _verify_requested():
    """Whether the static verifier is on: ``PADDLE_TPU_VERIFY`` set to a
    true word, or ``FLAGS.verify`` (``paddle_tpu/core/executor.py:449``)."""
    if os.environ.get("PADDLE_TPU_VERIFY", "").lower() in (
            "1", "true", "yes", "on"):
        return True
    from ..flags import FLAGS
    return bool(FLAGS.verify)


def _nan_inf_hook(name, value):
    """The NaN/Inf scan (``paddle_tpu/core/executor.py:1094``): every
    floating value an op sets must be finite."""
    data = raw_data(value)
    if isinstance(data, torch.Tensor) and data.is_floating_point():
        if not bool(torch.isfinite(data).all()):
            raise FloatingPointError("NaN/Inf detected in %r" % name)
    return value


def _gen_state(gen):
    """The state of a CUDA generator (None for another): compared around
    the warm-up, it says whether the step draws random numbers."""
    if isinstance(gen, torch.Generator) and gen.device.type == "cuda":
        return gen.get_state()
    return None


_CAPTURE_STREAMS = {}

# the depth of compiled steps the calling thread is in (see
# in_compiled_step)
_COMPILED = threading.local()


def in_compiled_step() -> bool:
    """Whether the calling thread runs a compiled step: its warm-up, its
    capture or a replay (on the CPU, the step function). There a
    lowering sees what the JAX package's trace sees, no concrete offset,
    so a sequence op whose input's longest sequence is unknown raises as
    the JAX op does under ``jit``; on the per-op path it may count it
    from the offsets."""
    return getattr(_COMPILED, "depth", 0) > 0


@contextlib.contextmanager
def _compiled_step():
    _COMPILED.depth = getattr(_COMPILED, "depth", 0) + 1
    try:
        yield
    finally:
        _COMPILED.depth -= 1

# held while a step is captured: a capture in the global mode refuses
# every thread's unsafe CUDA calls (a pinned allocation among them), so
# another thread that works on the card (the feed pipeline) takes it
# around its CUDA calls
CAPTURE_LOCK = threading.Lock()

_SCOPE_SERIALS = itertools.count()


def _capture_stream(device):
    s = _CAPTURE_STREAMS.get(device)
    if s is None:
        s = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return s


class _Fallback(Exception):
    """A step that cannot be captured; ``op`` names where it failed."""

    def __init__(self, msg, op=None, error=None):
        super(_Fallback, self).__init__(msg)
        self.op = op
        self.error = error


class _StaleState(Exception):
    """A scope entry now differs from its static tensor in shape or dtype."""


def _failed_op(e):
    """The op note ``trace_ops`` put on ``e`` or on an exception in its
    chain, or None."""
    seen = set()
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        for note in getattr(e, "__notes__", ()) or ():
            if note.startswith("while lowering op"):
                return note
        e = e.__cause__ or e.__context__
    return None


class AsyncFetch(object):
    """Lazy fetch handle (``Executor.run(..., sync=False)``; the JAX
    package's ``AsyncFetch``, ``paddle_tpu/core/executor.py:488``). It
    holds the value on the device and a CUDA event recorded after it:

    - ``value()`` / ``numpy()`` / ``float(h)`` / ``np.asarray(h)`` copy it
      to the host once, at first access, and count one
      ``fetch_sync_count`` on the Executor and in the profiler's
      pipeline counters;
    - ``block()`` waits for the event without a copy;
    - ``ready`` queries the event without waiting.
    """

    __slots__ = ("_value", "_host", "_done", "_return_numpy", "_stats",
                 "_event")

    def __init__(self, value, return_numpy=True, stats=None):
        self._value = value
        self._return_numpy = return_numpy
        self._host = None
        self._done = False
        self._stats = stats
        self._event = None
        data = raw_data(value)
        if isinstance(data, torch.Tensor) and data.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(data.device))

    @property
    def ready(self):
        """True once the device work behind the value has finished."""
        if self._done or self._event is None:
            return True
        return self._event.query()

    def block(self):
        """Wait for the value on the device without copying it."""
        if not self._done and self._event is not None:
            self._event.synchronize()
        return self

    def value(self):
        """The host value (the device value with ``return_numpy=False``),
        materialized once."""
        if not self._done:
            self._host = (_fetch_to_host(self._value) if self._return_numpy
                          else self._value)
            self._done = True
            self._value = self._event = None
            if self._stats is not None:
                self._stats["fetch_sync_count"] += 1
            _prof.update_pipeline_counters(fetch_sync_count=1)
        return self._host

    def numpy(self):
        v = self.value()
        if isinstance(v, (torch.Tensor, LoDValue)):
            v = _fetch_to_host(v)
        return np.asarray(v.numpy() if isinstance(v, LoDTensor) else v)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.numpy().reshape(-1)[0])

    def __repr__(self):
        state = ("materialized" if self._done
                 else "ready" if self.ready else "pending")
        return "AsyncFetch(%s)" % state


class _Step(object):
    """One compiled step: the static feed buffers, the scope's tensors it
    updates in place, and on the card the graph, its outputs and the
    kernel launches of one replay."""

    __slots__ = ("runs", "ready", "draws", "graph", "pool", "feed_bufs",
                 "state_names", "state_bufs", "outs", "extra", "delta",
                 "kept", "prof")

    def __init__(self):
        self.runs = 0
        self.ready = False
        self.draws = False
        self.graph = None
        self.pool = None
        self.feed_bufs = {}
        self.state_names = ()
        self.state_bufs = ()
        self.outs = ()
        self.extra = {}
        self.delta = {}
        # the graph kept its nodes (captured while profiling was on), and
        # the profiler's programs entry recorded from it
        self.kept = False
        self.prof = None

    def free(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.ready = False
        self.feed_bufs, self.state_bufs, self.outs, self.extra = \
            {}, (), (), {}


class _SegView(object):
    """A block that shows a slice of its ops (a hybrid segment) and
    delegates everything else to the real block."""

    __slots__ = ("_block", "ops")

    def __init__(self, block, ops):
        self._block = block
        self.ops = ops

    def __getattr__(self, name):
        return getattr(self._block, name)


class Executor(object):
    """Runs programs on one device: ``device`` is ``"cuda"`` (default,
    raises without a card) or ``"cpu"``, where every kernel wrapper takes
    its plain PyTorch version. ``check_nan_inf`` (None: the flag at each
    run) scans every op output on the per-op path."""

    def __init__(self, device=DEFAULT_DEVICE, check_nan_inf=None):
        # the lowerings: a program loaded from a file (an inference model)
        # reaches the Executor with no layers module imported
        from .. import ops  # noqa: F401
        self.device = resolve_device(device)
        self._check_nan_inf_arg = check_nan_inf
        # jit_runs / eager_runs / hybrid_runs: which path each run() took
        # (a compiled step's warm-up is a jit run); lazy_fetches: handles
        # sync=False returned; fetch_sync_count: handles materialized;
        # compile_cache_hits: the JAX package's warm start across
        # Executors, which has no counterpart (a graph holds the scope's
        # own tensors and a private pool), so it stays 0; graph_captures
        # / graph_replays: what the card ran; ops_run: lowerings executed
        # (a replay executes none); feed_wait_ms / dispatch_depth: the
        # feed pipeline's, folded in by Trainer.train; tune_*: the
        # process-level kernel-dispatch counters of paddle_tpu_torch.tune,
        # refreshed after every run(): a compiled step counts its key's
        # first lowering pass only, as the JAX package counts a trace
        self.stats = {"jit_runs": 0, "eager_runs": 0, "hybrid_runs": 0,
                      "lazy_fetches": 0, "fetch_sync_count": 0,
                      "compile_cache_hits": 0, "graph_captures": 0,
                      "graph_replays": 0, "ops_run": 0,
                      "feed_wait_ms": 0.0, "dispatch_depth": 0,
                      "tune_hits": 0, "tune_misses": 0, "tune_fallbacks": 0,
                      # the memory preflight's last predicted peak
                      # (FLAGS.verify; analysis.memory PT030)
                      "mem_predicted_peak_bytes": 0}
        self.graph_cache_limit = GRAPH_CACHE_LIMIT
        self._cache = collections.OrderedDict()
        self._analysis = {}
        self._facts = {}
        # programs whose capture failed: the per-op path from then on
        self._force_eager = set()
        # (uid, version) of the programs the verify hook passed, and the
        # (uid, version, feed signature, fetches) the memory preflight
        # passed: each is checked once, not every step
        self._verified = set()
        self._preflighted = set()
        self._degradation_logged = set()
        # scope (weak) -> its serial, the first part of every cache key;
        # the serials of scopes gone, whose steps are freed at the next run
        self._scope_serials = weakref.WeakKeyDictionary()
        self._dead_serials = []
        # the memory pool new captures join, and the live graphs of each
        # pool (a pool a capture failed in is not joined again: the
        # allocator may still hold it as being recorded to)
        self._pool = None
        self._pool_graphs = {}
        # scope (weak) -> {(names versions, uid, version, feed names) ->
        # (state names, state signature)}, rebuilt when a scope's set of
        # names changes (paddle_tpu/core/executor.py:1113)
        self._state_memo = weakref.WeakKeyDictionary()

    @property
    def check_nan_inf(self):
        if self._check_nan_inf_arg is not None:
            return self._check_nan_inf_arg
        from ..flags import FLAGS
        return FLAGS.check_nan_inf

    @check_nan_inf.setter
    def check_nan_inf(self, v):
        self._check_nan_inf_arg = v

    def prepare_feed(self, feed):
        """Move a feed dict to the device once; the result can be passed
        to run() repeatedly without another copy."""
        return {k: _to_device_value(v, self.device) for k, v in feed.items()}

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_jit=True, repeat=1, sync=True):
        """Run ``program``'s global block. ``feed``: {name: array or
        tensor, or ``LoDTensor`` for a ragged var}; ``fetch_list``:
        Variables or names. Returns the fetches as numpy arrays (a
        ``LoDTensor`` for a LoD value), or as tensors on the device with
        ``return_numpy=False``, or as :class:`AsyncFetch` handles with
        ``sync=False``. ``use_jit`` runs the compiled path (module
        docstring); ``repeat=K`` runs K steps there on one feed and
        returns the last step's fetches."""
        program = program if program is not None \
            else ir.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, ir.Variable) else f
                       for f in (fetch_list or [])]
        repeat = int(repeat)
        if repeat < 1:
            raise ValueError("repeat must be at least 1, got %d" % repeat)
        feed = self.prepare_feed(feed or {})
        if self._dead_serials:
            self._free_dead_scopes()
        if _verify_requested():
            self._maybe_verify(program)
            self._memory_preflight(program, feed, scope, fetch_names)
        block = program.global_block()
        host = self._program_facts(program).host
        nan_scan = self.check_nan_inf
        timing = _prof.profiler_enabled()
        t0 = time.perf_counter() if timing else 0.0
        with torch.no_grad():
            if (host or not use_jit or nan_scan
                    or program._uid in self._force_eager):
                if repeat != 1:
                    raise ValueError("repeat>1 requires the jit path")
                # a block that runs another (a While body, a Switch case)
                # runs per-op whole (paddle_tpu/core/executor.py:850)
                hybrid_ok = (use_jit and not nan_scan
                             and program._uid not in self._force_eager
                             and not self._program_facts(program).sub_blocks)
                if use_jit and host and \
                        program._uid not in self._degradation_logged:
                    self._degradation_logged.add(program._uid)
                    ops = list(iter_ops(block))
                    n_host = sum(
                        1 for op in ops
                        if registry.op_is_host(registry.lookup_checked(
                            op.type), op))
                    _LOG.warning(
                        "program %d holds %d host op(s) of %d: %s",
                        program._uid, n_host, len(ops),
                        "its device segments are compiled, the host ops "
                        "run between them" if hybrid_ok else "it runs on "
                        "the per-op path (a block runs another, or a flag "
                        "asks for it)")
                if hybrid_ok:
                    outs = self._run_hybrid(program, feed, fetch_names,
                                            scope)
                    self.stats["hybrid_runs"] += 1
                else:
                    self.stats["eager_runs"] += 1
                    outs = self._run_eager(program, feed, fetch_names,
                                           scope, nan_scan)
            else:
                outs = self._run_compiled(program, feed, fetch_names, scope,
                                          repeat)
        if timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            _prof.record_run("program_%d_run" % program._uid,
                             time.perf_counter() - t0)
        from .. import tune
        self.stats.update(tune.counters())
        outs = [_no_host_value(o) for o in outs]
        if not sync:
            self.stats["lazy_fetches"] += len(outs)
            return [AsyncFetch(o, return_numpy=return_numpy,
                               stats=self.stats) for o in outs]
        if return_numpy:
            return [_fetch_to_host(o) for o in outs]
        return outs

    # -- the per-op path ------------------------------------------------------
    def _run_eager(self, program, feed, fetch_names, scope, nan_scan=False):
        _prof.set_phase("eager")
        block = program.global_block()
        env = dict(feed)
        for n in self._state_inputs(program, scope, feed):
            env[n] = scope.find_var(n)
        inputs = {id(v) for v in env.values()}
        trace_ops(block, env, self._generator(program, scope), self.device,
                  _nan_inf_hook if nan_scan else None,
                  self._release(program, fetch_names))
        self.stats["ops_run"] += len(block.ops)
        self._writeback(program, scope, env)
        return self._fetches(env, fetch_names, inputs,
                             self._program_facts(program).persist)

    @staticmethod
    def _fetches(env, fetch_names, inputs=(), persist=()):
        """The fetched values; one that is a feed, a state tensor or a
        persistable this run writes back (a later compiled run writes
        into the scope's tensor in place) is copied."""
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch %s: no op of the program produced it "
                           "and it was not fed" % missing)
        return [_own(env[n]) if id(env[n]) in inputs or n in persist
                else env[n] for n in fetch_names]

    def _writeback(self, program, scope, env):
        """Persistables into the scope, a concrete scalar as its tensor
        (``paddle_tpu/core/executor.py:1813``)."""
        persist = self._program_facts(program).persist
        for n, v in env.items():
            if n in persist:
                scope.set_var(n, _no_host_value(v))

    # -- the compiled path ----------------------------------------------------
    def _state_for(self, program, scope, feed):
        """(state names, state signature) of ``program`` over ``scope``,
        memoized until the scope's names change."""
        per_scope = self._state_memo.setdefault(scope, {})
        vers, sc = [], scope
        while sc is not None:
            vers.append(sc._names_version)
            sc = sc.parent
        memo_key = (tuple(vers), program._uid, program._version,
                    tuple(sorted(feed)))
        got = per_scope.get(memo_key)
        if got is None:
            names = self._state_inputs(program, scope, feed)
            sig = tuple((n,) + _value_sig(scope.find_var(n)) for n in names)
            if len(per_scope) > 32:  # bound stale-version entries
                per_scope.clear()
            got = per_scope[memo_key] = (names, sig)
        return got

    def _run_compiled(self, program, feed, fetch_names, scope, repeat,
                      retry=True):
        block = program.global_block()
        state_names, state_sig = self._state_for(program, scope, feed)
        key = (self._scope_serial(scope), program._uid, program._version,
               _feed_signature(feed), tuple(fetch_names), state_sig)
        facts = self._program_facts(program)
        persist, written = facts.persist, facts.written
        # persistables this program creates (startup init ops) leave the
        # step beside the state (paddle_tpu/core/executor.py:1566)
        extra_names = sorted((written & persist) - set(state_names)
                             - set(feed))
        generator = self._generator(program, scope)
        release = self._release(program, fetch_names)

        def body(env, bufs):
            trace_ops(block, env, generator, self.device, release=release)
            self.stats["ops_run"] += len(block.ops)
            self._write_state(env, state_names, bufs, written)
            missing = [n for n in fetch_names if n not in env]
            if missing:
                raise KeyError("fetch %s: no op of the program produced it "
                               "and it was not fed" % missing)
            return ([env[n] for n in fetch_names],
                    {n: _no_host_value(env[n]) for n in extra_names
                     if n in env})

        def eager():
            return self._run_eager(program, feed, fetch_names, scope)

        try:
            with _compiled_step():
                outs = self._step(key, feed, scope, state_names,
                                  generator, body, eager, repeat)
        except _StaleState:
            if not retry:
                raise
            self._state_memo.pop(scope, None)
            return self._run_compiled(program, feed, fetch_names, scope,
                                      repeat, retry=False)
        except _Fallback as e:
            if repeat != 1:
                raise e.error if e.error is not None else e
            warnings.warn(
                "program %d: its step could not be captured as a CUDA graph"
                " (%s%s); it runs on the per-op path from now on"
                % (program._uid, e, "; " + e.op if e.op else ""),
                RuntimeWarning)
            self._force_eager.add(program._uid)
            self._drop(key)
            self.stats["eager_runs"] += 1
            return self._run_eager(program, feed, fetch_names, scope)
        self.stats["jit_runs"] += 1
        return outs

    @staticmethod
    def _write_state(env, names, bufs, written):
        """Copy every persistable the step wrote into its state tensor. A
        new value that shares memory with a state tensor is copied first,
        so that no write reads a tensor already written."""
        if not bufs:
            return
        ptrs = {_storage(b) for b in bufs}
        pending = []
        for n, buf in zip(names, bufs):
            if n not in written or n not in env:
                continue
            # the state is a tensor: a captured graph keeps no host value
            # of it (paddle_tpu/core/executor.py:1586)
            v = _no_host_value(env[n])
            if v is buf:
                continue
            if not (isinstance(v, torch.Tensor) and v.shape == buf.shape
                    and v.dtype == buf.dtype and v.device == buf.device):
                raise _Fallback("the step writes persistable %r as %s, its "
                                "state tensor is %s"
                                % (n, _value_sig(v), _value_sig(buf)))
            if _storage(v) in ptrs:
                v = v.clone()
            pending.append((buf, v))
        for buf, v in pending:
            buf.copy_(v)

    def _step(self, key, feed, scope, state_names, generator, body, eager,
              repeat=1):
        """One run of the compiled step ``key``: the warm-up (``eager()``),
        the capture of ``body(env, state tensors) -> (outs, extra)``, or a
        replay. Raises _Fallback when the capture fails."""
        entry = self._cache.get(key)
        if entry is None:
            entry = self._cache[key] = _Step()
            while len(self._cache) > max(1, self.graph_cache_limit):
                _, old = self._cache.popitem(last=False)
                self._free(old)
        else:
            self._cache.move_to_end(key)
        from .. import tune
        if entry.runs == 0:
            # the key's first lowering pass, the JAX package's trace: the
            # tune consults count here and nowhere else (Queue 3 #4)
            before = _gen_state(generator)
            saved = generator.get_state() if generator is not None else None
            try:
                outs = eager()
            except _Fallback:
                # the warm-up read a device value on the host: the per-op
                # run that follows draws what this one drew
                if saved is not None:
                    generator.set_state(saved)
                raise
            with tune.quiet():
                for _ in range(repeat - 1):
                    outs = eager()
            after = _gen_state(generator)
            entry.draws = before is not None and not torch.equal(before,
                                                                 after)
            entry.runs = 1
            return outs
        entry.runs += 1
        if not entry.ready:
            with tune.quiet():
                outs = self._capture(entry, feed, scope, state_names,
                                     generator, body)
            if outs is not None:
                # the CPU ran the step while standing in for the capture
                repeat -= 1
                if repeat == 0:
                    self._profile_step(entry, key, feed)
                    return [_own(o) for o in outs]
        for n, v in feed.items():
            _copy_in(entry.feed_bufs[n], v)
        self._sync_state(entry, scope)
        if entry.graph is not None:
            from .. import kernels
            for _ in range(repeat):
                entry.graph.replay()
                kernels.add_launches(entry.delta)
                self.stats["graph_replays"] += 1
            outs, extra = entry.outs, entry.extra
        else:
            with tune.quiet():
                for _ in range(repeat):
                    outs, extra = body(self._static_env(entry),
                                       entry.state_bufs)
        for n, v in extra.items():
            # out of the shared pool, which another graph's replay reuses
            scope.set_var(n, _own(v))
        self._profile_step(entry, key, feed)
        return [_own(o) for o in outs]

    @staticmethod
    def _profile_step(entry, key, feed):
        """While profiling is on, the profiler's ``programs`` entry of a
        compiled step (``paddle_tpu/core/executor.py:1621-1646``): taken
        once, after the first replay, from a graph captured with its nodes
        kept, then put back at every later replay so that a
        ``reset_profiler`` between sessions keeps it. Label
        ``program_<uid>`` (a hybrid segment's ``program_<uid>_seg<i>``)."""
        if not _prof.profiler_enabled():
            return
        label = "program_%d" % key[1]
        if len(key) > 4 and key[3] == "hyb":
            label += "_seg%d" % key[4]
        if entry.prof is None:
            entry.prof = _prof.record_program_analysis(
                label, graph=entry.graph if entry.kept else None,
                pool=entry.pool,
                feed_shapes={n: tuple(raw_data(v).shape)
                             for n, v in feed.items()},
                launches=entry.delta)
        else:
            _prof.put_program_analysis(label, entry.prof)

    @staticmethod
    def _static_env(entry):
        env = dict(entry.feed_bufs)
        env.update(zip(entry.state_names, entry.state_bufs))
        return env

    def _sync_state(self, entry, scope):
        """Before a replay: a scope entry that is no longer its state
        tensor (a set_var, a load) is copied into that tensor."""
        for n, buf in zip(entry.state_names, entry.state_bufs):
            v = scope.find_var(n)
            if v is buf:
                continue
            if not (isinstance(v, torch.Tensor) and v.shape == buf.shape
                    and v.dtype == buf.dtype):
                raise _StaleState(n)
            buf.copy_(v)
            scope.set_var(n, buf)

    def _capture(self, entry, feed, scope, state_names, generator, body):
        """Set up the static buffers and capture ``body`` as a CUDA graph
        (on the CPU: run it once). Returns the CPU run's outputs, or None
        on the card, where the capture executed nothing."""
        entry.feed_bufs = {n: _static_like(v) for n, v in feed.items()}
        bufs, seen = [], set()
        for n in state_names:
            v = scope.find_var(n)
            if not isinstance(v, torch.Tensor):
                raise _Fallback("state %r holds %s, not a tensor"
                                % (n, type(v).__name__))
            if v.device != self.device:
                v = v.to(self.device)
                scope.set_var(n, v)
            if _storage(v) in seen:
                # two state names on one tensor: each needs its own
                v = v.clone()
                scope.set_var(n, v)
            seen.add(_storage(v))
            bufs.append(v)
        entry.state_names, entry.state_bufs = tuple(state_names), tuple(bufs)
        env = self._static_env(entry)
        cuda = self.device.type == "cuda"
        saved_gen = generator.get_state() if generator is not None else None
        from .. import kernels
        counts0 = kernels.launch_counts()
        # while profiling, the graph keeps its nodes for the profiler's
        # programs entry (it is instantiated at its first replay)
        entry.kept = cuda and _prof.profiler_enabled()
        graph = (torch.cuda.CUDAGraph(entry.kept) if entry.kept
                 else torch.cuda.CUDAGraph()) if cuda else None
        error = None
        if not cuda:
            _prof.set_phase("trace")
            try:
                outs, extra = body(env, entry.state_bufs)
            except Exception as e:
                error = e
            finally:
                _prof.set_phase("eager")
        else:
            if entry.draws:
                if not hasattr(graph, "register_generator_state"):
                    raise _Fallback(
                        "the step draws from the scope's generator and "
                        "this torch cannot register a generator with a "
                        "graph (CUDAGraph.register_generator_state)")
                graph.register_generator_state(generator)
            _prof.set_phase("trace")
            try:
                with CAPTURE_LOCK:
                    error, outs, extra = self._capture_on_card(
                        graph, env, entry.state_bufs, body)
            finally:
                _prof.set_phase("eager")
        counts1 = kernels.launch_counts()
        if cuda or error is not None:
            kernels.restore_launches(counts0)
        if error is not None:
            if saved_gen is not None:
                generator.set_state(saved_gen)
            if graph is not None:
                graph.reset()
            entry.free()
            first = str(error).strip().splitlines()
            raise _Fallback("%s: %s" % (type(error).__name__,
                                        first[0] if first else ""),
                            op=_failed_op(error), error=error)
        entry.ready = True
        if not cuda:
            return outs
        entry.graph, entry.outs, entry.extra = graph, tuple(outs), extra
        entry.pool = self._pool
        self._pool_graphs[entry.pool] = \
            self._pool_graphs.get(entry.pool, 0) + 1
        entry.delta = {k: counts1[k] - counts0[k] for k in counts0
                       if counts1[k] != counts0[k]}
        self.stats["graph_captures"] += 1
        return None

    def _capture_on_card(self, graph, env, bufs, body):
        """Capture ``body`` into ``graph`` on the capture stream: (the
        error that ended it or None, outs, extra)."""
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        stream = _capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        error, outs, extra = None, (), {}
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self._pool)
            try:
                outs, extra = body(env, bufs)
                # the created persistables' static buffers, in the graph's
                # pool: every replay writes them
                extra = {n: _static_like(v) for n, v in extra.items()}
            except Exception as e:
                error = e
            finally:
                try:
                    graph.capture_end()
                except Exception as e:
                    if error is None:
                        error = e
        torch.cuda.current_stream(self.device).wait_stream(stream)
        if error is not None:
            self._pool = None
        return error, outs, extra

    def _free(self, entry):
        """Free a step's graph; with the last graph of its pool the pool
        goes too (a capture after that starts a new one, since a pool no
        graph holds is released and cannot be joined)."""
        if entry.graph is not None:
            left = self._pool_graphs.pop(entry.pool) - 1
            if left:
                self._pool_graphs[entry.pool] = left
            elif self._pool == entry.pool:
                self._pool = None
        entry.free()

    def _drop(self, key):
        entry = self._cache.pop(key, None)
        if entry is not None:
            self._free(entry)

    def close(self):
        """Free every compiled step and its graph."""
        for entry in self._cache.values():
            self._free(entry)
        self._cache.clear()

    def _scope_serial(self, scope):
        """The serial of ``scope`` in this Executor's cache keys: a step
        holds its scope's tensors and generator, so no other scope may
        hit it. A scope that is collected has its steps freed."""
        serial = self._scope_serials.get(scope)
        if serial is None:
            serial = self._scope_serials[scope] = next(_SCOPE_SERIALS)
            weakref.finalize(scope, self._dead_serials.append, serial)
        return serial

    def _free_dead_scopes(self):
        dead = set()
        while self._dead_serials:
            dead.add(self._dead_serials.pop())
        for key in [k for k in self._cache if k[0] in dead]:
            self._drop(key)

    # -- the hybrid path ------------------------------------------------------
    def _run_hybrid(self, program, feed, fetch_names, scope):
        """Runs of device ops compiled, host ops between them
        (``paddle_tpu/core/executor.py:925``). A segment whose capture
        fails finishes this run on the per-op path from that segment on,
        so the host ops already run do not run again."""
        _prof.set_phase("eager")
        block = program.global_block()
        env = dict(feed)
        state_names = self._state_inputs(program, scope, feed)
        for n in state_names:
            env[n] = scope.find_var(n)
        inputs = {id(v) for v in env.values()}
        akey = (program._uid, program._version, tuple(fetch_names),
                tuple(state_names))
        cached = self._analysis.get(akey)
        if cached is None:
            segments = self._partition_segments(block)
            keep = (set(fetch_names) | self._program_facts(program).persist
                    | set(state_names))
            later_reads, acc = [], set(keep)
            for _, ops in reversed(segments):
                later_reads.append(set(acc))
                for op in ops:
                    acc.update(op.input_arg_names)
            later_reads.reverse()
            # the block's release schedule, cut at the segments
            release, at = self._release(program, fetch_names), 0
            releases = []
            for _, ops in segments:
                releases.append(release[at:at + len(ops)])
                at += len(ops)
            if len(self._analysis) > 64:
                self._analysis.clear()
            cached = self._analysis[akey] = (segments, later_reads,
                                             releases)
        segments, later_reads, releases = cached
        generator = self._generator(program, scope)
        for idx, (kind, ops) in enumerate(segments):
            if kind == "host":
                trace_ops(_SegView(block, ops), env, generator, self.device,
                          release=releases[idx])
                self.stats["ops_run"] += len(ops)
                continue
            try:
                self._run_segment(program, scope, block, ops, idx, env,
                                  later_reads[idx], generator,
                                  releases[idx])
            except _Fallback as e:
                warnings.warn(
                    "program %d left the hybrid path (%s%s) and runs on the "
                    "per-op path from now on"
                    % (program._uid, e, "; " + e.op if e.op else ""),
                    RuntimeWarning)
                self._force_eager.add(program._uid)
                rest = [op for _, seg in segments[idx:] for op in seg]
                trace_ops(_SegView(block, rest), env, generator, self.device,
                          release=[r for rel in releases[idx:] for r in rel])
                self.stats["ops_run"] += len(rest)
                break
        self._writeback(program, scope, env)
        return self._fetches(env, fetch_names, inputs,
                             self._program_facts(program).persist)

    @staticmethod
    def _partition_segments(block):
        segs = []
        for op in block.ops:
            kind = "host" if registry.op_is_host(
                registry.lookup_checked(op.type), op) else "dev"
            if segs and segs[-1][0] == kind:
                segs[-1][1].append(op)
            else:
                segs.append((kind, [op]))
        return segs

    def _run_segment(self, program, scope, block, ops, idx, env, keep_after,
                     generator, release):
        reads = {}
        for op in ops:
            for n in op.input_arg_names:
                if n in env and n not in reads:
                    v = env[n]
                    # a concrete scalar's host value goes into the key
                    # (paddle_tpu/core/executor.py:1020); a tensor array or
                    # a rank table has no place in a captured step (:1027)
                    if not isinstance(v, (torch.Tensor, LoDValue,
                                          ConcreteScalar)):
                        raise _Fallback("a device op reads %r, which holds "
                                        "%s" % (n, type(v).__name__))
                    reads[n] = v
        writes = {n for op in ops for n in op.output_arg_names}
        out_names = tuple(sorted(writes & keep_after))
        view = _SegView(block, ops)
        key = (self._scope_serial(scope), program._uid, program._version,
               "hyb", idx, _feed_signature(reads), out_names)

        def body(seg_env, _bufs):
            trace_ops(view, seg_env, generator, self.device, release=release)
            self.stats["ops_run"] += len(ops)
            return [seg_env[n] for n in out_names], {}

        def eager():
            seg_env = dict(reads)
            return body(seg_env, ())[0]

        with _compiled_step():
            outs = self._step(key, reads, scope, (), generator, body, eager)
        env.update(zip(out_names, outs))
        for names in release:
            for n in names:
                env.pop(n, None)

    # -- the verify hook and the memory preflight ---------------------------
    def _maybe_verify(self, program):
        """The static verifier, once per (uid, version)
        (``paddle_tpu/core/executor.py:1665``): a malformed program
        raises one ProgramVerifyError listing every diagnostic; warnings
        alone surface as one RuntimeWarning."""
        key = (program._uid, program._version)
        if key in self._verified:
            return
        from ..analysis import render_diagnostics, verify_or_raise
        diags = verify_or_raise(program, context="pre-run verify")
        if diags:
            warnings.warn("program %d verification warnings:\n%s"
                          % (program._uid, render_diagnostics(diags)),
                          RuntimeWarning)
        self._verified.add(key)

    def _memory_preflight(self, program, feed, scope, fetch_names):
        """The memory check before a step's first run
        (``paddle_tpu/core/executor.py:1685``, one device): state and
        feeds priced from their tensors, the values in between from
        their declared shapes, against ``resolve_budget_bytes`` (the
        flag, else the card's memory). A predicted peak over it raises
        one ProgramVerifyError with the residency table; the estimate is
        a lower bound, the right direction for a refusal."""
        key = (program._uid, program._version, _feed_signature(feed),
               tuple(fetch_names))
        if key in self._preflighted:
            return
        from ..analysis import memory as _mem
        budget = _mem.resolve_budget_bytes(device=self.device)
        sizes = {}
        for n in self._state_inputs(program, scope, feed):
            nb = _nbytes(scope.find_var(n))
            if nb:
                sizes[n] = nb
        batch = None
        block = program.global_block()
        for n, v in feed.items():
            shape = tuple(raw_data(v).shape)
            declared = block._find_var_recursive(n)
            if (shape and declared is not None and declared.shape
                    and int(declared.shape[0]) == -1):
                batch = max(batch or 0, int(shape[0]))
            nb = _nbytes(v)
            if nb:
                sizes[n] = nb
        plan = _mem.verify_memory_or_raise(
            program, budget, batch=batch, fetches=fetch_names,
            sizes_override=sizes,
            context="executor memory preflight (before the step's first "
                    "run, program %d)" % program._uid)
        self.stats["mem_predicted_peak_bytes"] = plan.peak_bytes
        # the measured half of the predicted-vs-actual pair of the
        # timeline's memory section (paddle_tpu/core/executor.py:1746):
        # the live bytes at this step boundary, before the step allocates
        _prof.update_memory_counters(
            mem_preflights=1, mem_predicted_peak_bytes=plan.peak_bytes,
            mem_measured_live_bytes=self._live_bytes(scope))
        if len(self._preflighted) > 256:
            self._preflighted.clear()
        self._preflighted.add(key)

    def _live_bytes(self, scope):
        """The memory preflight's measured live bytes: on the card
        ``torch.cuda.memory_allocated``; on the CPU the bytes of the
        scope's tensors (its parents' too), each storage once."""
        if self.device.type == "cuda":
            return torch.cuda.memory_allocated(self.device)
        seen, total, sc = set(), 0, scope
        while sc is not None:
            for n in sc.local_var_names():
                data = raw_data(sc.find_var(n))
                if isinstance(data, torch.Tensor) and \
                        _storage(data) not in seen:
                    seen.add(_storage(data))
                    total += _nbytes(data)
            sc = sc.parent
        return total

    # -- helpers --------------------------------------------------------------
    def _release(self, program, fetch_names):
        """The release schedule of ``program``'s global block for these
        fetches (:meth:`_ProgramFacts.release`)."""
        return self._program_facts(program).release(fetch_names)

    def _program_facts(self, program):
        key = (program._uid, program._version)
        facts = self._facts.get(key)
        if facts is None:
            if len(self._facts) > 64:
                self._facts.clear()
            facts = self._facts[key] = _ProgramFacts(program)
        return facts

    def _state_inputs(self, program, scope, feed):
        """The persistables the program reads or writes that the scope
        holds (``paddle_tpu/core/executor.py:1790``)."""
        facts = self._program_facts(program)
        return [n for n in facts.referenced
                if n not in feed and n in facts.persist
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
