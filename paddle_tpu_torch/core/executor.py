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

Not ported yet (later slices): the explicit-comm and distributed paths,
the memory and sharding preflights and the verifier hook.
"""
from __future__ import annotations

import collections
import gc
import itertools
import logging
import threading
import warnings
import weakref
from typing import Any, Dict, List

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import ir, registry, types
from .lod import LoDTensor
from .scope import global_scope

__all__ = ["CAPTURE_LOCK", "GRAPH_CACHE_LIMIT", "RNG_VAR", "AsyncFetch",
           "Executor", "FunctionalContext", "LoDValue", "LowerContext",
           "raw_data", "to_lod_value", "trace_ops", "with_lod_of"]

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

    def next_generator(self):
        if self.generator is None:
            raise RuntimeError(
                "Op %s requires randomness in a context without a "
                "generator (e.g. inside a generic grad replay). Register "
                "a custom grad." % self.op.type)
        return self.generator


def trace_ops(block: ir.Block, env: Dict[str, Any], generator, device,
              value_hook=None):
    """Run every op's lowering over ``env``, in program order.
    ``value_hook(name, value)`` sees every value an op sets (the NaN/Inf
    scan)."""
    for op in block.ops:
        opdef = registry.lookup_checked(op.type)
        try:
            opdef.lower(LowerContext(op, env, generator, block, device,
                                     value_hook))
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




# -- the compiled path's helpers ----------------------------------------------

def _is_host_block(block) -> bool:
    """Whether a block holds an op that must run on the host
    (``paddle_tpu/core/executor.py:351``)."""
    for op in block.ops:
        opdef = registry.lookup(op.type)
        if opdef is not None and registry.op_is_host(opdef, op):
            return True
    return False


class _ProgramFacts(object):
    """What a run needs to know of a program's ops and vars, found once
    per (uid, version): whether it holds a host op, its persistables,
    the names its ops read or write, and the names they write."""

    __slots__ = ("host", "persist", "referenced", "written")

    def __init__(self, program):
        block = program.global_block()
        self.host = _is_host_block(block)
        self.persist = frozenset(v.name for v in program.list_vars()
                                 if v.persistable)
        self.written = frozenset(n for op in block.ops
                                 for n in op.output_arg_names)
        self.referenced = tuple(sorted(self.written | {
            n for op in block.ops for n in op.input_arg_names}))


def _value_sig(v):
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
    """A buffer of its own holding ``v`` (a tensor or a LoD value)."""
    if isinstance(v, LoDValue):
        return LoDValue(torch.empty_like(v.data).copy_(v.data),
                        [torch.empty_like(l).copy_(l) for l in v.lod],
                        max_lens=v.max_lens)
    return torch.empty_like(v).copy_(v)


def _copy_in(buf, v):
    if buf is v:
        return
    if isinstance(buf, LoDValue):
        buf.data.copy_(v.data)
        for b, l in zip(buf.lod, v.lod):
            b.copy_(l)
    else:
        buf.copy_(v)


def _own(v):
    """A fetched value that no later run writes into."""
    if isinstance(v, LoDValue):
        return LoDValue(v.data.clone(), [l.clone() for l in v.lod],
                        max_lens=v.max_lens)
    if isinstance(v, torch.Tensor):
        return v.clone()
    return v


def _storage(t):
    return t.untyped_storage().data_ptr()


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
      ``fetch_sync_count`` on the Executor;
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
                 "state_names", "state_bufs", "outs", "extra", "delta")

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
        # refreshed after every run() (a replay consults nothing)
        self.stats = {"jit_runs": 0, "eager_runs": 0, "hybrid_runs": 0,
                      "lazy_fetches": 0, "fetch_sync_count": 0,
                      "compile_cache_hits": 0, "graph_captures": 0,
                      "graph_replays": 0, "ops_run": 0,
                      "feed_wait_ms": 0.0, "dispatch_depth": 0,
                      "tune_hits": 0, "tune_misses": 0, "tune_fallbacks": 0}
        self.graph_cache_limit = GRAPH_CACHE_LIMIT
        self._cache = collections.OrderedDict()
        self._analysis = {}
        self._facts = {}
        # programs whose capture failed: the per-op path from then on
        self._force_eager = set()
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
        block = program.global_block()
        host = self._program_facts(program).host
        nan_scan = self.check_nan_inf
        with torch.no_grad():
            if (host or not use_jit or nan_scan
                    or program._uid in self._force_eager):
                if repeat != 1:
                    raise ValueError("repeat>1 requires the jit path")
                hybrid_ok = (use_jit and not nan_scan
                             and program._uid not in self._force_eager)
                if use_jit and host and \
                        program._uid not in self._degradation_logged:
                    self._degradation_logged.add(program._uid)
                    n_host = sum(
                        1 for op in block.ops
                        if registry.op_is_host(registry.lookup_checked(
                            op.type), op))
                    _LOG.warning(
                        "program %d holds %d host op(s) of %d: its device "
                        "segments are compiled, the host ops run between "
                        "them", program._uid, n_host, len(block.ops))
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
        from .. import tune
        self.stats.update(tune.counters())
        if not sync:
            self.stats["lazy_fetches"] += len(outs)
            return [AsyncFetch(o, return_numpy=return_numpy,
                               stats=self.stats) for o in outs]
        if return_numpy:
            return [_fetch_to_host(o) for o in outs]
        return outs

    # -- the per-op path ------------------------------------------------------
    def _run_eager(self, program, feed, fetch_names, scope, nan_scan=False):
        block = program.global_block()
        env = dict(feed)
        for n in self._state_inputs(program, scope, feed):
            env[n] = scope.find_var(n)
        inputs = {id(v) for v in env.values()}
        trace_ops(block, env, self._generator(program, scope), self.device,
                  _nan_inf_hook if nan_scan else None)
        self.stats["ops_run"] += len(block.ops)
        self._writeback(program, scope, env)
        return self._fetches(env, fetch_names, inputs)

    @staticmethod
    def _fetches(env, fetch_names, inputs=()):
        """The fetched values; one that is a feed or a state tensor is
        copied, as a later compiled run may write into that tensor."""
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch %s: no op of the program produced it "
                           "and it was not fed" % missing)
        return [_own(env[n]) if id(env[n]) in inputs else env[n]
                for n in fetch_names]

    def _writeback(self, program, scope, env):
        persist = self._program_facts(program).persist
        for n, v in env.items():
            if n in persist:
                scope.set_var(n, v)

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

        def body(env, bufs):
            trace_ops(block, env, generator, self.device)
            self.stats["ops_run"] += len(block.ops)
            self._write_state(env, state_names, bufs, written)
            missing = [n for n in fetch_names if n not in env]
            if missing:
                raise KeyError("fetch %s: no op of the program produced it "
                               "and it was not fed" % missing)
            return ([env[n] for n in fetch_names],
                    {n: env[n] for n in extra_names if n in env})

        def eager():
            return self._run_eager(program, feed, fetch_names, scope)

        try:
            outs = self._step(key, feed, scope, state_names, generator,
                              body, eager, repeat)
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
            v = env[n]
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
        if entry.runs == 0:
            before = _gen_state(generator)
            for _ in range(repeat):
                outs = eager()
            after = _gen_state(generator)
            entry.draws = before is not None and not torch.equal(before,
                                                                 after)
            entry.runs = 1
            return outs
        entry.runs += 1
        if not entry.ready:
            outs = self._capture(entry, feed, scope, state_names, generator,
                                 body)
            if outs is not None:
                # the CPU ran the step while standing in for the capture
                repeat -= 1
                if repeat == 0:
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
            for _ in range(repeat):
                outs, extra = body(self._static_env(entry),
                                   entry.state_bufs)
        for n, v in extra.items():
            # out of the shared pool, which another graph's replay reuses
            scope.set_var(n, _own(v))
        return [_own(o) for o in outs]

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
        graph = torch.cuda.CUDAGraph() if cuda else None
        error = None
        if not cuda:
            try:
                outs, extra = body(env, entry.state_bufs)
            except Exception as e:
                error = e
        else:
            if entry.draws:
                if not hasattr(graph, "register_generator_state"):
                    raise _Fallback(
                        "the step draws from the scope's generator and "
                        "this torch cannot register a generator with a "
                        "graph (CUDAGraph.register_generator_state)")
                graph.register_generator_state(generator)
            with CAPTURE_LOCK:
                error, outs, extra = self._capture_on_card(
                    graph, env, entry.state_bufs, body)
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
            if len(self._analysis) > 64:
                self._analysis.clear()
            cached = self._analysis[akey] = (segments, later_reads)
        segments, later_reads = cached
        generator = self._generator(program, scope)
        for idx, (kind, ops) in enumerate(segments):
            if kind == "host":
                trace_ops(_SegView(block, ops), env, generator, self.device)
                self.stats["ops_run"] += len(ops)
                continue
            try:
                self._run_segment(program, scope, block, ops, idx, env,
                                  later_reads[idx], generator)
            except _Fallback as e:
                warnings.warn(
                    "program %d left the hybrid path (%s%s) and runs on the "
                    "per-op path from now on"
                    % (program._uid, e, "; " + e.op if e.op else ""),
                    RuntimeWarning)
                self._force_eager.add(program._uid)
                rest = [op for _, seg in segments[idx:] for op in seg]
                trace_ops(_SegView(block, rest), env, generator, self.device)
                self.stats["ops_run"] += len(rest)
                break
        self._writeback(program, scope, env)
        return self._fetches(env, fetch_names, inputs)

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
                     generator):
        reads = {}
        for op in ops:
            for n in op.input_arg_names:
                if n in env and n not in reads:
                    v = env[n]
                    if not isinstance(v, (torch.Tensor, LoDValue)):
                        raise _Fallback("a device op reads %r, which holds "
                                        "%s" % (n, type(v).__name__))
                    reads[n] = v
        writes = {n for op in ops for n in op.output_arg_names}
        out_names = tuple(sorted(writes & keep_after))
        view = _SegView(block, ops)
        key = (self._scope_serial(scope), program._uid, program._version,
               "hyb", idx, _feed_signature(reads), out_names)

        def body(seg_env, _bufs):
            trace_ops(view, seg_env, generator, self.device)
            self.stats["ops_run"] += len(ops)
            return [seg_env[n] for n in out_names], {}

        def eager():
            seg_env = dict(reads)
            return body(seg_env, ())[0]

        outs = self._step(key, reads, scope, (), generator, body, eager)
        env.update(zip(out_names, outs))

    # -- helpers --------------------------------------------------------------
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
