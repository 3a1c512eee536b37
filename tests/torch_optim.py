"""Shared by the op and optimization tests of the port (clipping, weight
decay, learning-rate schedules, the optimizers and their update ops, the
dense tensor and loss ops): each package's modules under one name,
programs built alike in both under each package's ``unique_name.guard()``
(so every variable has the same name), runs of a program in each package
from one state (the JAX startup's, carried into the port's scope), and
one-op programs run in both on the same feeds (:func:`one_op`).

Tolerances (float32 on both sides, sums in other orders):
- an op's output within 1e-6 of max(1, |the JAX value|) (``OP_TOL``);
- losses within 1e-5 relative at every step (``LOSS_TOL``);
- persistables within 1e-5 of max(1, the largest magnitude) after the
  last step (``STATE_TOL``);
- learning rates within 1e-6 relative (``LR_TOL``).
"""
import types

import numpy as np

import paddle_tpu as jpt
from paddle_tpu import clip as jclip
from paddle_tpu import layers as jlayers
from paddle_tpu import learning_rate_decay as jlrd
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.core import lod as jlod
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.backward import append_backward as jbackward
from paddle_tpu.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import learning_rate_decay as tlrd
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.core.backward import append_backward as tbackward
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.core.scope import scope_from_numpy, scope_to_numpy
from paddle_tpu_torch.param_attr import ParamAttr as TParamAttr

OP_TOL = 1e-6
LOSS_TOL = 1e-5
STATE_TOL = 1e-5
LR_TOL = 1e-6

JAX = types.SimpleNamespace(
    name="jax", layers=jlayers, optimizer=jopt, clip=jclip,
    regularizer=jreg, lrd=jlrd, ParamAttr=JParamAttr, Program=jpt.Program,
    program_guard=jpt.program_guard, unique_name=jun,
    append_backward=jbackward)
PORT = types.SimpleNamespace(
    name="port", layers=tlayers, optimizer=topt, clip=tclip,
    regularizer=treg, lrd=tlrd, ParamAttr=TParamAttr, Program=tir.Program,
    program_guard=tir.program_guard, unique_name=tun,
    append_backward=tbackward)
PKGS = (JAX, PORT)


def build(pkg, fn):
    """(main, startup, fn(pkg)'s result) with ``fn`` run under ``pkg``'s
    name guard and program guard."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        out = fn(pkg)
    return main, start, out


def op_types(main):
    return [op.type for op in main.global_block().ops]


def persist_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def jax_startup_state(main, start):
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor(jpt.CPUPlace()).run(start)
    return {n: np.asarray(scope.find_var(n)) for n in persist_names(main)
            if scope.find_var(n) is not None}


def jax_run(main, state, feeds, fetch, scope=None):
    """Run ``main`` over ``feeds`` from ``state``: (each run's fetches as
    numpy, the final persistables, the scope)."""
    scope = scope or jpt.Scope()
    exe = jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, v)
        outs = [[np.asarray(o) for o in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds]
        final = {n: np.asarray(scope.find_var(n)) for n in state}
    return outs, final, scope


def port_run(main, state, feeds, fetch, use_jit=True, exe=None,
             scope=None):
    """The same in the port on the CPU; also returns the Executor."""
    exe = exe or TExecutor("cpu")
    scope = scope or TScope()
    scope_from_numpy(state, device="cpu", scope=scope)
    outs = [[np.asarray(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope, use_jit=use_jit)]
            for f in feeds]
    return outs, scope_to_numpy(scope, names=state), scope, exe


def rel(got, want):
    """The largest error over max(1, the largest magnitude of want)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1.0))


def loss_rel(got, want):
    got = np.asarray(got, np.float64).reshape(-1)
    want = np.asarray(want, np.float64).reshape(-1)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def lr_rel(got, want):
    return loss_rel(got, want)


def linear_regression(pkg, make_opt, param_attr=None, bias_attr=None):
    """``tests/test_core.py:124``'s program: fc(4 -> 1) on x, the mean
    square error against y, minimized by ``make_opt(pkg)``: the loss."""
    L = pkg.layers
    x = L.data(name="x", shape=[4])
    y = L.data(name="y", shape=[1])
    pred = L.fc(input=x, size=1, param_attr=param_attr, bias_attr=bias_attr)
    loss = L.mean(L.square_error_cost(pred, y))
    make_opt(pkg).minimize(loss)
    return loss


def regression_feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.randn(8, 4).astype(np.float32)
        out.append({"x": x, "y": (x @ w + 0.1).astype(np.float32)})
    return out


def run_both(fn, feed, fetch_of):
    """Build ``fn`` in each package and run it once on ``feed``;
    ``fetch_of(result)`` names the fetches. Returns (jax fetches, port
    fetches, jax main, port main)."""
    out = []
    for pkg in PKGS:
        main, _, res = build(pkg, fn)
        fetch = fetch_of(res)
        if pkg is JAX:
            got = jax_run(main, {}, [feed], fetch)[0][0]
        else:
            got = port_run(main, {}, [feed], fetch)[0][0]
        out.append((got, main))
    return out[0][0], out[1][0], out[0][1], out[1][1]


# -- one-op programs in both packages ------------------------------------------

def _split_value(v):
    """(array, lod) of a feed value: an array, or an (array, lod) pair."""
    return (np.asarray(v[0]), v[1]) if isinstance(v, tuple) else \
        (np.asarray(v), None)


def one_op_program(pkg, op_type, inputs, outputs, attrs=None, diff=(),
                   loss_of=None, loss_w=None):
    """``op_type`` alone in a main program of ``pkg``. ``inputs``:
    {slot: [(name, value)]}, a value an array or an (array, lod) pair;
    ``outputs``: {slot: [name]}. With ``diff`` (input names), the
    program also appends the backward of mean(``loss_of`` * w), w the
    fed ``loss_w`` (name ``loss_w``), so that ``<name>@GRAD`` of each
    name in ``diff`` can be fetched."""
    main = pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
        blk = main.global_block()
        ins = {}
        for slot, items in inputs.items():
            ins[slot] = []
            for name, v in items:
                arr, lod = _split_value(v)
                var = blk.create_var(name=name, shape=arr.shape,
                                     dtype=str(arr.dtype),
                                     lod_level=len(lod) if lod else 0)
                var.stop_gradient = name not in diff
                ins[slot].append(name)
        for names in outputs.values():
            for n in names:
                blk.create_var(name=n, dtype=None)
        blk.append_op(type=op_type, inputs=ins, outputs=dict(outputs),
                      attrs=dict(attrs or {}))
        if diff:
            w = blk.create_var(name="loss_w", shape=loss_w.shape,
                               dtype="float32")
            w.stop_gradient = True
            pkg.append_backward(pkg.layers.mean(pkg.layers.elementwise_mul(
                blk.var(loss_of), w)))
    return main


def feed_of(pkg, inputs, loss_w=None):
    """The feed dict of ``inputs`` for ``pkg``: an (array, lod) pair as
    the package's LoDTensor."""
    feed = {}
    for items in inputs.values():
        for name, v in items:
            arr, lod = _split_value(v)
            mod = jlod if pkg is JAX else tlod
            feed[name] = mod.LoDTensor(arr, lod) if lod else arr
    if loss_w is not None:
        feed["loss_w"] = loss_w
    return feed


def run_once(pkg, main, feed, fetch, use_jit=True):
    """One run of ``main`` in ``pkg`` on the CPU in a fresh scope: the
    fetches as each package returns them (a LoD value as its
    LoDTensor)."""
    if pkg is JAX:
        with jpt.scope_guard(jpt.Scope()):
            return list(jpt.Executor(jpt.CPUPlace()).run(
                main, feed=feed, fetch_list=fetch))
    return list(TExecutor("cpu").run(main, feed=feed, fetch_list=fetch,
                                     scope=TScope(), use_jit=use_jit))


def one_op(op_type, inputs, outputs, attrs=None, diff=(), loss_of=None,
           seed=0):
    """Run ``op_type`` alone in both packages on the same feeds; with
    ``diff``, also the gradients of mean(``loss_of`` * w) (w seeded,
    of ``loss_of``'s shape, read from a forward run of the port).
    Returns (jax fetches, port fetches, fetch names, jax main, port
    main): every output, then ``<name>@GRAD`` of each name in ``diff``."""
    fetch = [n for names in outputs.values() for n in names]
    loss_w = None
    if diff:
        loss_of = loss_of or fetch[0]
        main = one_op_program(PORT, op_type, inputs, outputs, attrs)
        shape = np.shape(value_of(run_once(
            PORT, main, feed_of(PORT, inputs), [loss_of])[0]))
        loss_w = np.asarray(np.random.RandomState(seed).randn(*shape),
                            np.float32)
        fetch = fetch + [n + "@GRAD" for n in diff]
    got, mains = {}, {}
    for pkg in PKGS:
        mains[pkg.name] = one_op_program(pkg, op_type, inputs, outputs,
                                         attrs, diff, loss_of, loss_w)
        got[pkg.name] = run_once(pkg, mains[pkg.name],
                                 feed_of(pkg, inputs, loss_w), fetch)
    return got["jax"], got["port"], fetch, mains["jax"], mains["port"]


def value_of(v):
    """The array of a fetch (a LoDTensor's data)."""
    return np.asarray(v.numpy()) if hasattr(v, "lod") and \
        hasattr(v, "numpy") and not isinstance(v, np.ndarray) \
        else np.asarray(v)


def lod_of(v):
    """A fetch's LoD (None for a plain array)."""
    return v.lod() if hasattr(v, "lod") and not isinstance(v, np.ndarray) \
        else None
