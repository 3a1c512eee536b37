"""Shared by the optimization tests of the port (clipping, weight decay,
learning-rate schedules, the optimizers and their update ops): each
package's modules under one name, programs built alike in both under
each package's ``unique_name.guard()`` (so every variable has the same
name), and runs of a program in each package from one state (the JAX
startup's, carried into the port's scope).

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
from paddle_tpu.core import unique_name as jun
from paddle_tpu.core.backward import append_backward as jbackward
from paddle_tpu.param_attr import ParamAttr as JParamAttr
from paddle_tpu_torch import clip as tclip
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import learning_rate_decay as tlrd
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.core import ir as tir
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
