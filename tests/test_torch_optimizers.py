"""The optimizers of the port against the JAX package's, on the CPU:
each of the 11 update ops against its JAX lowering on seeded inputs
(Nesterov momentum, RMSProp with momentum, Ftrl at lr_power -0.5 and
-0.3 and with l1 > 0, the proximal ops with l1 and l2, each op's own
attr defaults), each of the 9 optimizer classes training
``tests/test_core.py:124``'s regression program for 10 steps from the
JAX startup state (losses and every accumulator), and ``ModelAverage``
(update, apply, restore).

Tolerances: op outputs within 1e-6 of max(1, |ref|); losses within 1e-5
relative; persistables within 1e-5 of max(1, the largest magnitude).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.core.scope import scope_from_numpy  # noqa: E402
from torch_optim import (JAX, LOSS_TOL, OP_TOL, PORT, STATE_TOL,  # noqa: E402
                         build, jax_run, jax_startup_state,
                         linear_regression, loss_rel, op_types, port_run,
                         regression_feeds, rel)

SHAPE = (4, 6)


def _update_program(op_type, inputs, outputs, attrs):
    """One update op over fed vars; each output under a name of its own
    (``<slot>_out``) so that the fetch reads the new value."""
    def build_fn(pkg):
        L = pkg.layers
        vars_ = {}
        for slot, (name, shape, dtype) in inputs.items():
            vars_[slot] = L.data(name=name, shape=list(shape),
                                 append_batch_size=False, dtype=dtype)
        block = vars_["Param"].block
        outs = {}
        for slot in outputs:
            outs[slot] = block.create_var(name=slot + "_out", shape=SHAPE,
                                          dtype="float32")
        block.append_op(type=op_type,
                        inputs={s: [v] for s, v in vars_.items()},
                        outputs={s: [v] for s, v in outs.items()},
                        attrs=dict(attrs))
        return [v.name for v in outs.values()]
    return build_fn


# the ops whose Moment is a sum of squares (non-negative)
SQUARE_MOMENT = ("adagrad", "decayed_adagrad", "proximal_adagrad")


def _update_inputs(seed, slots, op_type=""):
    rng = np.random.RandomState(seed)
    feed, spec = {}, {}
    for slot in slots:
        if slot in ("LearningRate", "Beta1Pow", "Beta2Pow"):
            val = {"LearningRate": [0.05], "Beta1Pow": [0.9 ** 3],
                   "Beta2Pow": [0.999 ** 3]}[slot]
            a = np.asarray(val, np.float32)
        elif slot in ("Param", "Grad", "Velocity", "Moment1",
                      "LinearAccumulator") or (
                          slot == "Moment" and op_type not in SQUARE_MOMENT):
            a = rng.randn(*SHAPE).astype(np.float32)
        else:  # squares: non-negative
            a = (rng.rand(*SHAPE) * 0.5).astype(np.float32)
        name = slot.lower()
        feed[name] = a
        spec[slot] = (name, a.shape, "float32")
    return feed, spec


UPDATES = [
    ("sgd", ["Param", "Grad", "LearningRate"], ["ParamOut"], {}),
    ("momentum", ["Param", "Grad", "Velocity", "LearningRate"],
     ["ParamOut", "VelocityOut"], {"mu": 0.9}),
    ("momentum", ["Param", "Grad", "Velocity", "LearningRate"],
     ["ParamOut", "VelocityOut"], {"mu": 0.9, "use_nesterov": True}),
    ("adam", ["Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow",
              "LearningRate"], ["ParamOut", "Moment1Out", "Moment2Out"],
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adam", ["Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow",
              "LearningRate"], ["ParamOut", "Moment1Out", "Moment2Out"],
     {"lazy_mode": True}),
    ("adamax", ["Param", "Grad", "Moment", "InfNorm", "Beta1Pow",
                "LearningRate"], ["ParamOut", "MomentOut", "InfNormOut"],
     {}),
    ("adagrad", ["Param", "Grad", "Moment", "LearningRate"],
     ["ParamOut", "MomentOut"], {}),
    ("decayed_adagrad", ["Param", "Grad", "Moment", "LearningRate"],
     ["ParamOut", "MomentOut"], {"decay": 0.9}),
    ("adadelta", ["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
     ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"], {}),
    ("rmsprop", ["Param", "Grad", "Moment", "MeanSquare", "LearningRate"],
     ["ParamOut", "MomentOut", "MeanSquareOut"], {}),
    ("rmsprop", ["Param", "Grad", "Moment", "MeanSquare", "LearningRate"],
     ["ParamOut", "MomentOut", "MeanSquareOut"],
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.9}),
    ("ftrl", ["Param", "Grad", "SquaredAccumulator", "LinearAccumulator",
              "LearningRate"], ["ParamOut", "SquaredAccumOut",
                                "LinearAccumOut"], {}),
    ("ftrl", ["Param", "Grad", "SquaredAccumulator", "LinearAccumulator",
              "LearningRate"], ["ParamOut", "SquaredAccumOut",
                                "LinearAccumOut"],
     {"l1": 0.1, "l2": 0.01, "lr_power": -0.5}),
    ("ftrl", ["Param", "Grad", "SquaredAccumulator", "LinearAccumulator",
              "LearningRate"], ["ParamOut", "SquaredAccumOut",
                                "LinearAccumOut"],
     {"l1": 0.1, "l2": 0.01, "lr_power": -0.3}),
    ("proximal_gd", ["Param", "Grad", "LearningRate"], ["ParamOut"],
     {"l1": 0.5, "l2": 0.1}),
    ("proximal_adagrad", ["Param", "Grad", "Moment", "LearningRate"],
     ["ParamOut", "MomentOut"], {"l1": 0.3, "l2": 0.2}),
]
UPDATE_IDS = ["sgd", "momentum", "momentum_nesterov", "adam",
              "adam_lazy_mode_dense", "adamax", "adagrad", "decayed_adagrad",
              "adadelta", "rmsprop_op_defaults", "rmsprop_momentum",
              "ftrl_defaults", "ftrl_l1_l2", "ftrl_lr_power_0.3",
              "proximal_gd_l1_l2", "proximal_adagrad_l1_l2"]


@pytest.mark.parametrize("op_type,slots,outs,attrs", UPDATES,
                         ids=UPDATE_IDS)
def test_update_op_matches_its_jax_lowering(op_type, slots, outs, attrs):
    feed, spec = _update_inputs(len(op_type) + len(attrs), slots, op_type)
    fn = _update_program(op_type, spec, outs, attrs)
    jmain, _, fetch = build(JAX, fn)
    tmain, _, _ = build(PORT, fn)
    want = jax_run(jmain, {}, [feed], fetch)[0][0]
    got = port_run(tmain, {}, [feed], fetch)[0][0]
    for name, g, w in zip(fetch, got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        assert rel(g, w) <= OP_TOL, (name, rel(g, w))
    if op_type == "sgd":
        np.testing.assert_allclose(
            got[0], feed["param"] - 0.05 * feed["grad"], rtol=0, atol=1e-7)


def test_every_update_op_of_the_jax_package_is_registered():
    from paddle_tpu_torch.core import registry
    for op in ("sgd", "momentum", "adam", "adamax", "adagrad",
               "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
               "proximal_gd", "proximal_adagrad"):
        d = registry.lookup(op)
        assert d is not None and d.no_gradient, op
        assert "ParamOut" in d.stateful_outputs, op


# -- the nine optimizer classes ----------------------------------------------

OPTIMIZERS = [
    ("sgd", lambda o: o.SGD(learning_rate=0.05)),
    ("momentum", lambda o: o.Momentum(learning_rate=0.02, momentum=0.9)),
    ("momentum_nesterov", lambda o: o.Momentum(
        learning_rate=0.02, momentum=0.9, use_nesterov=True)),
    ("adagrad", lambda o: o.Adagrad(learning_rate=0.1)),
    ("adam", lambda o: o.Adam(learning_rate=0.05)),
    ("adamax", lambda o: o.Adamax(learning_rate=0.05)),
    ("decayed_adagrad", lambda o: o.DecayedAdagrad(learning_rate=0.05)),
    ("adadelta", lambda o: o.Adadelta(learning_rate=1.0)),
    ("rmsprop", lambda o: o.RMSProp(learning_rate=0.01)),
    ("rmsprop_momentum", lambda o: o.RMSProp(learning_rate=0.005,
                                             momentum=0.9)),
    ("ftrl", lambda o: o.Ftrl(learning_rate=0.1, l1=1e-3, l2=1e-3)),
    ("ftrl_lr_power_0.3", lambda o: o.Ftrl(learning_rate=0.1, l1=1e-3,
                                           lr_power=-0.3)),
]
STEPS = 10


def _train_both(make, steps=STEPS, feeds=None):
    jmain, jstart, jloss = build(
        JAX, lambda pkg: linear_regression(pkg, lambda p: make(p.optimizer)))
    tmain, _, tloss = build(
        PORT, lambda pkg: linear_regression(pkg, lambda p: make(p.optimizer)))
    assert op_types(tmain) == op_types(jmain)
    state = jax_startup_state(jmain, jstart)
    feeds = feeds or regression_feeds(steps)
    jouts, jfinal, _ = jax_run(jmain, state, feeds, [jloss.name])
    touts, tfinal, _, exe = port_run(tmain, state, feeds, [tloss.name])
    return ([float(o[0].reshape(-1)[0]) for o in jouts],
            [float(o[0].reshape(-1)[0]) for o in touts], jfinal, tfinal,
            exe, tmain)


@pytest.mark.parametrize("name,make", OPTIMIZERS,
                         ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_trains_like_jax(name, make):
    jl, tl, jfinal, tfinal, exe, tmain = _train_both(make)
    assert loss_rel(tl, jl) <= LOSS_TOL, (tl, jl)
    assert tl[-1] < tl[0], tl
    assert set(tfinal) == set(jfinal) and len(jfinal) >= 3
    for n, w in jfinal.items():
        assert rel(tfinal[n], w) <= STATE_TOL, (n, rel(tfinal[n], w))
    # the compiled step: one warm-up, then a capture stand-in a step
    assert exe.stats["eager_runs"] == 0 and exe.stats["jit_runs"] == STEPS


def test_every_short_alias_is_its_class():
    from paddle_tpu_torch import optimizer as topt
    for alias in ("SGD", "Momentum", "Adagrad", "Adam", "Adamax",
                  "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl"):
        assert getattr(topt, alias) is getattr(topt, alias + "Optimizer")
    # accepted and ignored, as in the JAX package
    topt.SGD(0.1, LARS_weight_decay=0.5)


def test_adam_passes_lazy_mode_and_computes_the_dense_update():
    def make(lazy):
        return lambda opt: opt.Adam(learning_rate=0.05, lazy_mode=lazy)
    _, plain, _, _, _, _ = _train_both(make(False), steps=4)
    jl, tl, _, _, _, tmain = _train_both(make(True), steps=4)
    adam_ops = [op for op in tmain.global_block().ops if op.type == "adam"]
    assert adam_ops and all(op.attr("lazy_mode") for op in adam_ops)
    assert tl == plain
    assert loss_rel(tl, jl) <= LOSS_TOL


def test_rmsprop_op_keeps_its_own_defaults():
    """The op's defaults (decay 0.9, epsilon 1e-10) are not the class's
    (0.95, 1e-6): an op with no attrs computes the former."""
    feed, spec = _update_inputs(5, ["Param", "Grad", "Moment", "MeanSquare",
                                    "LearningRate"])
    outs = ["ParamOut", "MomentOut", "MeanSquareOut"]
    tmain, _, fetch = build(PORT, _update_program("rmsprop", spec, outs, {}))
    got = port_run(tmain, {}, [feed], fetch)[0][0]
    g = feed["grad"].astype(np.float64)
    ms = 0.9 * feed["meansquare"] + 0.1 * g * g
    np.testing.assert_allclose(got[2], ms, rtol=1e-6)
    mom = feed["moment"] * 0.0 + 0.05 * g / np.sqrt(ms + 1e-10)
    np.testing.assert_allclose(got[1], mom, rtol=1e-5)


# -- ModelAverage ----------------------------------------------------------------

def test_model_average_matches_jax():
    """Train 4 steps calling ``update()`` after each, ``apply()``,
    evaluate, ``restore()``, train 2 more: the averaged parameters, the
    restored ones and every loss agree with the JAX package's."""
    make = lambda o: o.SGD(learning_rate=0.05)  # noqa: E731
    jmain, jstart, jloss = build(
        JAX, lambda pkg: linear_regression(pkg, lambda p: make(p.optimizer)))
    tmain, _, tloss = build(
        PORT, lambda pkg: linear_regression(pkg, lambda p: make(p.optimizer)))
    state = jax_startup_state(jmain, jstart)
    feeds = regression_feeds(6, seed=3)
    params = sorted(p.name for p in jmain.all_parameters())

    jscope = jpt.Scope()
    jexe = jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(jscope):
        for n, v in state.items():
            jscope.set_var(n, v)
        javg = JAX.optimizer.ModelAverage(min_average_window=2,
                                          max_average_window=3,
                                          program=jmain, scope=jscope)
        jl = []
        for f in feeds[:4]:
            jl.append(np.asarray(jexe.run(jmain, feed=f,
                                          fetch_list=[jloss])[0]))
            javg.update()
        javg.apply()
        japplied = {n: np.asarray(jscope.find_var(n)) for n in params}
        javg.restore()
        jrestored = {n: np.asarray(jscope.find_var(n)) for n in params}
        for f in feeds[4:]:
            jl.append(np.asarray(jexe.run(jmain, feed=f,
                                          fetch_list=[jloss])[0]))

    texe, tscope = TExecutor("cpu"), TScope()
    scope_from_numpy(state, device="cpu", scope=tscope)
    tavg = PORT.optimizer.ModelAverage(min_average_window=2,
                                       max_average_window=3, program=tmain,
                                       scope=tscope)
    tl = []
    for f in feeds[:4]:
        tl.append(texe.run(tmain, feed=f, fetch_list=[tloss],
                           scope=tscope)[0])
        tavg.update()
    trained = {n: tscope.find_var(n).clone() for n in params}
    tavg.apply()
    tapplied = {n: tscope.find_var(n).numpy().copy() for n in params}
    tavg.apply()  # a second apply keeps the first backup
    tavg.restore()
    for n in params:
        assert torch.equal(tscope.find_var(n), trained[n]), n
    for f in feeds[4:]:
        tl.append(texe.run(tmain, feed=f, fetch_list=[tloss],
                           scope=tscope)[0])
    for n in params:
        assert rel(tapplied[n], japplied[n]) <= OP_TOL, n
        assert rel(trained[n].numpy(), jrestored[n]) <= STATE_TOL, n
        assert not np.array_equal(tapplied[n], trained[n].numpy()), n
    assert loss_rel(np.concatenate(tl), np.concatenate(jl)) <= LOSS_TOL
