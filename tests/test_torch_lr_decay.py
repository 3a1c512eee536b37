"""Learning-rate schedules (``learning_rate_decay.py``) of the port
against the JAX package's and their closed forms, on the CPU: the five
schedules (with ``staircase``, ``cycle`` and ``power`` other than 1)
fetched over 12 steps, two schedules sharing one counter and one
``increment``, an optimizer consuming a schedule, a compiled run
(``use_jit=True``) against an eager one, a preempted and resumed
Trainer continuing the LR sequence, and a JAX-written checkpoint of a
scheduled Adagrad program resumed in the port.

Tolerances: LRs within 1e-6 relative of the JAX package's and of the
closed form in float64; piecewise values exactly at each step, the
boundaries included; losses within 1e-5 relative.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import checkpoint as jckpt  # noqa: E402
from paddle_tpu_torch import checkpoint as tckpt  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.core.scope import (global_scope,  # noqa: E402
                                         scope_guard, scope_to_numpy)
from paddle_tpu_torch.trainer import EndIteration, Trainer  # noqa: E402
from torch_optim import (JAX, LOSS_TOL, LR_TOL, PORT,  # noqa: E402
                         STATE_TOL, build, jax_run, jax_startup_state,
                         loss_rel, lr_rel, op_types, port_run,
                         regression_feeds, rel)

STEPS = 12
COUNTER = "@LR_DECAY_COUNTER@"


def _closed(kind, kw, s):
    """The schedule's value at step ``s`` (the counter's first value is
    0), in float64."""
    lr = kw.get("learning_rate")
    if kind == "piecewise_decay":
        return kw["values"][sum(1 for b in kw["boundaries"] if b <= s)]
    ds = float(kw.get("decay_steps", 1))
    if kind == "polynomial_decay":
        end, power = kw.get("end_learning_rate", 1e-4), kw.get("power", 1.0)
        if kw.get("cycle"):
            ds = ds * max(math.ceil(s / ds), 1.0)
            step = s
        else:
            step = min(s, ds)
        frac = 1.0 - step / ds
        if power != 1.0:
            # the schedule's clip before its log
            frac = min(max(frac, 1e-12), 1.0)
        return (lr - end) * frac ** power + end
    div = s / ds
    if kw.get("staircase"):
        div = math.floor(div)
    rate = kw["decay_rate"]
    if kind == "exponential_decay":
        return lr * rate ** div
    if kind == "natural_exp_decay":
        return lr * math.exp(-rate * div)
    return lr / (1.0 + rate * div)  # inverse_time_decay


SCHEDULES = [
    ("exponential_decay", dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5)),
    ("exponential_decay", dict(learning_rate=0.1, decay_steps=3,
                               decay_rate=0.5, staircase=True)),
    ("natural_exp_decay", dict(learning_rate=0.2, decay_steps=4,
                               decay_rate=0.7)),
    ("natural_exp_decay", dict(learning_rate=0.2, decay_steps=4,
                               decay_rate=0.7, staircase=True)),
    ("inverse_time_decay", dict(learning_rate=0.3, decay_steps=2,
                                decay_rate=0.9)),
    ("inverse_time_decay", dict(learning_rate=0.3, decay_steps=2,
                                decay_rate=0.9, staircase=True)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=8,
                              end_learning_rate=0.01)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=8,
                              end_learning_rate=0.01, power=2.0)),
    ("polynomial_decay", dict(learning_rate=0.1, decay_steps=5,
                              end_learning_rate=0.01, power=0.5,
                              cycle=True)),
    ("piecewise_decay", dict(boundaries=[2, 5, 9],
                             values=[0.1, 0.05, 0.01, 0.001])),
]
SCHEDULE_IDS = ["exponential", "exponential_staircase", "natural_exp",
                "natural_exp_staircase", "inverse_time",
                "inverse_time_staircase", "polynomial", "polynomial_power2",
                "polynomial_cycle_power_half", "piecewise"]


def _schedule_program(kind, kw):
    def fn(pkg):
        return getattr(pkg.lrd, kind)(**kw)
    return fn


def _lrs(pkg, main, lr, steps=STEPS, use_jit=True):
    """The LR fetched at each of ``steps`` runs, from the startup."""
    if pkg is JAX:
        scope = jpt.Scope()
        exe = jpt.Executor(jpt.CPUPlace())
        with jpt.scope_guard(scope):
            exe.run(main[1])
            return [np.asarray(exe.run(main[0], fetch_list=[lr])[0])
                    for _ in range(steps)]
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(main[1], scope=scope)
    out = [exe.run(main[0], fetch_list=[lr], scope=scope,
                   use_jit=use_jit)[0] for _ in range(steps)]
    return out, exe, scope


@pytest.mark.parametrize("kind,kw", SCHEDULES, ids=SCHEDULE_IDS)
def test_schedule_matches_jax_and_its_closed_form(kind, kw):
    jmain, jstart, jlr = build(JAX, _schedule_program(kind, kw))
    tmain, tstart, tlr = build(PORT, _schedule_program(kind, kw))
    assert op_types(tmain) == op_types(jmain)
    assert op_types(tmain).count("increment") == 1
    want = _lrs(JAX, (jmain, jstart), jlr.name)
    got, exe, scope = _lrs(PORT, (tmain, tstart), tlr.name)
    closed = [_closed(kind, kw, s) for s in range(STEPS)]
    got_v = [float(g.reshape(-1)[0]) for g in got]
    assert lr_rel(got_v, [float(w.reshape(-1)[0]) for w in want]) <= LR_TOL
    assert lr_rel(got_v, closed) <= LR_TOL
    if kind == "piecewise_decay":
        # exact at every step, the boundaries included: the port holds
        # the table in its own dtype (float64, as declared), JAX in float32
        assert got_v == closed
        assert [float(w.reshape(-1)[0]) for w in want] == \
            [float(np.float32(c)) for c in closed]
    if kw.get("staircase"):
        # constant within a stair, changed across it
        ds = kw["decay_steps"]
        for s in range(1, STEPS):
            same = (s // ds) == ((s - 1) // ds)
            assert (got_v[s] == got_v[s - 1]) == same, s
    counter = scope.find_var(COUNTER)
    assert counter.dtype == torch.int64 and counter.tolist() == [STEPS - 1]
    assert exe.stats["eager_runs"] == 0


def test_two_schedules_share_one_counter_and_one_increment():
    def fn(pkg):
        a = pkg.lrd.exponential_decay(0.1, decay_steps=2, decay_rate=0.5)
        b = pkg.lrd.piecewise_decay([3], [1.0, 2.0])
        return a, b
    jmain, jstart, (ja, jb) = build(JAX, fn)
    tmain, tstart, (ta, tb) = build(PORT, fn)
    assert op_types(tmain) == op_types(jmain)
    assert op_types(tmain).count("increment") == 1
    counters = [v for v in tmain.list_vars() if v.name == COUNTER]
    assert len(counters) == 1 and counters[0].persistable
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(tstart, scope=scope)
    for s in range(6):
        a, b = exe.run(tmain, fetch_list=[ta, tb], scope=scope)
        assert abs(float(a[0]) - 0.1 * 0.5 ** (s / 2)) <= 1e-7
        assert float(b[0]) == (1.0 if s < 3 else 2.0)


def _scheduled_regression(make_opt, schedule):
    def fn(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[4])
        y = L.data(name="y", shape=[1])
        loss = L.mean(L.square_error_cost(L.fc(input=x, size=1), y))
        lr = schedule(pkg)
        make_opt(pkg, lr).minimize(loss)
        return loss, lr, [x, y]
    return fn


def _sgd_exp(pkg, lr):
    return pkg.optimizer.SGD(learning_rate=lr)


def _exp(pkg):
    return pkg.lrd.exponential_decay(0.1, decay_steps=3, decay_rate=0.6)


def test_an_optimizer_consumes_a_schedule_like_jax():
    fn = _scheduled_regression(_sgd_exp, _exp)
    jmain, jstart, (jl, jlr, _) = build(JAX, fn)
    tmain, _, (tl, tlr, _) = build(PORT, fn)
    assert op_types(tmain) == op_types(jmain)
    state = jax_startup_state(jmain, jstart)
    feeds = regression_feeds(STEPS, seed=5)
    jouts, jfinal, _ = jax_run(jmain, state, feeds, [jl.name, jlr.name])
    touts, tfinal, _, _ = port_run(tmain, state, feeds, [tl.name, tlr.name])
    assert loss_rel([o[0] for o in touts], [o[0] for o in jouts]) <= LOSS_TOL
    assert lr_rel([o[1] for o in touts], [o[1] for o in jouts]) <= LR_TOL
    for n, w in jfinal.items():
        assert rel(tfinal[n], w) <= STATE_TOL, n


def test_compiled_run_equals_eager_run():
    """The LR of a compiled run is computed on the device every step
    (no value of step 1 baked in): losses, LRs and state bit-identical to
    the per-op path, the counter int64, no fallback."""
    fn = _scheduled_regression(
        lambda pkg, lr: pkg.optimizer.Adam(learning_rate=lr),
        lambda pkg: pkg.lrd.polynomial_decay(0.05, decay_steps=6,
                                             end_learning_rate=0.005,
                                             power=2.0))
    jmain, jstart, _ = build(JAX, fn)
    tmain, tstart, (tl, tlr, _) = build(PORT, fn)
    state = jax_startup_state(jmain, jstart)
    state.pop(COUNTER)  # int32 in JAX: the port's own startup's int64
    feeds = regression_feeds(8, seed=6)
    runs = {}
    for use_jit in (True, False):
        exe, scope = TExecutor("cpu"), TScope()
        exe.run(tstart, scope=scope)
        outs, final, scope, exe = port_run(tmain, state, feeds,
                                           [tl.name, tlr.name],
                                           use_jit=use_jit, exe=exe,
                                           scope=scope)
        runs[use_jit] = (outs, final, scope, exe)
    (c_outs, c_final, c_scope, c_exe), (e_outs, e_final, _, _) = \
        runs[True], runs[False]
    for c, e in zip(c_outs, e_outs):
        assert np.array_equal(c[0], e[0]) and np.array_equal(c[1], e[1])
    assert all(np.array_equal(c_final[n], e_final[n]) for n in e_final)
    lrs = [float(o[1][0]) for o in c_outs]
    assert lr_rel(lrs, [_closed("polynomial_decay", dict(
        learning_rate=0.05, decay_steps=6, end_learning_rate=0.005,
        power=2.0), s) for s in range(8)]) <= LR_TOL
    assert len(set(lrs)) == 7  # it changes until it stops at step 6
    assert c_scope.find_var(COUNTER).dtype == torch.int64
    assert c_exe.stats["eager_runs"] == 0
    assert c_exe.stats["jit_runs"] == 1 + len(feeds)




# -- resume ---------------------------------------------------------------------

def _adagrad_piecewise(pkg, lr):
    return pkg.optimizer.Adagrad(learning_rate=lr)


def _piecewise(pkg):
    return pkg.lrd.piecewise_decay([3, 6], [0.3, 0.1, 0.03])


def _trainer(ckpt):
    """A Trainer of the regression program under Adagrad on a piecewise
    schedule, fetching the LR."""
    main, start = PORT.Program(), PORT.Program()
    with PORT.unique_name.guard(), PORT.program_guard(main, start):
        L = PORT.layers
        x = L.data(name="x", shape=[4])
        y = L.data(name="y", shape=[1])
        loss = L.mean(L.square_error_cost(L.fc(input=x, size=1), y))
        lr, feed_list = _piecewise(PORT), [x, y]
        opt = PORT.optimizer.Adagrad(learning_rate=lr)
        tr = Trainer(loss, opt, feed_list, device="cpu", fetch_list=[lr],
                     main_program=main, startup_program=start,
                     checkpoint_dir=ckpt)
    return tr


def _batches(n):
    out = []
    for f in regression_feeds(n, seed=7):
        out.append(list(zip(f["x"], f["y"])))
    return out


def _train(ckpt, batches, preempt_at=None):
    with scope_guard(TScope()):
        tr = _trainer(ckpt)
        losses, lrs = [], []

        def handler(e):
            if isinstance(e, EndIteration):
                losses.append(e.cost)
                lrs.append(float(np.asarray(
                    e.metrics["fetches"][0]).reshape(-1)[0]))
                if e.batch_id == preempt_at:
                    tr.request_preempt()

        tr.train(lambda: iter(list(batches)), num_passes=1,
                 event_handler=handler, pipeline=False)
        return losses, lrs, scope_to_numpy(global_scope()), tr


def test_preempted_and_resumed_trainer_continues_the_lr_sequence(tmp_path):
    batches = _batches(9)
    full_l, full_lr, full_state, _ = _train(None, batches)
    assert full_lr == [0.3] * 3 + [0.1] * 3 + [0.03] * 3
    ck = str(tmp_path / "ck")
    first_l, first_lr, _, tr = _train(ck, batches, preempt_at=3)
    assert tr.preempted and len(first_l) == 4
    rest_l, rest_lr, rest_state, _ = _train(ck, batches[4:])
    assert first_lr + rest_lr == full_lr
    assert first_l + rest_l == full_l
    for n, v in full_state.items():
        assert np.array_equal(rest_state[n], v), n
    assert rest_state[COUNTER].dtype == np.int64
    assert rest_state[COUNTER].tolist() == [8]


def test_jax_checkpoint_of_a_scheduled_adagrad_program_resumes_in_the_port(
        tmp_path):
    """The JAX package trains 4 steps of a piecewise-scheduled Adagrad
    program and saves a checkpoint (the counter and every accumulator
    are persistables); the port loads it and trains 5 more, as the JAX
    package does from the same checkpoint: the LRs continue from step 4
    and the losses and state agree."""
    fn = _scheduled_regression(_adagrad_piecewise, _piecewise)
    jmain, jstart, (jl, jlr, _) = build(JAX, fn)
    tmain, tstart, (tl, tlr, _) = build(PORT, fn)
    feeds = regression_feeds(9, seed=8)
    jscope = jpt.Scope()
    jexe = jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(jscope):
        jexe.run(jstart)
        for f in feeds[:4]:
            jexe.run(jmain, feed=f, fetch_list=[jl])
        d = str(tmp_path / "root")
        jckpt.save_checkpoint(d, jmain, scope=jscope, step=4, keep_last=2)
        jrest = [[np.asarray(v) for v in jexe.run(
            jmain, feed=f, fetch_list=[jl, jlr])] for f in feeds[4:]]
        jfinal = {v.name: np.asarray(jscope.find_var(v.name))
                  for v in jmain.list_vars() if v.persistable}
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(tstart, scope=scope)
    _, step = tckpt.load_latest(d, tmain, scope=scope, device="cpu")
    assert step == 4
    trest = [exe.run(tmain, feed=f, fetch_list=[tl, tlr], scope=scope)
             for f in feeds[4:]]
    lrs = [float(o[1].reshape(-1)[0]) for o in trest]
    assert lrs == [0.1, 0.1, 0.03, 0.03, 0.03]
    assert lr_rel(lrs, [float(o[1].reshape(-1)[0]) for o in jrest]) <= LR_TOL
    assert loss_rel([o[0] for o in trest], [o[0] for o in jrest]) <= LOSS_TOL
    tfinal = scope_to_numpy(scope, names=jfinal)
    for n, w in jfinal.items():
        assert rel(tfinal[n], w) <= STATE_TOL, n
    assert os.path.isdir(d)
