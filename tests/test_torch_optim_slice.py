"""The optimization slice end to end on the CPU, against the JAX
package: the book configs with the training recipes this slice makes
possible, built alike in both packages (``tests/torch_book.py``) and
trained from the JAX startup state:

- ``tiny_lm``: Adam on a ``polynomial_decay`` schedule,
  ``GradientClipByGlobalNorm(1.0)`` on every parameter and
  ``L2Decay(0.01)`` on the optimizer;
- ``resnet_cifar`` (a ResNet-8): Momentum 0.9 on a ``piecewise_decay``
  schedule with ``L2Decay(1e-4)``;
- ``text_rnn`` (the LSTM classifier at small widths, the recurrence on
  its scan path in both, and on the port's fused route against the JAX
  Pallas LSTM in interpret mode): Adagrad with
  ``GradientClipByNorm(5.0)``.

Each: the op types in order equal the JAX package's, the losses within
1e-5 relative at every step and the persistables (parameters,
accumulators, the step counter) within 1e-5 of max(1, the largest
magnitude) after the last. With no clip and no regularizer each book
config's program is op for op the JAX package's, as it was before the
slice.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_book as book  # noqa: E402
from torch_optim import (JAX, LOSS_TOL, PORT, STATE_TOL,  # noqa: E402
                         loss_rel, op_types, rel)

STEPS = 4


def _lm_recipe(pkg, spec):
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0))
    lr = pkg.lrd.polynomial_decay(0.01, decay_steps=3,
                                  end_learning_rate=0.001)
    return pkg.optimizer.Adam(learning_rate=lr,
                              regularization=pkg.regularizer.L2Decay(0.01))


def _resnet_recipe(pkg, spec):
    lr = pkg.lrd.piecewise_decay(boundaries=[1, 3],
                                 values=[0.05, 0.01, 0.002])
    return pkg.optimizer.Momentum(
        learning_rate=lr, momentum=0.9,
        regularization=pkg.regularizer.L2Decay(1e-4))


def _rnn_recipe(pkg, spec):
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByNorm(5.0))
    return pkg.optimizer.Adagrad(learning_rate=0.05)


RECIPES = {"tiny_lm": _lm_recipe, "resnet_cifar": _resnet_recipe,
           "text_rnn": _rnn_recipe}


def _build(pkg, kind, recipe):
    """(main, startup, spec) of ``kind`` minimized under ``recipe``."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        spec = (book._jax_spec if pkg is JAX else book._port_spec)(kind)
        opt = recipe(pkg, spec) if recipe else spec["optimizer"]
        opt.minimize(spec["cost"])
    return main, start, spec


@pytest.mark.parametrize("kind", sorted(RECIPES))
def test_book_config_trains_with_its_recipe_like_jax(kind):
    jmain, jstart, jspec = _build(JAX, kind, RECIPES[kind])
    tmain, _, tspec = _build(PORT, kind, RECIPES[kind])
    assert op_types(tmain) == op_types(jmain)
    state = book.jax_startup_state(jmain, jstart)
    assert "@LR_DECAY_COUNTER@" in state or kind == "text_rnn"
    jouts, jfinal = book.jax_run(jmain, state, book.feeds(kind, "jax", STEPS),
                                 [jspec["cost"].name])
    touts, tfinal = book.port_run(tmain, state,
                                  book.feeds(kind, "port", STEPS),
                                  [tspec["cost"].name])
    jl = [float(o[0].reshape(-1)[0]) for o in jouts]
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert loss_rel(tl, jl) <= LOSS_TOL, (tl, jl)
    assert set(tfinal) == set(jfinal)
    for n, w in jfinal.items():
        assert rel(tfinal[n], w) <= STATE_TOL, (n, rel(tfinal[n], w))


def test_text_rnn_recipe_on_the_fused_route_trains_like_jax():
    """The classifier's recipe with the port's fused LSTM route (its plain
    version on the CPU) against the JAX package's Pallas LSTM in
    interpret mode (``FLAGS.lstm_impl``, as
    ``tests/test_torch_text_rnn.py`` sets it)."""
    import paddle_tpu as jpt
    from paddle_tpu_torch.configs import text_rnn as trnn
    jmain, jstart, jspec = _build(JAX, "text_rnn", _rnn_recipe)
    main, start = PORT.Program(), PORT.Program()
    with PORT.unique_name.guard(), PORT.program_guard(main, start):
        tspec = trnn.model(lstm_impl="pallas", samples=4 * book.RNN["batch"],
                           seq_len=8, **book.RNN)
        _rnn_recipe(PORT, tspec).minimize(tspec["cost"])
    assert op_types(main) == op_types(jmain)
    state = book.jax_startup_state(jmain, jstart)
    with jpt.flags_guard(lstm_impl="pallas"):
        jouts, jfinal = book.jax_run(jmain, state,
                                     book.feeds("text_rnn", "jax", STEPS),
                                     [jspec["cost"].name])
    touts, tfinal = book.port_run(main, state,
                                  book.feeds("text_rnn", "port", STEPS),
                                  [tspec["cost"].name])
    jl = [float(o[0].reshape(-1)[0]) for o in jouts]
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert loss_rel(tl, jl) <= LOSS_TOL, (tl, jl)
    for n, w in jfinal.items():
        assert rel(tfinal[n], w) <= STATE_TOL, (n, rel(tfinal[n], w))


@pytest.mark.parametrize("kind", book.KINDS)
def test_without_clip_or_regularizer_a_config_is_op_for_op_the_jax_one(
        kind):
    jmain, _, _ = _build(JAX, kind, None)
    tmain, _, _ = _build(PORT, kind, None)
    assert [(op.type, sorted(op.inputs), sorted(op.outputs))
            for op in tmain.global_block().ops] == \
        [(op.type, sorted(op.inputs), sorted(op.outputs))
         for op in jmain.global_block().ops]
    types_ = op_types(tmain)
    for t in ("clip", "clip_by_norm", "squared_l2_norm", "sign",
              "increment"):
        assert t not in types_, (kind, t)


def test_lm_recipe_appends_one_norm_a_parameter_and_one_scale():
    jmain, _, _ = _build(JAX, "tiny_lm", _lm_recipe)
    tmain, _, _ = _build(PORT, "tiny_lm", _lm_recipe)
    n_params = len(tmain.all_parameters())
    types_ = op_types(tmain)
    assert types_.count("squared_l2_norm") == n_params
    # the clip's scale, and the schedule's step / decay_steps
    assert types_.count("elementwise_div") == 2
    assert types_.count("adam") == n_params
    assert types_.count("increment") == 1
    assert types_ == op_types(jmain)


# -- the float64 recomputation of chip_smoke.py's phase 14, on the CPU -----------

def _smoke():
    import importlib
    return importlib.import_module("chip_smoke")


def _port_lm(clip, decay, clip_norm):
    """The port's tiny_lm under phase 14's LM recipe, with the clip and
    the decay each optional: (main, startup, spec, LR var)."""
    smoke = _smoke()
    from paddle_tpu_torch.configs import tiny_lm

    def fn(pkg):
        spec = tiny_lm.model()
        if clip:
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(clip_norm))
        kind, kw = smoke.OPT_LM_SCHEDULE
        lr = getattr(pkg.lrd, kind)(**kw)
        reg = pkg.regularizer.L2Decay(smoke.OPT_LM_DECAY) if decay else None
        pkg.optimizer.Adam(learning_rate=lr, regularization=reg).minimize(
            spec["cost"])
        return spec, lr
    main, start, (spec, lr) = _build_port(fn)
    return main, start, spec, lr


def _build_port(fn):
    main, start = PORT.Program(), PORT.Program()
    with PORT.unique_name.guard(), PORT.program_guard(main, start):
        out = fn(PORT)
    return main, start, out


def _checked_steps(main, start, spec, lr, feeds, check, use_jit=False,
                   state=None):
    """Run ``feeds`` on the CPU from ``state`` (default the startup's),
    fetching the cost, the LR and every raw gradient; at each step of
    ``check`` the state before and after: {step: (before, grads, after,
    lr)} and the losses."""
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    smoke = _smoke()
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    for n, v in (state or {}).items():
        scope.set_var(n, v.clone())
    names = smoke._opt_state_names(main)
    head = [spec["cost"].name] + ([lr.name] if lr is not None else [])
    fetch = head + smoke._opt_grad_fetch(main)
    checks, losses = {}, []
    for step, feed in enumerate(feeds, 1):
        pre = smoke._clone_state(scope, names) if step in check else None
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                      use_jit=use_jit, return_numpy=False)
        losses.append(float(out[0].reshape(-1)[0]))
        if pre is not None:
            checks[step] = (pre, out[len(head):],
                            smoke._clone_state(scope, names),
                            float(out[1].reshape(-1)[0]) if lr is not None
                            else smoke.OPT_RNN_LR)
    return checks, losses, scope


def _lm_feeds(spec, n):
    b = next(iter(spec["reader"]()))
    feed = {"toks": np.stack([s[0] for s in b]),
            "tgt": np.stack([s[1] for s in b])}
    return [feed] * n


def test_lm_update_recomputation_holds_and_separates_clip_and_decay():
    """Phase 14's LM gate on the CPU at tiny widths: the float64
    recomputation (global norm, clip scale, L2 decay, Adam) holds the
    recipe's update within OPT_UPDATE_TOL at steps 1 and 2 with the clip
    binding, and misses the same program without the clip, and without
    the decay, by more than the tolerance: the check can tell them
    apart."""
    smoke = _smoke()
    clip_norm = 0.05
    main, start, spec, lr = _port_lm(True, True, clip_norm)
    feeds = _lm_feeds(spec, 2)
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    s0 = Scope()
    Executor("cpu").run(start, scope=s0)
    state = {n: s0.find_var(n) for n in s0.local_var_names()
             if isinstance(s0.find_var(n), torch.Tensor)}
    worst = {}
    for label, clip, decay in (("both", True, True), ("no_clip", False, True),
                               ("no_decay", True, False)):
        m, st, sp, l_ = _port_lm(clip, decay, clip_norm)
        checks, _, _ = _checked_steps(m, st, sp, l_, feeds, (1, 2),
                                      state=state)
        worst[label] = 0.0
        for step, (pre, grads, post, lr_v) in checks.items():
            errs, norm, scale = smoke.update_errors(
                m, pre, dict(zip([g[:-len("@GRAD")] for g in
                                  smoke._opt_grad_fetch(m)], grads)),
                post, lr_v, ("global_norm", clip_norm), smoke.OPT_LM_DECAY)
            worst[label] = max(worst[label], max(errs.values()))
            if label == "both" and step == 1:
                assert scale < 1.0, (norm, scale)  # the clip binds
    assert worst["both"] <= smoke.OPT_UPDATE_TOL, worst
    assert worst["no_clip"] > smoke.OPT_UPDATE_TOL, worst
    assert worst["no_decay"] > smoke.OPT_UPDATE_TOL, worst


@pytest.mark.parametrize("index", range(7))
def test_classifier_recipe_update_and_lr_hold_on_the_cpu(index):
    """Each of phase 14's classifier recipes at small widths: the update
    at the capture's run (step 2, compiled) within OPT_RNN_UPDATE_TOL of
    its float64 recomputation, every LR within OPT_LR_TOL of its closed
    form, the counter int64."""
    smoke = _smoke()
    label, opt_name, kw, schedule, clip = smoke.OPT_RNN_RECIPES[index]
    from paddle_tpu_torch.configs import text_rnn

    def fn(pkg):
        spec = text_rnn.model(cell="lstm", vocab=50, hidden=16, seq_len=6,
                              batch=4, samples=4)
        if clip is not None:
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByValue(clip[1]) if clip[0] == "value"
                else pkg.clip.GradientClipByNorm(clip[1]))
        lr = (getattr(pkg.lrd, schedule[0])(**schedule[1]) if schedule
              else smoke.OPT_RNN_LR)
        opt = getattr(pkg.optimizer, opt_name)(learning_rate=lr, **kw)
        opt.minimize(spec["cost"])
        return spec, opt._global_learning_rate()
    main, start, (spec, lr) = _build_port(fn)
    if opt_name == "Adadelta":
        lr = None  # its op reads no learning rate
    from paddle_tpu_torch.data_feeder import DataFeeder
    feed = DataFeeder(spec["feed_list"], device="cpu", program=main).feed(
        next(iter(spec["reader"]())))
    checks, losses, scope = _checked_steps(
        main, start, spec, lr, [feed] * smoke.OPT_RNN_STEPS,
        (smoke.OPT_RNN_CHECK_STEP,), use_jit=True)
    pre, grads, post, lr_v = checks[smoke.OPT_RNN_CHECK_STEP]
    names = [g[:-len("@GRAD")] for g in smoke._opt_grad_fetch(main)]
    errs, _, _ = smoke.update_errors(main, pre, dict(zip(names, grads)),
                                     post, lr_v, clip, None)
    assert max(errs.values()) <= smoke.OPT_RNN_UPDATE_TOL, errs
    assert np.all(np.isfinite(losses))
    want = (smoke.lr_closed_form(schedule[0], schedule[1],
                                 smoke.OPT_RNN_CHECK_STEP - 1)
            if schedule else smoke.OPT_RNN_LR)
    assert abs(lr_v - want) <= smoke.OPT_LR_TOL * want
    if schedule:
        assert scope.find_var("@LR_DECAY_COUNTER@").dtype == torch.int64


def test_resnet_recipe_update_and_pieces_hold_on_the_cpu():
    """Phase 14's ResNet-50 recipe (Momentum 0.9, L2 1e-4, the piecewise
    schedule) on a ResNet-8 at 16 x 16: the update at step 1 within
    OPT_UPDATE_TOL of its float64 recomputation and each piece exactly
    at its step."""
    smoke = _smoke()
    from paddle_tpu_torch.configs import resnet_cifar

    def fn(pkg):
        spec = resnet_cifar.model(samples=4, conv_impl="conv",
                                  variant="cifar", depth=8, image=16,
                                  class_dim=10, batch=4)
        kind, kw = smoke.OPT_R50_SCHEDULE
        lr = getattr(pkg.lrd, kind)(**kw)
        pkg.optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            regularization=pkg.regularizer.L2Decay(smoke.OPT_R50_DECAY)
        ).minimize(spec["cost"])
        return spec, lr
    main, start, (spec, lr) = _build_port(fn)
    from paddle_tpu_torch.data_feeder import DataFeeder
    feed = DataFeeder(spec["feed_list"], device="cpu", program=main).feed(
        next(iter(spec["reader"]())))
    checks, losses, scope = _checked_steps(main, start, spec, lr,
                                           [feed] * 5, (1,), use_jit=True)
    pre, grads, post, lr_v = checks[1]
    names = [g[:-len("@GRAD")] for g in smoke._opt_grad_fetch(main)]
    errs, _, _ = smoke.update_errors(main, pre, dict(zip(names, grads)),
                                     post, lr_v, None, smoke.OPT_R50_DECAY)
    assert max(errs.values()) <= smoke.OPT_UPDATE_TOL, errs
    kind, kw = smoke.OPT_R50_SCHEDULE
    assert lr_v == smoke.lr_closed_form(kind, kw, 0)
    assert np.all(np.isfinite(losses))
