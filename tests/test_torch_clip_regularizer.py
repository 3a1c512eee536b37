"""Gradient clipping (``clip.py``) and weight decay (``regularizer.py``)
of the port against the JAX package's, on the CPU: ``GradientClipByValue``,
``GradientClipByNorm`` and ``GradientClipByGlobalNorm`` (one group and
two), ``set_gradient_clip`` with and without ``param_list``,
``ParamAttr(gradient_clip=...)``, L1 and L2 decay on a parameter and on
the optimizer (the parameter's wins). For each: the appended op types in
order equal the JAX package's, and 10 SGD or Adam steps of
``tests/test_core.py:124``'s regression program from the JAX startup
state agree (losses within 1e-5 relative, persistables within 1e-5 of
max(1, the largest magnitude)). Also: ``ParamAttr``'s regularizer and
clip reach the Parameter through every layer that makes one, as in the
JAX layers, and with neither set ``minimize`` appends what it did
before.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_optim import (JAX, LOSS_TOL, PKGS, PORT, STATE_TOL,  # noqa: E402
                         build, jax_run, jax_startup_state, loss_rel,
                         op_types, port_run, regression_feeds, rel)

STEPS = 10


def _program(recipe):
    """``recipe(pkg)`` -> (param_attr, bias_attr, clip setter or None,
    optimizer); the regression program minimized under it."""
    def fn(pkg):
        L = pkg.layers
        param_attr, bias_attr, set_clip, opt = recipe(pkg)
        x = L.data(name="x", shape=[4])
        y = L.data(name="y", shape=[1])
        pred = L.fc(input=x, size=1, param_attr=param_attr,
                    bias_attr=bias_attr)
        loss = L.mean(L.square_error_cost(pred, y))
        if set_clip is not None:
            set_clip()
        _, params_grads = opt.minimize(loss)
        return loss, [(p.name, g.name) for p, g in params_grads]
    return fn


def _train(recipe, steps=STEPS):
    jmain, jstart, (jloss, jpg) = build(JAX, _program(recipe))
    tmain, _, (tloss, tpg) = build(PORT, _program(recipe))
    assert op_types(tmain) == op_types(jmain)
    assert tpg == jpg
    state = jax_startup_state(jmain, jstart)
    feeds = regression_feeds(steps, seed=1)
    fetch = [jloss.name] + [g for _, g in jpg]
    jouts, jfinal, _ = jax_run(jmain, state, feeds, fetch)
    touts, tfinal, _, _ = port_run(tmain, state, feeds, fetch)
    jl = [float(o[0].reshape(-1)[0]) for o in jouts]
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert loss_rel(tl, jl) <= LOSS_TOL, (tl, jl)
    for n, w in jfinal.items():
        assert rel(tfinal[n], w) <= STATE_TOL, (n, rel(tfinal[n], w))
    # the clipped and decayed gradients the updates read, every step
    for jo, to in zip(jouts, touts):
        for name, w, g in zip(fetch[1:], jo[1:], to[1:]):
            assert rel(g, w) <= STATE_TOL, (name, rel(g, w))
    return tmain, jmain, touts


def _attrs(pkg, **kw):
    return pkg.ParamAttr(**kw)


RECIPES = {
    "by_value": lambda pkg: (
        None, None,
        lambda: pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByValue(0.05)),
        pkg.optimizer.SGD(learning_rate=0.1)),
    "by_value_min_max": lambda pkg: (
        None, None,
        lambda: pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByValue(0.2, min=-0.01)),
        pkg.optimizer.SGD(learning_rate=0.1)),
    "by_norm": lambda pkg: (
        None, None,
        lambda: pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByNorm(0.1)),
        pkg.optimizer.SGD(learning_rate=0.1)),
    "by_global_norm": lambda pkg: (
        None, None,
        lambda: pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByGlobalNorm(0.1)),
        pkg.optimizer.Adam(learning_rate=0.05)),
    "by_global_norm_two_groups": lambda pkg: (
        _attrs(pkg, gradient_clip=pkg.clip.GradientClipByGlobalNorm(
            0.05, group_name="weights")),
        _attrs(pkg, gradient_clip=pkg.clip.GradientClipByGlobalNorm(
            0.02, group_name="biases")),
        None, pkg.optimizer.SGD(learning_rate=0.1)),
    "set_clip_on_a_param_list": lambda pkg: (
        _attrs(pkg, name="w"), None,
        lambda: pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByValue(0.01), param_list=["w"]),
        pkg.optimizer.SGD(learning_rate=0.1)),
    "param_attr_clip": lambda pkg: (
        _attrs(pkg, gradient_clip=pkg.clip.GradientClipByNorm(0.05)), None,
        None, pkg.optimizer.SGD(learning_rate=0.1)),
    "l2_on_the_param": lambda pkg: (
        _attrs(pkg, regularizer=pkg.regularizer.L2Decay(0.5)), None, None,
        pkg.optimizer.SGD(learning_rate=0.1)),
    "l1_on_the_param": lambda pkg: (
        _attrs(pkg, regularizer=pkg.regularizer.L1Decay(0.2)), None, None,
        pkg.optimizer.SGD(learning_rate=0.1)),
    "l2_on_the_optimizer": lambda pkg: (
        None, None, None,
        pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                               regularization=pkg.regularizer.L2Decay(0.1))),
    "param_wins_over_the_optimizer": lambda pkg: (
        _attrs(pkg, regularizer=pkg.regularizer.L1Decay(0.3)), None, None,
        pkg.optimizer.SGD(learning_rate=0.1,
                          regularization=pkg.regularizer.L2Decay(0.1))),
    "clip_then_decay": lambda pkg: (
        _attrs(pkg, regularizer=pkg.regularizer.L2Decay(0.1)), None,
        lambda: pkg.clip.set_gradient_clip(
            pkg.clip.GradientClipByGlobalNorm(0.1)),
        pkg.optimizer.Adam(learning_rate=0.05)),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_appends_the_jax_ops_and_trains_like_jax(name):
    _train(RECIPES[name])


def _types_after_backward(main):
    """The op types appended after the backward pass."""
    types_ = op_types(main)
    last_grad = max(i for i, t in enumerate(types_) if t.endswith("_grad"))
    return types_[last_grad + 1:]


def test_clip_then_decay_then_update_in_order():
    tmain, jmain, _ = _train(RECIPES["clip_then_decay"], steps=2)
    tail = _types_after_backward(tmain)
    assert tail == _types_after_backward(jmain)
    assert tail == (["squared_l2_norm"] * 2
                    + ["sum", "sqrt", "fill_constant", "elementwise_max",
                       "elementwise_div"]
                    + ["elementwise_mul"] * 2
                    + ["scale", "sum"]          # L2 on the weight only
                    + ["adam"] * 2 + ["scale"] * 2)


def test_parameter_regularizer_wins_over_the_optimizers():
    tmain, _, _ = _train(RECIPES["param_wins_over_the_optimizer"], steps=1)
    tail = _types_after_backward(tmain)
    # the weight takes its own L1 (sign, scale, sum), the bias the
    # optimizer's L2 (scale, sum)
    assert tail == ["sign", "scale", "sum", "scale", "sum", "sgd", "sgd"]


def test_global_norm_scales_are_kept_per_group():
    """Each group's scale var stays in ``clip._GLOBAL_NORM_SCALES`` under
    its name; each group's gradients are scaled by their own."""
    from paddle_tpu_torch import clip as tclip
    tclip._GLOBAL_NORM_SCALES.clear()
    tmain, _, touts = _train(RECIPES["by_global_norm_two_groups"], steps=1)
    assert sorted(tclip._GLOBAL_NORM_SCALES) == ["biases", "weights"]
    scales = {g: v.name for g, v in tclip._GLOBAL_NORM_SCALES.items()}
    assert scales["biases"] != scales["weights"]
    muls = [op for op in tmain.global_block().ops
            if op.type == "elementwise_mul"]
    assert [op.input("Y")[0] for op in muls] == [scales["weights"],
                                                 scales["biases"]]


def test_set_gradient_clip_without_a_list_covers_every_parameter():
    def fn(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[4])
        L.fc(input=L.fc(input=x, size=3), size=1)
        clip = pkg.clip.GradientClipByValue(1.0)
        pkg.clip.set_gradient_clip(clip)
        return clip
    for pkg in PKGS:
        main, _, clip = build(pkg, fn)
        params = main.all_parameters()
        assert len(params) == 4
        assert all(p.gradient_clip_attr is clip for p in params)


def test_no_clip_and_no_regularizer_appends_the_update_alone():
    tmain, jmain, _ = _train(
        lambda pkg: (None, None, None, pkg.optimizer.SGD(0.1)), steps=1)
    assert _types_after_backward(tmain) == ["sgd", "sgd"]


# -- ParamAttr reaches the Parameter ----------------------------------------------

def _layers_with_attrs(pkg):
    L = pkg.layers
    reg = pkg.regularizer.L2Decay(1e-3)
    clip = pkg.clip.GradientClipByNorm(1.0)
    made = {}

    def attr():
        return pkg.ParamAttr(regularizer=reg, gradient_clip=clip)

    x = L.data(name="x", shape=[8])
    made["fc"] = L.fc(input=x, size=4, param_attr=attr(), bias_attr=attr())
    img = L.data(name="img", shape=[3, 8, 8])
    made["conv2d"] = L.conv2d(input=img, num_filters=4, filter_size=3,
                              param_attr=attr(), bias_attr=attr())
    made["batch_norm"] = L.batch_norm(input=made["conv2d"],
                                      param_attr=attr(), bias_attr=attr())
    ids = L.data(name="ids", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(input=ids, size=[10, 8], param_attr=attr())
    made["embedding"] = emb
    proj = L.fc(input=emb, size=16)
    made["dynamic_lstm"] = L.dynamic_lstm(input=proj, size=16,
                                          param_attr=attr(),
                                          bias_attr=attr(),
                                          use_peepholes=False)[0]
    proj3 = L.fc(input=emb, size=12)
    made["dynamic_gru"] = L.dynamic_gru(input=proj3, size=4,
                                        param_attr=attr(), bias_attr=attr())
    return reg, clip


def test_param_attr_regularizer_and_clip_reach_every_layers_parameters():
    got = {}
    for pkg in PKGS:
        main, _, (reg, clip) = build(pkg, _layers_with_attrs)
        # each Parameter holds a copy of its attr's regularizer and clip
        got[pkg.name] = sorted(
            (p.name,
             type(p.regularizer) is type(reg)
             and p.regularizer._coeff == reg._coeff,
             type(p.gradient_clip_attr) is type(clip)
             and p.gradient_clip_attr.clip_norm == clip.clip_norm)
            for p in main.all_parameters())
    assert got["port"] == got["jax"]
    tagged = [n for n, r, c in got["port"] if r and c]
    # fc w, b; conv w, b; bn scale, bias; embedding; lstm w, b; gru w, b
    assert len(tagged) == 11, got["port"]
