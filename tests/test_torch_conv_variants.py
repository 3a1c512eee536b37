"""The port's conv knobs against its default conv and against the JAX
package's knobs, on the CPU (twins of ``tests/test_conv_variants.py``):
``PADDLE_TPU_CONV_LAYOUT=nhwc`` (the conv on ``channels_last``
tensors), ``PADDLE_TPU_CONV_S2D=1`` (the ImageNet stem as
space-to-depth + a 4x4 / s1 conv), both, and ``PADDLE_TPU_CONV_IMPL=
matmul`` (KH*KW shifted matmuls, and the per-tap gradient).

Tolerances: each knob within rtol 2e-4 / atol 2e-5 of the default, as
the JAX test holds its own (sums in other orders); each knob within
1e-5 of max(1, |the JAX value|) of the same knob in the JAX package.
The s2d stem at ResNet-50's width [B, 3, 224, 224] -> 64 within 1e-5 of
max(1, |value|) of the plain conv, forward and both gradients.

``test_v1_deconv3d_grouped_trains`` has no twin here: it builds through
``trainer_config_helpers``, which is not ported (ROADMAP.md Queue 1
item 6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.ops import nn_ops as tnn  # noqa: E402
from torch_optim import (JAX, PKGS, PORT, build, jax_run,  # noqa: E402
                         jax_startup_state, one_op, port_run, rel, value_of)

KNOB_ENV = ("PADDLE_TPU_CONV_LAYOUT", "PADDLE_TPU_CONV_S2D",
            "PADDLE_TPU_CONV_IMPL")
VARIANTS = [
    {"PADDLE_TPU_CONV_LAYOUT": "nhwc"},
    {"PADDLE_TPU_CONV_S2D": "1"},
    {"PADDLE_TPU_CONV_S2D": "1", "PADDLE_TPU_CONV_LAYOUT": "nhwc"},
    {"PADDLE_TPU_CONV_IMPL": "matmul"},
]
IDS = ["nhwc", "s2d", "s2d+nhwc", "matmul"]
FETCH = ["stem.w@GRAD", "mid.w@GRAD", "dw.w@GRAD", "img@GRAD"]


def _net(pkg):
    """``tests/test_conv_variants.py:_build_and_run``'s program: a
    stem-shaped conv (7x7 / s2 / p3 on 3 channels, even H and W), a 3x3
    conv, a depthwise 3x3, mean; SGD at 0 appends the backward. Here
    the image wants a gradient too."""
    L = pkg.layers
    img = L.data("img", shape=[3, 16, 16], dtype="float32")
    img.stop_gradient = False
    c1 = L.conv2d(img, num_filters=8, filter_size=7, stride=2, padding=3,
                  act="relu", param_attr=pkg.ParamAttr(name="stem.w"))
    c2 = L.conv2d(c1, num_filters=8, filter_size=3, padding=1, act="relu",
                  param_attr=pkg.ParamAttr(name="mid.w"))
    c3 = L.conv2d(c2, num_filters=8, filter_size=3, padding=1, groups=8,
                  param_attr=pkg.ParamAttr(name="dw.w"))
    avg = L.mean(c3)
    pkg.optimizer.SGD(learning_rate=0.0).minimize(avg)
    return avg


def _run(pkg, state, env, monkeypatch):
    for k in KNOB_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    main, _, avg = build(pkg, _net)
    feed = {"img": np.random.RandomState(7).randn(2, 3, 16, 16)
            .astype("float32")}
    run = jax_run if pkg is JAX else port_run
    return run(main, state, [feed], [avg.name] + FETCH)[0][0]


@pytest.fixture(scope="module")
def _state():
    main, start, _ = build(JAX, _net)
    return jax_startup_state(main, start)


@pytest.mark.parametrize("env", VARIANTS, ids=IDS)
def test_conv_variant_matches_default(env, monkeypatch, _state):
    """Loss and the gradients of the stem, the 3x3, the depthwise filter
    and the image: the knob against the port's default, and against the
    JAX package under the same knob."""
    base = _run(PORT, _state, {}, monkeypatch)
    got = _run(PORT, _state, env, monkeypatch)
    want = _run(JAX, _state, env, monkeypatch)
    for name, b, g, w in zip(["loss"] + FETCH, base, got, want):
        np.testing.assert_allclose(g, b, rtol=2e-4, atol=2e-5, err_msg=name)
        assert rel(g, w) <= 1e-5, (name, rel(g, w))


def test_knobs_are_read_from_the_environment_and_flags(monkeypatch):
    from paddle_tpu_torch.flags import FLAGS
    for k in KNOB_ENV:
        monkeypatch.delenv(k, raising=False)
    assert (FLAGS.conv_layout, FLAGS.conv_first_s2d) == ("nchw", False)
    assert (tnn.conv_layout(), tnn.conv_first_s2d(), tnn.conv_impl()) \
        == ("nchw", False, "conv")
    monkeypatch.setattr(FLAGS, "conv_layout", "nhwc")
    monkeypatch.setattr(FLAGS, "conv_first_s2d", True)
    assert (tnn.conv_layout(), tnn.conv_first_s2d()) == ("nhwc", True)
    monkeypatch.setenv("PADDLE_TPU_CONV_S2D", "0")
    monkeypatch.setenv("PADDLE_TPU_CONV_LAYOUT", "nchw")
    assert (tnn.conv_layout(), tnn.conv_first_s2d()) == ("nchw", False)
    monkeypatch.setenv("PADDLE_TPU_CONV_IMPL", "matmul")
    assert tnn.conv_impl("pallas3x3") == "matmul"


def _stem_program(pkg, n, hw):
    L = pkg.layers
    img = L.data("img", shape=[3, hw, hw], dtype="float32")
    img.stop_gradient = False
    c = L.conv2d(img, num_filters=4, filter_size=7, stride=2, padding=3,
                 param_attr=pkg.ParamAttr(name="s.w"), bias_attr=False)
    return L.mean(c)


def test_s2d_gate_requires_exact_stem_shape(monkeypatch):
    """Odd H and W keep the stem off the rewrite: the program runs, and
    equals the run without the knob bit for bit."""
    feed = {"img": np.random.RandomState(0).randn(1, 3, 15, 15)
            .astype("float32")}
    main, _, avg = build(PORT, lambda p: _stem_program(p, 1, 15))
    state = {"s.w": np.random.RandomState(1).randn(4, 3, 7, 7)
             .astype("float32")}
    outs = []
    for env in ("0", "1"):
        monkeypatch.setenv("PADDLE_TPU_CONV_S2D", env)
        outs.append(port_run(main, state, [feed], [avg.name])[0][0])
    assert np.isfinite(outs[1][0]).all()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    monkeypatch.setenv("PADDLE_TPU_CONV_S2D", "1")
    x = torch.zeros(1, 3, 15, 15)
    w = torch.zeros(4, 3, 7, 7)
    assert not tnn._conv2d_is_s2d_stem(x, w, [2, 2], [3, 3], [1, 1], 1)
    x = torch.zeros(1, 3, 16, 16)
    assert tnn._conv2d_is_s2d_stem(x, w, [2, 2], [3, 3], [1, 1], 1)
    assert not tnn._conv2d_is_s2d_stem(x, w, [2, 2], [3, 3], [1, 1], 3)
    assert not tnn._conv2d_is_s2d_stem(torch.zeros(1, 5, 16, 16),
                                       torch.zeros(4, 5, 7, 7), [2, 2],
                                       [3, 3], [1, 1], 1)
    assert not tnn._conv2d_is_s2d_stem(x, w, [2, 2], [2, 2], [1, 1], 1)


def _stem_conv(env, monkeypatch, n=4, seed=2):
    """conv2d + its grad at ResNet-50's stem, [n, 3, 224, 224] -> 64,
    through a one-op program of each package under ``env``."""
    for k in KNOB_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3, 224, 224).astype(np.float32)
    w = (rng.randn(64, 3, 7, 7) * 0.1).astype(np.float32)
    return one_op("conv2d", {"Input": [("x", x)], "Filter": [("w", w)]},
                  {"Output": ["y"]},
                  {"strides": [2, 2], "paddings": [3, 3],
                   "dilations": [1, 1], "groups": 1}, diff=("x", "w"))


def test_s2d_stem_at_resnet50_width_matches_the_plain_conv_and_jax(
        monkeypatch):
    base_j, base_t, names, _, _ = _stem_conv({}, monkeypatch)
    s2d_j, s2d_t, _, _, _ = _stem_conv({"PADDLE_TPU_CONV_S2D": "1"},
                                       monkeypatch)
    for n, b, g, j in zip(names, base_t, s2d_t, s2d_j):
        g, b, j = value_of(g), value_of(b), value_of(j)
        assert g.shape == b.shape == j.shape
        assert rel(g, b) <= 1e-5, (n, rel(g, b))
        assert rel(g, j) <= 1e-5, (n, rel(g, j))


def test_s2d_rewrite_is_exact_in_float64(monkeypatch):
    """The rewrite's operands convolve to the 7x7 / s2 / p3 conv's
    output up to float64 rounding: a change of variables, no
    approximation."""
    import torch.nn.functional as F
    monkeypatch.setenv("PADDLE_TPU_CONV_S2D", "1")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 32, 40, generator=g, dtype=torch.float64)
    w = torch.randn(5, 3, 7, 7, generator=g, dtype=torch.float64)
    xo, wo, so, po, do, go = tnn._native_operands(
        x, w, [2, 2], [3, 3], [1, 1], 1)
    assert tuple(wo.shape) == (5, 12, 4, 4) and xo.shape[1] == 12
    got = F.conv2d(xo, wo, None, so, po, do, go)
    want = F.conv2d(x, w, None, 2, 3)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12


def _tconv(pkg_name, op, x, w, groups, s, p):
    nd = x.ndim - 2
    attrs = {"strides": [s] * nd, "paddings": [p] * nd,
             "dilations": [1] * nd, "groups": groups}
    j, t, _, _, _ = one_op(op, {"Input": [("x", x)], "Filter": [("w", w)]},
                           {"Output": ["y"]}, attrs)
    return value_of(j[0] if pkg_name == "jax" else t[0])


@pytest.mark.parametrize("nd", [2, 3])
def test_grouped_transpose_conv_matches_per_group_composition(nd):
    """conv{2,3}d_transpose with groups == the concat of per-group
    ungrouped transposes; and equal to the JAX op."""
    rng = np.random.RandomState(21)
    G, Cg, Fg = 2, 3, 2
    C = G * Cg
    sp = (5,) * nd
    k = (3,) * nd
    op = "conv%dd_transpose" % nd
    x = rng.rand(2, C, *sp).astype(np.float32)
    w = rng.rand(C, Fg, *k).astype(np.float32)
    got = _tconv("port", op, x, w, G, 2, 1)
    want = np.concatenate(
        [_tconv("port", op, x[:, g * Cg:(g + 1) * Cg],
                w[g * Cg:(g + 1) * Cg], 1, 2, 1) for g in range(G)], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert rel(got, _tconv("jax", op, x, w, G, 2, 1)) <= 1e-6


def test_transpose_conv_groups_validation():
    for pkg in PKGS:
        def bad2(p):
            x = p.layers.data("tx", shape=[4, 6, 6], dtype="float32")
            p.layers.conv2d_transpose(x, num_filters=6, filter_size=3,
                                      groups=4)

        def bad3(p):
            v = p.layers.data("tv", shape=[4, 3, 3, 3], dtype="float32")
            p.layers.conv3d_transpose(v, num_filters=5, filter_size=2,
                                      groups=2)

        for fn in (bad2, bad3):
            with pytest.raises(ValueError, match="divisible by groups"):
                build(pkg, fn)


def test_bf16_conv_grad_without_amp():
    """bfloat16 operands outside AMP: the forward sums in float32 (the
    JAX lowering's preferred_element_type), the grad takes the bfloat16
    cotangent; the filter's gradient is finite, non-zero, and within
    bfloat16's precision of the JAX package's."""
    def net(pkg):
        L = pkg.layers
        img = L.data("img", shape=[3, 8, 8], dtype="bfloat16")
        c = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                     param_attr=pkg.ParamAttr(name="wbf.w"))
        avg = L.mean(L.cast(c, "float32"))
        pkg.optimizer.SGD(learning_rate=0.0).minimize(avg)
        return avg

    import jax.numpy as jnp
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype("float32")
    jmain, jstart, javg = build(JAX, net)
    state = jax_startup_state(jmain, jstart)
    jl, jg = jax_run(jmain, state, [{"img": x.astype(jnp.bfloat16)}],
                     [javg.name, "wbf.w@GRAD"])[0][0]
    tmain, _, tavg = build(PORT, net)
    state_t = {n: np.asarray(v, np.float32) for n, v in state.items()}
    from paddle_tpu_torch.core.executor import Executor as TExecutor
    from paddle_tpu_torch.core.scope import Scope as TScope
    from paddle_tpu_torch.core.scope import scope_from_numpy
    scope = TScope()
    scope_from_numpy(state_t, device="cpu", scope=scope)
    for n in state_t:
        scope.set_var(n, scope.find_var(n).to(torch.bfloat16))
    tl, tg = TExecutor("cpu").run(
        tmain, feed={"img": torch.from_numpy(x).to(torch.bfloat16)},
        fetch_list=[tavg.name, "wbf.w@GRAD"], scope=scope,
        return_numpy=False)
    tg = tg.float().numpy()
    jg = np.asarray(jg, np.float32)
    assert tg.shape == (4, 3, 3, 3) and np.isfinite(tg).all()
    assert np.abs(tg).max() > 0
    assert rel(tg, jg) <= 2 ** -7, rel(tg, jg)
    jl = float(np.asarray(jl, np.float32).reshape(-1)[0])
    assert abs(float(tl.float().reshape(-1)[0]) - jl) <= 2 ** -7 * max(
        1.0, abs(jl))
