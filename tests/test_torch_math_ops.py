"""The ops of the optimization slice against their JAX lowerings, on
the CPU: the activation table and its grads, the elementwise family with
its axis broadcast and grads, the reductions, comparisons and logicals,
``clip``, ``clip_by_norm``, ``squared_l2_norm``, ``gather``,
``assign_value``, ``increment`` and the operator sugar of ``Variable``.

Each case builds the same program through each package's layers DSL,
feeds both the same seeded numpy inputs, and holds every output and
gradient within 1e-6 of max(1, |the JAX value|); a gradient comes from
each package's own ``append_backward`` of mean(out * w), w fed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from torch_optim import (JAX, OP_TOL, PKGS, PORT, build, jax_run,  # noqa: E402
                         op_types, port_run, rel, run_both)

RNG_SHAPE = (3, 5)


def _inputs(seed, shape=RNG_SHAPE, positive=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32) * 2.0
    if positive:
        x = np.abs(x) + 0.5
    return x, rng.randn(*shape).astype(np.float32)


def _assert_close(jax_outs, port_outs, names):
    for n, j, t in zip(names, jax_outs, port_outs):
        assert t.shape == j.shape, (n, t.shape, j.shape)
        assert rel(t, j) <= OP_TOL, (n, rel(t, j))


# -- activations --------------------------------------------------------------

ACTIVATIONS = [
    ("sigmoid", {}), ("logsigmoid", {}), ("relu6", {}), ("exp", {}),
    ("abs", {}), ("ceil", {}), ("floor", {}), ("round", {}),
    ("log", {}), ("square", {}), ("sqrt", {}), ("reciprocal", {}),
    ("softplus", {}), ("softsign", {}), ("sin", {}), ("cos", {}),
    ("tanh_shrink", {}), ("softshrink", {}), ("sign", {}),
    ("relu", {}), ("tanh", {}),
    ("hard_shrink", {"threshold": 0.7}), ("leaky_relu", {"alpha": 0.1}),
    ("elu", {"alpha": 0.5}), ("brelu", {"t_min": -1.0, "t_max": 2.0}),
    ("soft_relu", {"threshold": 2.0}),
    ("hard_sigmoid", {"slope": 0.3, "offset": 0.4}),
    ("swish", {"beta": 1.5}), ("thresholded_relu", {"threshold": 0.5}),
    ("stanh", {"scale_a": 0.5, "scale_b": 1.5}), ("pow", {"factor": 3.0}),
]
POSITIVE = {"log", "sqrt", "reciprocal"}


def _act_program(name, attrs):
    def fn(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=list(RNG_SHAPE), append_batch_size=False)
        x.stop_gradient = False
        w = L.data(name="w", shape=list(RNG_SHAPE), append_batch_size=False)
        out = getattr(L, name)(x, **attrs)
        pkg.append_backward(L.mean(L.elementwise_mul(out, w)))
        return out
    return fn


@pytest.mark.parametrize("name,attrs", ACTIVATIONS,
                         ids=[a[0] for a in ACTIVATIONS])
def test_activation_and_its_grad_match_jax(name, attrs):
    x, w = _inputs(len(name), positive=name in POSITIVE)
    j, t, jmain, tmain = run_both(_act_program(name, attrs),
                                  {"x": x, "w": w},
                                  lambda out: [out.name, "x@GRAD"])
    _assert_close(j, t, ["out", "x@GRAD"])
    # the same grad op in both: the output-form ones or the generic one
    assert op_types(tmain) == op_types(jmain)


def test_output_form_activation_grads_read_the_output():
    for name in ("sigmoid", "exp", "sqrt", "reciprocal", "tanh"):
        tmain, _, _ = build(PORT, _act_program(name, {}))
        grad = [op for op in tmain.global_block().ops
                if op.type == name + "_grad"]
        assert len(grad) == 1 and "Out" in grad[0].inputs, name


# -- the elementwise family ----------------------------------------------------

ELEMENTWISE = ["elementwise_add", "elementwise_sub", "elementwise_mul",
               "elementwise_div", "elementwise_max", "elementwise_min",
               "elementwise_pow"]
# (X shape, Y shape, axis): Y a contiguous run of X's dims placed at axis
BROADCASTS = [((2, 3, 4), (2, 3, 4), -1), ((2, 3, 4), (3,), 1),
              ((2, 3, 4), (3, 4), -1), ((2, 3, 4), (2, 3, 1), 0)]


def _ew_program(op, yshape, axis):
    def fn(pkg):
        L = pkg.layers
        from_helper = getattr(L, op, None)
        x = L.data(name="x", shape=[2, 3, 4], append_batch_size=False)
        y = L.data(name="y", shape=list(yshape), append_batch_size=False)
        w = L.data(name="w", shape=[2, 3, 4], append_batch_size=False)
        x.stop_gradient = y.stop_gradient = False
        if from_helper is not None:
            out = from_helper(x, y, axis=axis)
        else:
            # the layers DSL has no max / min / pow layer (nor has the
            # JAX package's): the op appended as an add, then retyped
            out = L.elementwise_add(x, y, axis=axis)
            out.op.type = op
        pkg.append_backward(L.mean(L.elementwise_mul(out, w)))
        return out
    return fn


@pytest.mark.parametrize("xs,ys,axis", BROADCASTS,
                         ids=["same", "axis1", "trailing", "inner_one"])
@pytest.mark.parametrize("op", ELEMENTWISE)
def test_elementwise_op_and_its_grads_match_jax(op, xs, ys, axis):
    rng = np.random.RandomState(len(op) + len(ys))
    x = rng.randn(*xs).astype(np.float32)
    y = rng.randn(*ys).astype(np.float32)
    if op == "elementwise_pow":
        x = np.abs(x) + 0.5
    if op == "elementwise_div":
        y = np.sign(y) * (np.abs(y) + 0.5)
    w = rng.randn(*xs).astype(np.float32)
    j, t, jmain, tmain = run_both(_ew_program(op, ys, axis),
                                  {"x": x, "y": y, "w": w},
                                  lambda out: [out.name, "x@GRAD", "y@GRAD"])
    _assert_close(j, t, ["out", "x@GRAD", "y@GRAD"])
    assert op_types(tmain) == op_types(jmain)


def test_minus_matches_jax():
    x, y = _inputs(7)

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=list(RNG_SHAPE), append_batch_size=False)
        b = L.data(name="w", shape=list(RNG_SHAPE), append_batch_size=False)
        out = L.elementwise_add(a, b)
        out.op.type = "minus"
        return out
    j, t, _, _ = run_both(fn, {"x": x, "w": y}, lambda o: [o.name])
    _assert_close(j, t, ["minus"])
    np.testing.assert_array_equal(t[0], x - y)


# -- reductions ----------------------------------------------------------------

REDUCES = ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod"]
REDUCE_ATTRS = [({"dim": [1], "keep_dim": False, "reduce_all": False},
                 "dim1"),
                ({"dim": [0, 2], "keep_dim": True, "reduce_all": False},
                 "dims02_keep"),
                ({"dim": [0], "keep_dim": False, "reduce_all": True},
                 "all"),
                ({"dim": [0], "keep_dim": True, "reduce_all": True},
                 "all_keep")]


@pytest.mark.parametrize("attrs", [a for a, _ in REDUCE_ATTRS],
                         ids=[i for _, i in REDUCE_ATTRS])
@pytest.mark.parametrize("op", REDUCES)
def test_reduce_op_and_its_grad_match_jax(op, attrs):
    rng = np.random.RandomState(len(op))
    x = (rng.rand(2, 3, 4).astype(np.float32) + 0.5)

    def fn(pkg):
        L = pkg.layers
        v = L.data(name="x", shape=[2, 3, 4], append_batch_size=False)
        v.stop_gradient = False
        out = L.reduce_sum(v)
        out.op.type = op
        out.op.attrs.update(attrs)
        pkg.append_backward(L.mean(L.scale(out, scale=3.0)))
        return out
    j, t, jmain, tmain = run_both(fn, {"x": x},
                                  lambda out: [out.name, "x@GRAD"])
    _assert_close(j, t, ["out", "x@GRAD"])
    assert op_types(tmain) == op_types(jmain)


def test_reduce_layers_append_the_jax_attrs():
    def fn(pkg):
        L = pkg.layers
        v = L.data(name="x", shape=[2, 3, 4], append_batch_size=False)
        return [L.reduce_sum(v), L.reduce_mean(v, dim=1),
                L.reduce_max(v, dim=[0, 2], keep_dim=True),
                L.reduce_min(v, dim=-1)]
    jmain, _, _ = build(JAX, fn)
    tmain, _, _ = build(PORT, fn)
    assert [(op.type, op.attrs) for op in tmain.global_block().ops] == \
        [(op.type, op.attrs) for op in jmain.global_block().ops]


# -- comparisons and logicals --------------------------------------------------

COMPARES = ["less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal", "logical_and", "logical_or",
            "logical_xor"]


@pytest.mark.parametrize("op", COMPARES)
def test_compare_and_logical_ops_match_jax(op):
    rng = np.random.RandomState(len(op))
    # small integers as float32: ties where the comparison turns
    x = rng.randint(-2, 3, (2, 3, 4)).astype(np.float32)
    y = rng.randint(-2, 3, (3, 4)).astype(np.float32)
    if op.startswith("logical"):
        x, y = x > 0, y > 0

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=[2, 3, 4], append_batch_size=False,
                   dtype=str(x.dtype))
        b = L.data(name="y", shape=[3, 4], append_batch_size=False,
                   dtype=str(y.dtype))
        out = L.elementwise_add(a, b)
        out.op.type = op
        return out
    j, t, _, _ = run_both(fn, {"x": x, "y": y}, lambda o: [o.name])
    assert t[0].dtype == np.bool_ and j[0].dtype == np.bool_
    np.testing.assert_array_equal(t[0], j[0])


def test_logical_not_matches_jax():
    x = np.random.RandomState(3).rand(3, 5) > 0.5

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=[3, 5], append_batch_size=False,
                   dtype="bool")
        return L.logical_not(a)
    j, t, _, _ = run_both(fn, {"x": x}, lambda o: [o.name])
    np.testing.assert_array_equal(t[0], j[0])


# -- clip, clip_by_norm, squared_l2_norm ---------------------------------------

def test_clip_and_its_grad_match_jax():
    x, w = _inputs(11)

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=list(RNG_SHAPE), append_batch_size=False)
        a.stop_gradient = False
        b = L.data(name="w", shape=list(RNG_SHAPE), append_batch_size=False)
        out = L.clip(a, min=-0.8, max=1.1)
        pkg.append_backward(L.mean(L.elementwise_mul(out, b)))
        return out
    j, t, _, _ = run_both(fn, {"x": x, "w": w},
                          lambda o: [o.name, "x@GRAD"])
    _assert_close(j, t, ["clip", "x@GRAD"])


@pytest.mark.parametrize("max_norm", [0.5, 50.0], ids=["above", "below"])
def test_clip_by_norm_matches_jax_above_and_below_the_norm(max_norm):
    x, w = _inputs(12)
    assert (np.linalg.norm(x) > max_norm) == (max_norm == 0.5)

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=list(RNG_SHAPE), append_batch_size=False)
        a.stop_gradient = False
        b = L.data(name="w", shape=list(RNG_SHAPE), append_batch_size=False)
        out = L.clip_by_norm(a, max_norm=max_norm)
        pkg.append_backward(L.mean(L.elementwise_mul(out, b)))
        return out
    j, t, _, _ = run_both(fn, {"x": x, "w": w},
                          lambda o: [o.name, "x@GRAD"])
    _assert_close(j, t, ["clip_by_norm", "x@GRAD"])
    norm = float(np.linalg.norm(t[0].astype(np.float64)))
    if max_norm == 0.5:
        assert abs(norm - max_norm) < 1e-6
    else:
        np.testing.assert_array_equal(t[0], x)


def test_squared_l2_norm_matches_jax():
    x, _ = _inputs(13, shape=(7, 9))

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=[7, 9], append_batch_size=False)
        out = L.reduce_sum(a)
        out.op.type = "squared_l2_norm"
        out.op.attrs.clear()
        return out
    j, t, _, _ = run_both(fn, {"x": x}, lambda o: [o.name])
    assert t[0].shape == (1,)
    _assert_close(j, t, ["squared_l2_norm"])


# -- gather, assign_value, increment, sums ---------------------------------------

def test_gather_and_its_grad_match_jax():
    x, _ = _inputs(14, shape=(6, 4))
    idx = np.array([[4], [0], [4], [2]], np.int32)
    w = np.random.RandomState(15).randn(4, 4).astype(np.float32)

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=[6, 4], append_batch_size=False)
        a.stop_gradient = False
        i = L.data(name="i", shape=[4, 1], append_batch_size=False,
                   dtype="int32")
        b = L.data(name="w", shape=[4, 4], append_batch_size=False)
        out = L.gather(a, i)
        pkg.append_backward(L.mean(L.elementwise_mul(out, b)))
        return out
    j, t, _, _ = run_both(fn, {"x": x, "i": idx, "w": w},
                          lambda o: [o.name, "x@GRAD"])
    _assert_close(j, t, ["gather", "x@GRAD"])
    np.testing.assert_array_equal(t[0], x[idx.reshape(-1)])


@pytest.mark.parametrize("value", [
    [0.5, 0.25, 0.125], np.arange(6, dtype=np.float32).reshape(2, 3),
    np.array([[3, -1]], np.int32)], ids=["list", "float32", "int32"])
def test_assign_of_a_value_matches_jax(value):
    def fn(pkg):
        return pkg.layers.assign(value)
    j, t, jmain, tmain = run_both(fn, {}, lambda o: [o.name])
    want = np.asarray(value)
    # the port keeps the value's own dtype (a Python list is float64);
    # JAX, with 64-bit types off, holds it in float32
    assert t[0].dtype == want.dtype
    np.testing.assert_array_equal(t[0], want)
    np.testing.assert_array_equal(j[0], want.astype(j[0].dtype))
    assert [(op.type, op.attrs["dtype"], op.attrs["shape"])
            for op in tmain.global_block().ops] == \
        [(op.type, op.attrs["dtype"], op.attrs["shape"])
         for op in jmain.global_block().ops]


@pytest.mark.parametrize("dtype", ["int64", "float32"])
def test_increment_keeps_its_dtype(dtype):
    """The step counter stays int64 (``jnp.asarray(step, x.dtype)`` in
    the JAX lowering; an int64 tensor plus a Python float would be
    float32 in PyTorch). JAX, with 64-bit types off, holds it in int32;
    the values agree step by step."""
    def fn(pkg):
        L = pkg.layers
        c = L.fill_constant(shape=[1], dtype=dtype, value=3)
        c.persistable = True
        return L.increment(c, value=2.0, in_place=True)

    outs = {}
    for pkg in PKGS:
        main, start, c = build(pkg, fn)
        if pkg is JAX:
            got, _, _ = jax_run(main, {}, [{}] * 3, [c.name])
        else:
            got, _, _, _ = port_run(main, {}, [{}] * 3, [c.name])
        outs[pkg.name] = [g[0] for g in got]
    for v in outs["port"]:
        assert v.dtype == np.dtype(dtype)
        assert v.tolist() == [5]
    assert [v.tolist() for v in outs["jax"]] == \
        [v.tolist() for v in outs["port"]]


def test_step_counter_is_int64_and_shared():
    """``autoincreased_step_counter`` under one name is one persistable
    int64 with one ``increment``, whatever the number of callers."""
    def fn(pkg):
        L = pkg.layers
        a = L.autoincreased_step_counter(counter_name="@C@", begin=1)
        b = L.autoincreased_step_counter(counter_name="@C@", begin=1)
        return a, b
    tmain, tstart, (a, b) = build(PORT, fn)
    jmain, _, _ = build(JAX, fn)
    assert a is b and str(a.dtype) == "int64" and a.persistable
    assert op_types(tmain) == op_types(jmain) == ["increment"]
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(tstart, scope=scope)
    got = [exe.run(tmain, fetch_list=[a.name], scope=scope)[0]
           for _ in range(4)]
    assert all(g.dtype == np.int64 for g in got)
    assert [g.tolist() for g in got] == [[1], [2], [3], [4]]


def test_sums_matches_jax():
    x, y = _inputs(16)

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=list(RNG_SHAPE), append_batch_size=False)
        b = L.data(name="w", shape=list(RNG_SHAPE), append_batch_size=False)
        return L.sums([a, b, a])
    j, t, _, _ = run_both(fn, {"x": x, "w": y}, lambda o: [o.name])
    _assert_close(j, t, ["sums"])


# -- the operator sugar ----------------------------------------------------------

SUGAR = [
    ("add_scalar", lambda a, b: a + 1.5), ("radd_scalar", lambda a, b: 2 + a),
    ("sub_scalar", lambda a, b: a - 0.5),
    ("rsub_scalar", lambda a, b: 1.0 - a),
    ("mul_scalar", lambda a, b: a * 3.0), ("rmul_scalar", lambda a, b: 2 * a),
    ("div_scalar", lambda a, b: a / 4.0),
    ("add", lambda a, b: a + b), ("sub", lambda a, b: a - b),
    ("mul", lambda a, b: a * b), ("div", lambda a, b: a / b),
    ("lt", lambda a, b: a < b), ("le", lambda a, b: a <= b),
    ("gt", lambda a, b: a > b), ("ge", lambda a, b: a >= b),
    ("lt_scalar", lambda a, b: a < 0.25),
]


@pytest.mark.parametrize("name,expr", SUGAR, ids=[s[0] for s in SUGAR])
def test_variable_sugar_appends_the_jax_ops(name, expr):
    x, y = _inputs(17)
    y = np.sign(y) * (np.abs(y) + 0.5)

    def fn(pkg):
        L = pkg.layers
        a = L.data(name="x", shape=list(RNG_SHAPE), append_batch_size=False)
        b = L.data(name="w", shape=list(RNG_SHAPE), append_batch_size=False)
        return expr(a, b)
    j, t, jmain, tmain = run_both(fn, {"x": x, "w": y}, lambda o: [o.name])
    assert [(op.type, op.attrs) for op in tmain.global_block().ops] == \
        [(op.type, op.attrs) for op in jmain.global_block().ops]
    out = [v for v in tmain.list_vars() if v.name not in ("x", "w")][-1]
    if name[:2] in ("lt", "le", "gt", "ge"):
        assert str(out.dtype) == "bool" and t[0].dtype == np.bool_
        np.testing.assert_array_equal(t[0], j[0])
    else:
        _assert_close(j, t, [name])


# -- gradients at corners (ROADMAP Queue 3 #27) --------------------------------

CORNERS = [
    ("abs", {}, [0.0, -0.0, 1.5, -2.0]),
    ("relu6", {}, [0.0, 6.0, 3.0, -1.0]),
    ("brelu", {"t_min": -1.0, "t_max": 2.0}, [-1.0, 2.0, 0.5, 3.0]),
    ("hard_sigmoid", {"slope": 0.5, "offset": 0.5}, [-1.0, 1.0, 0.0, 2.0]),
    ("soft_relu", {"threshold": 2.0}, [-2.0, 2.0, 0.5, 3.0]),
    ("softshrink", {}, [0.5, -0.5, 1.0, 0.0]),
    ("clip", {"min": -0.5, "max": 1.0}, [-0.5, 1.0, 0.25, 2.0]),
]


@pytest.mark.parametrize("name,attrs,corner", CORNERS,
                         ids=[c[0] for c in CORNERS])
def test_gradient_at_a_corner_matches_jax(name, attrs, corner):
    """|x| at 0 passes the whole gradient and a clip at its bound half of
    it in JAX (``jnp.abs``, ``jnp.clip``); ``torch.abs`` and
    ``torch.clamp`` would pass none and all of it. |-0.0| is +0.0 in
    both."""
    x = np.tile(np.asarray(corner, np.float32), (3, 1))[:, :4]
    x = np.concatenate([x, _inputs(40)[0][:, :1]], axis=1)
    w = _inputs(41)[1]
    j, t, _, _ = run_both(_act_program(name, attrs), {"x": x, "w": w},
                          lambda out: [out.name, "x@GRAD"])
    _assert_close(j, t, ["out", "x@GRAD"])
    if name == "abs":
        np.testing.assert_array_equal(np.signbit(t[0]), np.signbit(j[0]))
