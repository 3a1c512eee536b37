"""The dense tensor ops of the port against their JAX lowerings, on the
CPU: the 24 ops of ``ops/tensor_ops.py`` and ``matmul``, ``norm``,
``maximum``, ``isfinite`` and ``matmul_grad`` of the math slice.

Each case runs one op alone in a program of each package
(``torch_optim.one_op``) on the same seeded numpy inputs; a gradient
comes from each package's ``append_backward`` of mean(out * w), w a
seeded feed. Tolerances:
- data movement, index and boolean outputs are equal, and so is the LoD
  each output carries (or not);
- float outputs and gradients are within 1e-6 of max(1, |the JAX
  value|) (``OP_TOL``);
- bfloat16 outputs under AMP within one bfloat16 ulp of the largest
  magnitude of the JAX output (both sum bfloat16 products in float32,
  in other orders, and round once; ``tests/test_torch_amp.py``);
- the random ops agree in distribution only (the port draws from a
  ``torch.Generator``, JAX from threefry): shapes, bounds, and the mean
  and variance of 2^16 draws within 5 standard errors of the law's.

Index outputs are int64 in the port and int32 in JAX, whose 64-bit
types are off (ROADMAP Queue 3 #26): their values are equal.
"""
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import paddle_tpu.ops  # noqa: E402,F401
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu.core import registry as jreg  # noqa: E402
import paddle_tpu_torch.ops  # noqa: E402,F401
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.core import registry as treg  # noqa: E402
from torch_optim import (JAX, OP_TOL, PKGS, PORT, feed_of, lod_of,  # noqa: E402
                         one_op, one_op_program, op_types, rel, run_once,
                         value_of)

NEW_OPS = (
    "concat", "split", "slice", "transpose", "squeeze", "unsqueeze",
    "expand", "pad", "crop", "one_hot", "scatter", "shape", "range", "fill",
    "fill_zeros_like", "reverse", "arg_max", "arg_min", "argsort",
    "is_empty", "sampling_id", "truncated_gaussian_random",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "matmul", "maximum", "norm", "isfinite", "matmul_grad",
    "cos_sim", "hinge_loss", "huber_loss", "l1_norm", "label_smooth",
    "log_loss", "margin_rank_loss", "modified_huber_loss", "rank_loss",
    "sigmoid_cross_entropy_with_logits", "smooth_l1_loss",
    "squared_l2_distance")
BF16 = np.dtype(ml_dtypes.bfloat16)


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _float0_lod(lod):
    """Whether a JAX fetch's LoD is the float0 cotangent of its offsets
    (the gradient of a LoD input: ROADMAP, faults of the reference)."""
    return lod is not None and any(
        np.asarray(level).dtype.kind == "V" for level in lod)


def _assert_match(j, t, names, exact=False, int64=(), grad_lod=None):
    """Each port fetch against the JAX one: same LoD, same shape, equal
    (``exact``, every integer or bool output) or within OP_TOL; an
    output named in ``int64`` is int64 in the port and int32 in JAX. A
    gradient whose JAX LoD holds float0 offsets carries ``grad_lod``
    (its input's) in the port."""
    for n, jv, tv in zip(names, j, t):
        if _float0_lod(lod_of(jv)):
            assert lod_of(tv) == grad_lod, (n, lod_of(tv), grad_lod)
        else:
            assert lod_of(tv) == lod_of(jv), (n, lod_of(tv), lod_of(jv))
        ja, ta = value_of(jv), value_of(tv)
        assert ta.shape == ja.shape, (n, ta.shape, ja.shape)
        if n in int64:
            assert ta.dtype == np.int64 and ja.dtype == np.int32, \
                (n, ta.dtype, ja.dtype)
            np.testing.assert_array_equal(ta, ja, err_msg=n)
        elif exact or not np.issubdtype(ja.dtype, np.floating):
            assert ta.dtype == ja.dtype, (n, ta.dtype, ja.dtype)
            np.testing.assert_array_equal(ta, ja, err_msg=n)
        else:
            assert ta.dtype == ja.dtype, (n, ta.dtype, ja.dtype)
            assert rel(ta, ja) <= OP_TOL, (n, rel(ta, ja))


def test_the_41_ops_are_registered_as_in_jax():
    """The slice's 41 op types, each among the JAX package's, with
    JAX's ``host`` and ``no_gradient`` settings and the same kind of
    grad maker (the generic one, or an explicit one); 163 op types in
    all with this slice, 180 since the conv-net slice's 17, 209 since
    the sequence slice's 29, 233 since the control flow slice's 24, 235
    since the sparse rows slice's 2."""
    assert len(NEW_OPS) == 41 and len(set(NEW_OPS)) == 41
    # the port's own lowerings (a test may register an op of its own)
    port = [op for op in treg.registered_ops() if treg.lookup(
        op).lower.__module__.startswith("paddle_tpu_torch.")]
    assert len(port) == 235 and set(port) <= set(jreg.registered_ops())
    for op in NEW_OPS:
        t, j = treg.lookup(op), jreg.lookup(op)
        assert t is not None, op
        assert bool(t.host) == bool(j.host), op
        assert t.no_gradient == j.no_gradient, op
        assert (t.grad_maker is None) == (j.grad_maker is None), op
        assert (t.infer_shape is None) == (j.infer_shape is None), op
    assert treg.lookup("range").host is True


# -- data movement -------------------------------------------------------------

_X = _r(1, 2, 3, 4)
_LOD_X = (_r(2, 5, 4), [[0, 2, 5]])

# (id, op, inputs, outputs, attrs, diff, loss_of)
MOVES = [
    ("fill_float32", "fill", {}, {"Out": ["o"]},
     {"shape": [2, 3], "value": [0.5, -1.0, 2.0, 3.5, 0.0, 1.25],
      "dtype": "float32"}, (), None),
    ("fill_int32", "fill", {}, {"Out": ["o"]},
     {"shape": [3], "value": [1.0, -2.0, 7.0], "dtype": "int32"}, (), None),
    ("fill_zeros_like_lod", "fill_zeros_like", {"X": [("x", _LOD_X)]},
     {"Out": ["o"]}, {}, (), None),
    ("squeeze_axes", "squeeze", {"X": [("x", _r(3, 2, 1, 3, 1))]},
     {"Out": ["o"]}, {"axes": [1]}, ("x",), None),
    ("squeeze_all", "squeeze", {"X": [("x", _r(4, 2, 1, 3, 1))]},
     {"Out": ["o"]}, {"axes": []}, ("x",), None),
    ("unsqueeze", "unsqueeze", {"X": [("x", _r(5, 2, 3))]},
     {"Out": ["o"]}, {"axes": [0, 2]}, ("x",), None),
    ("transpose", "transpose", {"X": [("x", _X)]}, {"Out": ["o"]},
     {"axis": [2, 0, 1]}, ("x",), None),
    ("transpose_lod_dropped", "transpose", {"X": [("x", _LOD_X)]},
     {"Out": ["o"]}, {"axis": [1, 0]}, (), None),
    ("expand", "expand", {"X": [("x", _r(6, 2, 3))]}, {"Out": ["o"]},
     {"expand_times": [2, 3]}, ("x",), None),
    ("expand_more_dims", "expand", {"X": [("x", _r(7, 2, 3))]},
     {"Out": ["o"]}, {"expand_times": [2, 1, 2]}, ("x",), None),
    ("concat_axis1", "concat",
     {"X": [("a", _r(8, 2, 3)), ("b", _r(9, 2, 4)), ("c", _r(10, 2, 1))]},
     {"Out": ["o"]}, {"axis": 1}, ("a", "b", "c"), None),
    ("concat_axis1_lod_kept", "concat",
     {"X": [("a", _LOD_X), ("b", (_r(11, 5, 2), [[0, 2, 5]]))]},
     {"Out": ["o"]}, {"axis": 1}, ("a", "b"), None),
    ("concat_axis0_lod_dropped", "concat",
     {"X": [("a", _LOD_X), ("b", (_r(12, 3, 4), [[0, 1, 3]]))]},
     {"Out": ["o"]}, {"axis": 0}, (), None),
    ("split_num", "split", {"X": [("x", _r(13, 2, 6))]},
     {"Out": ["o0", "o1"]}, {"axis": 1, "num": 2, "sections": []},
     ("x",), "o1"),
    ("split_sections", "split", {"X": [("x", _r(14, 2, 6))]},
     {"Out": ["o0", "o1", "o2"]}, {"axis": 1, "num": 0,
                                   "sections": [1, 2, 3]}, ("x",), "o2"),
    ("split_lod_dropped", "split", {"X": [("x", _LOD_X)]},
     {"Out": ["o0", "o1"]}, {"axis": 1, "num": 2, "sections": []}, (),
     None),
    ("scatter_ids_n", "scatter",
     {"X": [("x", _r(15, 5, 3))], "Ids": [("i", np.array([1, 4]))],
      "Updates": [("u", _r(16, 2, 3))]}, {"Out": ["o"]},
     {"overwrite": True}, ("x", "u"), None),
    ("scatter_ids_n1_negative", "scatter",
     {"X": [("x", _r(17, 5, 3))],
      "Ids": [("i", np.array([[0], [-1], [2]], np.int32))],
      "Updates": [("u", _r(18, 3, 3))]}, {"Out": ["o"]}, {},
     ("x", "u"), None),
    ("pad", "pad", {"X": [("x", _r(19, 2, 3))]}, {"Out": ["o"]},
     {"paddings": [1, 0, 2, 1], "pad_value": 0.5}, ("x",), None),
    ("slice_negative_and_clamped", "slice",
     {"Input": [("x", _r(20, 4, 5, 6))]}, {"Out": ["o"]},
     {"axes": [1, 2], "starts": [-3, 1], "ends": [10, -1]}, ("x",), None),
    ("slice_lod_kept", "slice", {"Input": [("x", _LOD_X)]},
     {"Out": ["o"]}, {"axes": [1], "starts": [1], "ends": [3]}, ("x",),
     None),
    ("slice_axis0_lod_dropped", "slice", {"Input": [("x", _LOD_X)]},
     {"Out": ["o"]}, {"axes": [0], "starts": [1], "ends": [-1]}, (),
     None),
    ("crop_by_shape", "crop", {"X": [("x", _r(21, 4, 5))]},
     {"Out": ["o"]}, {"offsets": [1, 2], "shape": [2, 3]}, ("x",), None),
    ("crop_by_y", "crop",
     {"X": [("x", _r(22, 4, 5))], "Y": [("y", np.zeros((3, 2),
                                                       np.float32))]},
     {"Out": ["o"]}, {"offsets": [0, 3], "shape": [1, 1]}, ("x",), None),
    ("reverse", "reverse", {"X": [("x", _r(23, 3, 4))]}, {"Out": ["o"]},
     {"axis": [0, 1]}, ("x",), None),
    ("one_hot_out_of_range", "one_hot",
     {"X": [("x", np.array([[0], [3], [-1], [4], [2], [-4]]))]},
     {"Out": ["o"]}, {"depth": 4}, (), None),
    ("is_empty_false", "is_empty", {"X": [("x", _r(24, 2, 3))]},
     {"Out": ["o"]}, {}, (), None),
    ("is_empty_true", "is_empty",
     {"X": [("x", np.zeros((0, 3), np.float32))]}, {"Out": ["o"]}, {}, (),
     None),
]


@pytest.mark.parametrize("case", MOVES, ids=[c[0] for c in MOVES])
def test_data_movement_op_matches_jax(case):
    _, op, inputs, outputs, attrs, diff, loss_of = case
    j, t, names, jmain, tmain = one_op(op, inputs, outputs, attrs, diff,
                                       loss_of)
    outs = [n for ns in outputs.values() for n in ns]
    _assert_match(j[:len(outs)], t[:len(outs)], outs, exact=True)
    _assert_match(j[len(outs):], t[len(outs):], names[len(outs):],
                  grad_lod=_LOD_X[1])
    assert op_types(tmain) == op_types(jmain)


def test_lod_each_op_keeps():
    """concat keeps its first input's LoD unless axis 0, slice unless an
    axis is 0, fill_zeros_like keeps it; split, transpose, squeeze and
    unsqueeze drop it (each as in JAX, above; named here)."""
    kept = {c[0]: c for c in MOVES}
    for name, keeps in (("concat_axis1_lod_kept", True),
                        ("concat_axis0_lod_dropped", False),
                        ("slice_lod_kept", True),
                        ("slice_axis0_lod_dropped", False),
                        ("fill_zeros_like_lod", True),
                        ("split_lod_dropped", False),
                        ("transpose_lod_dropped", False)):
        _, op, inputs, outputs, attrs, _, _ = kept[name]
        _, t, _, _, _ = one_op(op, inputs, outputs, attrs)
        assert (lod_of(t[0]) == [[0, 2, 5]]) is keeps, name
    lod_in = {"X": [("x", (_r(25, 5, 1, 3), [[0, 2, 5]]))]}
    for op, attrs in (("squeeze", {"axes": [1]}),
                      ("unsqueeze", {"axes": [0]})):
        j, t, _, _, _ = one_op(op, lod_in, {"Out": ["o"]}, attrs)
        assert lod_of(t[0]) is None and lod_of(j[0]) is None, op


def test_one_hot_out_of_range_rows_are_zero():
    j, t, _, _, _ = one_op(
        "one_hot", {"X": [("x", np.array([[-1], [4], [1]]))]},
        {"Out": ["o"]}, {"depth": 4})
    np.testing.assert_array_equal(t[0], [[0, 0, 0, 0], [0, 0, 0, 0],
                                         [0, 1, 0, 0]])
    assert t[0].dtype == np.float32


def test_split_by_num_refuses_an_uneven_dim():
    inputs = {"X": [("x", _r(26, 2, 5))]}
    main = one_op_program(PORT, "split", inputs, {"Out": ["a", "b"]},
                          {"axis": 1, "num": 2, "sections": []})
    with pytest.raises(ValueError, match="equal pieces"):
        run_once(PORT, main, feed_of(PORT, inputs), ["a"])


# -- index ops ------------------------------------------------------------------

# small integers as float32: ties everywhere
_TIES = np.random.RandomState(27).randint(0, 3, (4, 6)).astype(np.float32)


@pytest.mark.parametrize("op,axis", [("arg_max", 1), ("arg_max", 0),
                                     ("arg_min", -1), ("arg_min", 0)])
def test_arg_max_min_match_jax_at_ties(op, axis):
    """The first index of the extreme at a tie; int64 in the port, int32
    in JAX (#26)."""
    j, t, names, _, _ = one_op(op, {"X": [("x", _TIES)]}, {"Out": ["o"]},
                               {"axis": axis})
    _assert_match(j, t, names, int64={"o"})
    fn = np.argmax if op == "arg_max" else np.argmin
    np.testing.assert_array_equal(t[0], fn(_TIES, axis=axis))


@pytest.mark.parametrize("axis", [-1, 0])
def test_argsort_is_stable_at_ties(axis):
    j, t, names, _, _ = one_op(
        "argsort", {"X": [("x", _TIES)]},
        {"Out": ["o"], "Indices": ["i"]}, {"axis": axis})
    _assert_match(j, t, names, int64={"i"})
    np.testing.assert_array_equal(
        t[1], np.argsort(_TIES, axis=axis, kind="stable"))


def test_shape_is_int64_with_the_jax_values():
    """ROADMAP Queue 3 #26: the declared int64 in the port, int32 in
    JAX; the values equal."""
    j, t, names, _, _ = one_op("shape", {"Input": [("x", _X)]},
                               {"Out": ["o"]})
    _assert_match(j, t, names, int64={"o"})
    assert t[0].tolist() == [2, 3, 4]


def _range_program(pkg, bounds, dtype):
    L = pkg.layers
    main = pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
        ins = [L.fill_constant([1], dtype, v) for v in bounds]
        blk = main.global_block()
        out = blk.create_var(name="r", dtype=None)
        blk.append_op(type="range",
                      inputs={"Start": [ins[0]], "End": [ins[1]],
                              "Step": [ins[2]]},
                      outputs={"Out": [out]})
        L.scale(out, scale=2.0)
    return main


@pytest.mark.parametrize("bounds,dtype", [((1.0, 7.0, 2.0), "float32"),
                                          ((10, -3, -4), "int32"),
                                          ((2.7, 5.9, 1.0), "float32")],
                         ids=["float", "int_down", "truncated"])
def test_range_matches_jax_on_the_hybrid_path(bounds, dtype):
    got = {}
    for pkg in PKGS:
        main = _range_program(pkg, bounds, dtype)
        got[pkg.name] = run_once(pkg, main, {}, ["r"])
    _assert_match([got["jax"][0]], [got["port"][0]], ["r"], int64={"r"})


# -- math ops -------------------------------------------------------------------

def test_maximum_splits_the_gradient_at_ties():
    x = _r(28, 3, 4)
    y = _r(29, 3, 4)
    y[0, :2] = x[0, :2]  # ties
    j, t, names, _, _ = one_op(
        "maximum", {"X": [("x", x)], "Y": [("y", y)]}, {"Out": ["o"]},
        diff=("x", "y"))
    _assert_match(j, t, names)
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32) / 12.0
    np.testing.assert_allclose(t[1][0, :2], w[0, :2] / 2, rtol=1e-6)
    np.testing.assert_allclose(t[2][0, :2], w[0, :2] / 2, rtol=1e-6)


@pytest.mark.parametrize("axis", [1, 0])
def test_norm_and_its_grad_match_jax(axis):
    j, t, names, _, _ = one_op(
        "norm", {"X": [("x", _r(30, 3, 4))]},
        {"Norm": ["n"], "Out": ["o"]}, {"axis": axis, "epsilon": 1e-10},
        diff=("x",), loss_of="o")
    _assert_match(j, t, names)


@pytest.mark.parametrize("fill,want", [(None, True), (np.inf, False),
                                       (np.nan, False), (-np.inf, False)],
                         ids=["finite", "inf", "nan", "-inf"])
def test_isfinite_over_a_list(fill, want):
    a, b = _r(31, 3, 4), _r(32, 5)
    if fill is not None:
        b[2] = fill
    j, t, names, _, _ = one_op("isfinite",
                               {"X": [("a", a), ("b", b)]}, {"Out": ["o"]})
    _assert_match(j, t, names)
    assert t[0].shape == () and t[0].dtype == np.bool_ and \
        bool(t[0]) is want


# matmul: (id, X shape, Y shape, attrs)
_MM = [
    ("nn", (2, 3, 4, 5), (2, 3, 5, 6), {}),
    ("tx", (2, 3, 5, 4), (2, 3, 5, 6), {"transpose_X": True}),
    ("ty", (2, 3, 4, 5), (2, 3, 6, 5), {"transpose_Y": True}),
    ("txty", (2, 3, 5, 4), (2, 3, 6, 5), {"transpose_X": True,
                                          "transpose_Y": True}),
    ("alpha_ty", (3, 4, 5), (3, 6, 5), {"transpose_Y": True,
                                        "alpha": 0.125}),
    ("bcast_2d_y", (2, 3, 4, 5), (5, 6), {}),
    ("bcast_batch", (3, 4, 5), (2, 1, 5, 6), {"alpha": 2.0}),
    ("bcast_ty", (4, 5), (2, 6, 5), {"transpose_Y": True}),
    ("vec_x", (5,), (5, 6), {}),
    ("vec_y", (4, 5), (5,), {}),
    ("vec_vec", (5,), (5,), {}),
    ("vec_y_tx", (5, 4), (5,), {"transpose_X": True}),
]


@pytest.mark.parametrize("xs,ys,attrs", [c[1:] for c in _MM],
                         ids=[c[0] for c in _MM])
def test_matmul_and_its_grad_match_jax(xs, ys, attrs):
    """Every transpose pair, batch dims broadcast (a broadcast operand's
    gradient summed over them), 1-D operands (the generic grad, as in
    JAX) and ``alpha``."""
    x, y = _r(33, *xs), _r(34, *ys)
    j, t, names, jmain, tmain = one_op(
        "matmul", {"X": [("x", x)], "Y": [("y", y)]}, {"Out": ["o"]},
        dict({"transpose_X": False, "transpose_Y": False, "alpha": 1.0},
             **attrs), diff=("x", "y"))
    _assert_match(j, t, names)
    assert t[1].shape == xs and t[2].shape == ys
    assert op_types(tmain) == op_types(jmain)
    grad = "generic_grad" if 1 in (len(xs), len(ys)) else "matmul_grad"
    assert grad in op_types(tmain)


def test_matmul_grad_matches_the_jax_vjp():
    """``matmul_grad`` with transposes, ``alpha`` and a broadcast Y
    against ``jax.vjp`` of ``alpha * jnp.matmul`` itself."""
    x, y = _r(35, 2, 3, 5, 4), _r(36, 6, 5)
    dy = _r(37, 2, 3, 4, 6)
    attrs = {"transpose_X": True, "transpose_Y": True, "alpha": 0.5}
    inputs = {"X": [("x", x)], "Y": [("y", y)], "Out@GRAD": [("d", dy)]}
    main = one_op_program(PORT, "matmul_grad", inputs,
                          {"X@GRAD": ["dx"], "Y@GRAD": ["dw"]}, attrs)
    dx, dw = run_once(PORT, main, feed_of(PORT, inputs), ["dx", "dw"])
    _, vjp = jax.vjp(lambda a, b: 0.5 * jnp.matmul(
        jnp.swapaxes(a, -1, -2), b.T), jnp.asarray(x), jnp.asarray(y))
    jdx, jdw = vjp(jnp.asarray(dy))
    assert rel(dx, np.asarray(jdx)) <= OP_TOL
    assert rel(dw, np.asarray(jdw)) <= OP_TOL


def _bf16_values(seed, *shape):
    """float32 values that bfloat16 holds exactly: the cast to bfloat16
    under AMP is exact in both packages, whatever XLA:CPU does with a
    float32 -> bfloat16 -> float32 round trip."""
    return _r(seed, *shape).astype(BF16).astype(np.float32)


def _bf16_ulp(m):
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


@pytest.fixture
def amp_forced():
    jprev, tprev = jamp.force(True), tamp.force(True)
    yield
    jamp.force(jprev)
    tamp.force(tprev)


@pytest.mark.parametrize("pure", [False, True], ids=["plain", "pure"])
@pytest.mark.parametrize("xs,ys,attrs", [
    ((2, 3, 8, 16), (2, 3, 8, 16), {"transpose_Y": True, "alpha": 0.125}),
    ((2, 8, 16), (16, 24), {}),
    ((16, 8), (16, 24), {"transpose_X": True, "alpha": 2.0}),
], ids=["qk", "bcast", "tx_alpha"])
def test_matmul_and_matmul_grad_under_amp_match_jax(amp_forced, pure, xs,
                                                    ys, attrs):
    """Under plain AMP a float32 output, under pure AMP a bfloat16 one,
    from bfloat16 products summed in float32; ``matmul_grad`` writes
    dX / dY in X's / Y's dtype."""
    x, y = _bf16_values(38, *xs), _bf16_values(39, *ys)
    attrs = dict({"transpose_X": False, "transpose_Y": False, "alpha": 1.0},
                 **attrs)
    fwd = {"X": [("x", x)], "Y": [("y", y)]}
    got = {}
    for pkg in PKGS:
        main = one_op_program(pkg, "matmul", fwd, {"Out": ["o"]}, attrs)
        (jamp if pkg is JAX else tamp).enable(main, pure=pure)
        got[pkg.name] = value_of(run_once(pkg, main, feed_of(pkg, fwd),
                                          ["o"])[0])
    j, t = got["jax"], got["port"]
    assert t.dtype == j.dtype == (BF16 if pure else np.float32)
    jm = np.abs(j.astype(np.float64))
    tol = _bf16_ulp(jm.max()) if pure else OP_TOL * max(1.0, jm.max())
    assert np.abs(t.astype(np.float64) - j.astype(np.float64)).max() <= tol
    dy = _bf16_values(40, *j.shape)
    bwd = dict(fwd, **{"Out@GRAD": [("d", dy)]})
    grads = {}
    for pkg in PKGS:
        main = one_op_program(pkg, "matmul_grad", bwd,
                              {"X@GRAD": ["dx"], "Y@GRAD": ["dw"]}, attrs)
        (jamp if pkg is JAX else tamp).enable(main, pure=pure)
        grads[pkg.name] = [value_of(v) for v in run_once(
            pkg, main, feed_of(pkg, bwd), ["dx", "dw"])]
    for jg, tg in zip(grads["jax"], grads["port"]):
        assert tg.dtype == jg.dtype == np.float32
        assert rel(tg, jg) <= OP_TOL


# -- random ops ----------------------------------------------------------------

DRAWS = 1 << 16


def _random_run(pkg, op, inputs, attrs, seed=11):
    main = one_op_program(pkg, op, inputs, {"Out": ["o"]}, attrs)
    main.random_seed = seed
    return value_of(run_once(pkg, main, feed_of(pkg, inputs), ["o"])[0])


def _moments_ok(a, mean, var, lo=None, hi=None):
    """Shape-free checks: bounds, and the mean and variance within 5
    standard errors of the law's (the fourth moment taken as 3 var^2)."""
    a = a.astype(np.float64).reshape(-1)
    n = a.size
    if lo is not None:
        assert a.min() >= lo and a.max() <= hi
    assert abs(a.mean() - mean) <= 5 * math.sqrt(var / n), a.mean()
    assert abs(a.var() - var) <= 5 * math.sqrt(2 * var * var / n), a.var()


_TRUNC_VAR = 1.0 - 4.0 * math.exp(-2.0) / (
    math.sqrt(2 * math.pi) * math.erf(2.0 / math.sqrt(2.0)))

RANDOM = [
    ("uniform_random_batch_size_like",
     {"Input": [("ref", np.zeros((DRAWS // 4, 3), np.float32))]},
     {"shape": [-1, 4], "min": -2.0, "max": 3.0, "dtype": "float32"},
     (DRAWS // 4, 4), (0.5, 25.0 / 12.0, -2.0, 3.0)),
    ("gaussian_random_batch_size_like",
     {"Input": [("ref", np.zeros((2, DRAWS // 8), np.float32))]},
     {"shape": [8, -1], "input_dim_idx": 1, "output_dim_idx": 1,
      "mean": 1.5, "std": 0.5, "dtype": "float32"},
     (8, DRAWS // 8), (1.5, 0.25, None, None)),
    ("truncated_gaussian_random", {},
     {"shape": [DRAWS // 16, 16], "mean": 1.0, "std": 2.0,
      "dtype": "float32"},
     (DRAWS // 16, 16), (1.0, 4.0 * _TRUNC_VAR, -3.0, 5.0)),
]


@pytest.mark.parametrize("op,inputs,attrs,shape,law", [c for c in RANDOM],
                         ids=[c[0] for c in RANDOM])
def test_random_op_agrees_with_jax_in_distribution(op, inputs, attrs, shape,
                                                   law):
    """Both packages' 2^16 draws have the op's shape, bounds, mean and
    variance; the port's two runs from one seed are equal and another
    seed draws anew."""
    mean, var, lo, hi = law
    for pkg in PKGS:
        a = _random_run(pkg, op, inputs, attrs)
        assert a.shape == shape and a.dtype == np.float32, pkg.name
        _moments_ok(a, mean, var, lo, hi)
    a = _random_run(PORT, op, inputs, attrs)
    np.testing.assert_array_equal(a, _random_run(PORT, op, inputs, attrs))
    assert not np.array_equal(a, _random_run(PORT, op, inputs, attrs,
                                             seed=12))


def test_sampling_id_follows_its_weights():
    """One-hot rows give their hot index; rows of weights 1:2:5 (not
    normalized) give each id at its share of 2^16 draws, within 5
    standard errors, in both packages."""
    hot = np.eye(5, dtype=np.float32)[[3, 0, 4, 1]]
    for pkg in PKGS:
        got = _random_run(pkg, "sampling_id", {"X": [("x", hot)]}, {})
        assert got.tolist() == [3, 0, 4, 1], pkg.name
    w = np.tile(np.array([[1.0, 2.0, 5.0]], np.float32), (DRAWS, 1))
    p = np.array([1.0, 2.0, 5.0]) / 8.0
    for pkg in PKGS:
        ids = _random_run(pkg, "sampling_id", {"X": [("x", w)]}, {})
        assert ids.dtype == (np.int64 if pkg is PORT else np.int32)
        share = np.bincount(ids, minlength=3) / DRAWS
        assert np.all(np.abs(share - p) <= 5 * np.sqrt(p * (1 - p) / DRAWS))
    a = _random_run(PORT, "sampling_id", {"X": [("x", w[:64])]}, {})
    np.testing.assert_array_equal(
        a, _random_run(PORT, "sampling_id", {"X": [("x", w[:64])]}, {}))
