"""The 12 losses of the dense slice against their JAX lowerings, on the
CPU: ``sigmoid_cross_entropy_with_logits``, ``squared_l2_distance``,
``label_smooth``, ``l1_norm``, ``modified_huber_loss``, ``hinge_loss``,
``huber_loss``, ``smooth_l1_loss``, ``log_loss``, ``rank_loss``,
``margin_rank_loss`` and ``cos_sim``, each with every output and the
gradient of every float input (the generic grad in both packages).

Each case runs the op alone in a program of each package
(``torch_optim.one_op``) on the same seeded numpy inputs, a gradient
from each package's ``append_backward`` of mean(out * w), w a seeded
feed. Every float output and gradient is within 1e-6 of max(1, |the
JAX value|) (``OP_TOL``), and an inf or NaN stands where JAX's does.
The inputs reach each formula's edges: ties of a max(0, .) (each side
half the gradient, as ``jnp.maximum`` gives it), the pieces of the
Huber losses, and ``rank_loss`` past float32's ``exp`` at d of 88.7.

Between d of 85 and 88.7 ``rank_loss``'s gradient passes through a
subnormal float32 (dOut / (1 + e^d)), which XLA:CPU flushes to zero and
torch keeps: there the test holds the port's gradient to the float64
value instead of JAX's (:func:`test_rank_loss_overflows_where_jax_does`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_optim import OP_TOL, one_op, op_types, rel, value_of  # noqa: E402


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _u(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _bits(seed, *shape):
    return np.random.RandomState(seed).randint(0, 2, shape).astype(
        np.float32)


_TIE_X = _r(1, 4, 5)
_TIE_X[0, :3] = 0.0  # max(x, 0) at its tie

_MH_X = np.array([[-2.5], [-1.0], [-0.4], [0.3], [0.99], [1.0], [2.0],
                  [-0.7]], np.float32)
_MH_Y = np.array([[1], [1], [0], [1], [1], [0], [1], [0]], np.float32)

_HINGE_L = np.array([[1.0], [-1.0], [0.3], [2.0], [-0.5], [1.0]],
                    np.float32)
_HINGE_Y = np.array([[1], [0], [1], [0], [0], [1]], np.float32)

_RANK_LEFT = np.array([[80.0], [84.0], [-60.0], [89.0], [-89.0], [0.5],
                       [-3.0], [100.0]], np.float32)
_RANK_RIGHT = np.zeros((8, 1), np.float32)
_RANK_LABEL = np.array([[1], [0], [1], [0], [1], [0], [1], [1]],
                       np.float32)

_MARGIN_X1 = _r(2, 6, 1)
_MARGIN_X2 = _MARGIN_X1.copy()
_MARGIN_X2[3:] = _r(3, 3, 1)  # rows 0-2: -label (x1 - x2) + 0 = 0, ties

# (id, op, inputs, outputs, attrs, diff, loss_of)
LOSSES = [
    ("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": [("x", _TIE_X)], "Label": [("l", _u(4, 4, 5))]},
     {"Out": ["o"]}, {}, ("x",), None),
    ("squared_l2_distance", "squared_l2_distance",
     {"X": [("x", _r(5, 4, 5))], "Y": [("y", _r(6, 4, 5))]},
     {"sub_result": ["s"], "Out": ["o"]}, {}, ("x", "y"), "o"),
    ("squared_l2_distance_row_y", "squared_l2_distance",
     {"X": [("x", _r(7, 4, 5))], "Y": [("y", _r(8, 1, 5))]},
     {"sub_result": ["s"], "Out": ["o"]}, {}, ("x", "y"), "o"),
    ("label_smooth_uniform", "label_smooth",
     {"X": [("x", _bits(9, 4, 5))]}, {"Out": ["o"]}, {"epsilon": 0.1},
     ("x",), None),
    ("label_smooth_prior", "label_smooth",
     {"X": [("x", _bits(10, 4, 5))],
      "PriorDist": [("p", np.arange(1, 6, dtype=np.float32)[None] / 15)]},
     {"Out": ["o"]}, {"epsilon": 0.2}, ("x", "p"), None),
    ("l1_norm", "l1_norm", {"X": [("x", _TIE_X)]}, {"Out": ["o"]}, {},
     ("x",), None),
    ("modified_huber_loss", "modified_huber_loss",
     {"X": [("x", _MH_X)], "Y": [("y", _MH_Y)]},
     {"IntermediateVal": ["v"], "Out": ["o"]}, {}, ("x",), "o"),
    ("hinge_loss", "hinge_loss",
     {"Logits": [("x", _HINGE_L)], "Labels": [("y", _HINGE_Y)]},
     {"Loss": ["o"]}, {}, ("x",), None),
    ("huber_loss", "huber_loss",
     {"X": [("x", _r(11, 6, 3) * 2)], "Y": [("y", _r(12, 6, 3))]},
     {"Residual": ["r"], "Out": ["o"]}, {"delta": 1.0}, ("x", "y"), "o"),
    ("smooth_l1_loss", "smooth_l1_loss",
     {"X": [("x", _r(13, 4, 6))], "Y": [("y", _r(14, 4, 6))]},
     {"Diff": ["d"], "Out": ["o"]}, {"sigma": 2.0}, ("x", "y"), "o"),
    ("smooth_l1_loss_weights", "smooth_l1_loss",
     {"X": [("x", _r(15, 4, 2, 3))], "Y": [("y", _r(16, 4, 2, 3))],
      "InsideWeight": [("iw", _u(17, 4, 2, 3))],
      "OutsideWeight": [("ow", _u(18, 4, 2, 3))]},
     {"Diff": ["d"], "Out": ["o"]}, {"sigma": 1.0}, ("x",), "o"),
    ("log_loss", "log_loss",
     {"Predicted": [("p", _u(19, 6, 1) * 0.9 + 0.05)],
      "Labels": [("y", _bits(20, 6, 1))]},
     {"Loss": ["o"]}, {"epsilon": 1e-4}, ("p",), None),
    ("rank_loss_near_overflow", "rank_loss",
     {"Label": [("l", _RANK_LABEL)], "Left": [("a", _RANK_LEFT)],
      "Right": [("b", _RANK_RIGHT)]},
     {"Out": ["o"]}, {}, ("a", "b"), None),
    ("margin_rank_loss", "margin_rank_loss",
     {"Label": [("l", np.array([[1], [-1], [1], [-1], [1], [-1]],
                               np.float32))],
      "X1": [("x1", _MARGIN_X1)], "X2": [("x2", _MARGIN_X2)]},
     {"Out": ["o"], "Activated": ["act"]}, {"margin": 0.0},
     ("x1", "x2"), "o"),
    ("margin_rank_loss_margin", "margin_rank_loss",
     {"Label": [("l", np.array([[1], [-1], [1], [-1]], np.float32))],
      "X1": [("x1", _r(21, 4, 1))], "X2": [("x2", _r(22, 4, 1))]},
     {"Out": ["o"], "Activated": ["act"]}, {"margin": 0.1},
     ("x1", "x2"), "o"),
    ("cos_sim", "cos_sim",
     {"X": [("x", _r(23, 4, 5))], "Y": [("y", _r(24, 4, 5))]},
     {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {}, ("x", "y"),
     "o"),
    ("cos_sim_row_y", "cos_sim",
     {"X": [("x", _r(25, 4, 5))], "Y": [("y", _r(26, 1, 5))]},
     {"Out": ["o"], "XNorm": ["xn"], "YNorm": ["yn"]}, {}, ("x", "y"),
     "o"),
]


def _assert_close(j, t, names):
    """Same shape and dtype; the same inf and NaN places, and the finite
    values within OP_TOL of max(1, the largest finite JAX magnitude)."""
    for n, jv, tv in zip(names, j, t):
        ja, ta = value_of(jv), value_of(tv)
        assert ta.shape == ja.shape and ta.dtype == ja.dtype, \
            (n, ta.shape, ja.shape, ta.dtype, ja.dtype)
        np.testing.assert_array_equal(np.isnan(ta), np.isnan(ja), n)
        np.testing.assert_array_equal(np.isinf(ta), np.isinf(ja), n)
        np.testing.assert_array_equal(ta[np.isinf(ta)], ja[np.isinf(ja)], n)
        fin = np.isfinite(ja)
        assert rel(ta[fin], ja[fin]) <= OP_TOL, (n, rel(ta[fin], ja[fin]))


@pytest.mark.parametrize("case", LOSSES, ids=[c[0] for c in LOSSES])
def test_loss_and_its_grads_match_jax(case):
    _, op, inputs, outputs, attrs, diff, loss_of = case
    j, t, names, jmain, tmain = one_op(op, inputs, outputs, attrs, diff,
                                       loss_of)
    _assert_close(j, t, names)
    assert op_types(tmain) == op_types(jmain)
    assert "generic_grad" in op_types(tmain)


def test_rank_loss_overflows_where_jax_does():
    """``log1p(exp(d))`` is kept as the reference writes it: inf past d
    of 88.7 in float32 (and a NaN gradient there), in both packages.
    Below that the loss matches JAX's; the gradient in the subnormal
    band matches the float64 one, where XLA:CPU's is flushed."""
    left = np.array([[86.0], [87.0], [88.0], [88.5], [88.7], [88.8],
                     [89.0]], np.float32)
    label = np.array([[1], [0], [1], [0], [1], [0], [1]], np.float32)
    j, t, _, _, _ = one_op(
        "rank_loss", {"Label": [("l", label)], "Left": [("a", left)],
                      "Right": [("b", np.zeros_like(left))]},
        {"Out": ["o"]}, diff=("a",))
    _assert_close(j[:1], t[:1], ["o"])
    out = value_of(t[0]).reshape(-1)
    assert np.isfinite(out[:5]).all() and np.isinf(out[5:]).all()
    w = np.random.RandomState(0).randn(7, 1).astype(np.float64) / 7.0
    d = left.astype(np.float64)
    want = w * (1.0 / (1.0 + np.exp(-d)) - label)
    got = value_of(t[1])
    assert np.abs(got[:5] - want[:5]).max() <= OP_TOL
    assert np.isnan(got[5:]).all() and np.isnan(value_of(j[1])[5:]).all()


def test_max_zero_ties_split_the_gradient():
    """At max(0, v) with v = 0 each side gets half, as ``jnp.maximum``
    gives: the margin rank loss of equal X1 and X2 with margin 0."""
    case = next(c for c in LOSSES if c[0] == "margin_rank_loss")
    _, op, inputs, outputs, attrs, diff, loss_of = case
    j, t, _, _, _ = one_op(op, inputs, outputs, attrs, diff, loss_of)
    w = np.random.RandomState(0).randn(6, 1).astype(np.float32) / 6.0
    label = inputs["Label"][0][1]
    # d out / d x1 = -label where v > 0; half of it at the tie
    np.testing.assert_allclose(value_of(t[2])[:3],
                               -0.5 * label[:3] * w[:3], rtol=1e-6)
    np.testing.assert_array_equal(value_of(t[1])[:3], 0.0)
