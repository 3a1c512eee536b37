"""The 17 op types of the rest of the conv-net path in the port against
the JAX package on the CPU: ``prelu``, ``log_softmax``, ``maxout``,
``dropout`` with ``dropout_grad``, ``depthwise_conv2d``,
``conv2d_transpose``, ``conv3d``, ``conv3d_transpose``, ``pool3d``,
``lrn``, ``l2_normalize``, ``scale_sub_region`` and the metric ops
``auc``, ``precision_recall``, ``edit_distance`` and
``positive_negative_pair``.

- Registration: each is registered in both packages with the same
  ``no_gradient`` setting and the same kind of grad maker.
- Each op alone in a program of each package (``torch_optim.one_op``),
  fed the same seeded arrays; where it has a gradient, also the
  gradients of mean(out * w) through each package's backward. Every
  output and gradient within ``OP_TOL`` (1e-6) of max(1, |the JAX
  value|); counts and indices exactly.
- ``dropout``'s training mask is drawn from each package's own generator,
  so the two agree in distribution only (ROADMAP.md Queue 3 #28): it is
  held to its rate over 2^16 draws within 4 standard errors, and two
  runs from one seed are equal; ``is_test`` and ``dropout_grad`` on one
  fed mask are bit-identical to JAX's, and a compiled step draws a new
  mask at each run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.core import registry as jregistry  # noqa: E402
import paddle_tpu.ops  # noqa: E402,F401
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import registry as tregistry  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
import paddle_tpu_torch.ops  # noqa: E402,F401
from torch_optim import OP_TOL, one_op, rel, value_of  # noqa: E402

NEW_OPS = ("prelu", "log_softmax", "maxout", "dropout", "dropout_grad",
           "depthwise_conv2d", "conv2d_transpose", "conv3d_transpose",
           "conv3d", "pool3d", "lrn", "l2_normalize", "scale_sub_region",
           "auc", "precision_recall", "edit_distance",
           "positive_negative_pair")
MASK_DRAWS = 1 << 16


def test_the_17_ops_are_registered_as_in_jax():
    for op in NEW_OPS:
        j, t = jregistry.lookup(op), tregistry.lookup(op)
        assert j is not None and t is not None, op
        assert t.no_gradient == j.no_gradient, op
        assert (t.grad_maker is None) == (j.grad_maker is None), op
        if j.grad_maker is not None:
            assert t.grad_maker.__name__ == j.grad_maker.__name__, op
        assert (t.infer_shape is None) == (j.infer_shape is None), op
    for op in ("auc", "precision_recall", "edit_distance",
               "positive_negative_pair"):
        assert tregistry.lookup(op).no_gradient
    # the port's own lowerings (a test may register an op of its own)
    port = [op for op in tregistry.registered_ops() if tregistry.lookup(
        op).lower.__module__.startswith("paddle_tpu_torch.")]
    assert len(port) == 233 and set(port) <= set(jregistry.registered_ops())


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _ints(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


_X = _r(1, 2, 4, 5, 5)
_V = _r(2, 2, 4, 5, 5, 5)
_ZROW = _r(3, 3, 4)
_ZROW[1] = 0.0
_P = np.random.RandomState(4).rand(40).astype(np.float32)

# name -> (op, inputs, outputs, attrs, diff)
CASES = {
    "prelu_all": ("prelu", {"X": [("x", _X)], "Alpha": [
        ("a", np.array([0.2], np.float32))]}, {"Out": ["o"]},
        {"mode": "all"}, ("x", "a")),
    "prelu_channel": ("prelu", {"X": [("x", _X)], "Alpha": [
        ("a", np.array([0.2, 0.3, 0.1, 0.5], np.float32))]},
        {"Out": ["o"]}, {"mode": "channel"}, ("x", "a")),
    "prelu_element": ("prelu", {"X": [("x", _X)], "Alpha": [
        ("a", _r(5, 4, 5, 5))]}, {"Out": ["o"]}, {"mode": "element"},
        ("x", "a")),
    "log_softmax": ("log_softmax", {"X": [("x", _r(6, 3, 7))]},
                    {"Out": ["o"]}, {}, ("x",)),
    "maxout": ("maxout", {"X": [("x", _X)]}, {"Out": ["o"]},
               {"groups": 2}, ("x",)),
    "lrn": ("lrn", {"X": [("x", _X)]}, {"Out": ["o"], "MidOut": ["m"]},
            {"n": 5, "k": 2.0, "alpha": 1e-2, "beta": 0.75}, ("x",)),
    "lrn_n3": ("lrn", {"X": [("x", _r(7, 2, 6, 3, 3))]},
               {"Out": ["o"], "MidOut": ["m"]},
               {"n": 3, "k": 1.0, "alpha": 0.1, "beta": 0.5}, ("x",)),
    "l2_normalize_zero_row": ("l2_normalize", {"X": [("x", _ZROW)]},
                              {"Out": ["o"]},
                              {"axis": 1, "epsilon": 1e-12}, ("x",)),
    "l2_normalize_axis0": ("l2_normalize", {"X": [("x", _r(8, 3, 4))]},
                           {"Out": ["o"]}, {"axis": 0, "epsilon": 1e-10},
                           ("x",)),
    "scale_sub_region": ("scale_sub_region", {"X": [("x", _X)], "Indices": [
        ("i", np.array([[1, 2, 2, 4, 1, 3], [2, 4, 1, 5, 3, 5]], np.int64))]},
        {"Out": ["o"]}, {"value": 2.5}, ("x",)),
    "depthwise_conv2d": ("depthwise_conv2d", {
        "Input": [("x", _X)], "Filter": [("w", _r(9, 4, 1, 3, 3))]},
        {"Output": ["o"]}, {"strides": [1, 1], "paddings": [1, 1],
                            "dilations": [1, 1], "groups": 4}, ("x", "w")),
    "depthwise_conv2d_mult2_stride2": ("depthwise_conv2d", {
        "Input": [("x", _X)], "Filter": [("w", _r(10, 8, 1, 3, 3))]},
        {"Output": ["o"]}, {"strides": [2, 2], "paddings": [1, 0],
                            "dilations": [1, 2], "groups": 4}, ("x", "w")),
    "conv2d_transpose": ("conv2d_transpose", {
        "Input": [("x", _X)], "Filter": [("w", _r(11, 4, 3, 3, 3))]},
        {"Output": ["o"]}, {"strides": [2, 2], "paddings": [1, 1],
                            "dilations": [1, 1]}, ("x", "w")),
    "conv2d_transpose_dilated_grouped": ("conv2d_transpose", {
        "Input": [("x", _X)], "Filter": [("w", _r(12, 4, 3, 3, 2))]},
        {"Output": ["o"]}, {"strides": [2, 3], "paddings": [1, 0],
                            "dilations": [2, 1], "groups": 2}, ("x", "w")),
    "conv3d": ("conv3d", {"Input": [("x", _V)],
                          "Filter": [("w", _r(13, 6, 4, 3, 3, 3))]},
               {"Output": ["o"]}, {"strides": [1, 1, 1],
                                   "paddings": [1, 1, 1],
                                   "dilations": [1, 1, 1], "groups": 1},
               ("x", "w")),
    "conv3d_strided_dilated_grouped": ("conv3d", {
        "Input": [("x", _V)], "Filter": [("w", _r(14, 6, 2, 3, 3, 3))]},
        {"Output": ["o"]}, {"strides": [2, 1, 1], "paddings": [1, 0, 1],
                            "dilations": [1, 1, 2], "groups": 2},
        ("x", "w")),
    "conv3d_transpose": ("conv3d_transpose", {
        "Input": [("x", _V)], "Filter": [("w", _r(15, 4, 2, 2, 2, 2))]},
        {"Output": ["o"]}, {"strides": [2, 2, 2], "paddings": [0, 0, 0],
                            "dilations": [1, 1, 1]}, ("x", "w")),
    "conv3d_transpose_dilated_grouped": ("conv3d_transpose", {
        "Input": [("x", _V)], "Filter": [("w", _r(16, 4, 3, 2, 3, 2))]},
        {"Output": ["o"]}, {"strides": [2, 1, 2], "paddings": [0, 1, 1],
                            "dilations": [1, 2, 1], "groups": 2},
        ("x", "w")),
    "pool3d_max": ("pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
                   {"pooling_type": "max", "ksize": [2, 2, 2],
                    "strides": [2, 2, 2], "paddings": [0, 0, 0]}, ("x",)),
    "pool3d_max_ceil_pad": ("pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
                            {"pooling_type": "max", "ksize": [3, 3, 2],
                             "strides": [2, 2, 2], "paddings": [1, 1, 0],
                             "ceil_mode": True}, ("x",)),
    "pool3d_avg": ("pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
                   {"pooling_type": "avg", "ksize": [2, 3, 2],
                    "strides": [1, 2, 2], "paddings": [0, 0, 0]}, ("x",)),
    "pool3d_avg_pad": ("pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
                       {"pooling_type": "avg", "ksize": [3, 3, 3],
                        "strides": [2, 2, 2], "paddings": [1, 1, 1]},
                       ("x",)),
    "pool3d_avg_ceil_pad": ("pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
                            {"pooling_type": "avg", "ksize": [3, 2, 3],
                             "strides": [2, 2, 2], "paddings": [1, 0, 1],
                             "ceil_mode": True}, ("x",)),
    # the ceil extra makes the last depth window all padding: JAX's
    # explicit padding gives its cells 0 / 0 (NaN) and -inf, where
    # F.avg_pool3d(ceil_mode=True) would drop the window
    "pool3d_avg_ceil_window_in_padding": (
        "pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
        {"pooling_type": "avg", "ksize": [3, 2, 3], "strides": [3, 2, 2],
         "paddings": [1, 0, 1], "ceil_mode": True}, ()),
    "pool3d_max_ceil_window_in_padding": (
        "pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
        {"pooling_type": "max", "ksize": [3, 2, 3], "strides": [3, 2, 2],
         "paddings": [1, 0, 1], "ceil_mode": True}, ()),
    "pool3d_avg_ceil": ("pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
                        {"pooling_type": "avg", "ksize": [2, 2, 2],
                         "strides": [2, 2, 2], "paddings": [0, 0, 0],
                         "ceil_mode": True}, ("x",)),
    "pool3d_global_avg": ("pool3d", {"X": [("x", _V)]}, {"Out": ["o"]},
                          {"pooling_type": "avg", "ksize": [1, 1, 1],
                           "global_pooling": True}, ("x",)),
    "dropout_is_test": ("dropout", {"X": [("x", _X)]},
                        {"Out": ["o"], "Mask": ["m"]},
                        {"dropout_prob": 0.3, "is_test": True}, ("x",)),
    "dropout_grad_fed_mask": ("dropout_grad", {
        "Mask": [("m", (np.random.RandomState(17).rand(2, 4, 5, 5) >= 0.3)
                  .astype(np.float32))], "Out@GRAD": [("g", _X)]},
        {"X@GRAD": ["o"]}, {"dropout_prob": 0.3}, ()),
    "auc": ("auc", {"Out": [("p", np.stack([1 - _P, _P], 1))],
                    "Label": [("l", _ints(18, 2, 40, 1))]},
            {"AUC": ["a"]}, {"num_thresholds": 200}, ()),
    "auc_one_column_64_thresholds": ("auc", {
        "Out": [("p", _P.reshape(-1, 1))],
        "Label": [("l", _ints(19, 2, 40, 1))]},
        {"AUC": ["a"]}, {"num_thresholds": 64}, ()),
    "precision_recall": ("precision_recall", {
        "MaxProbs": [("mp", np.random.RandomState(20).rand(9, 1)
                      .astype(np.float32))],
        "Indices": [("i", _ints(21, 4, 9, 1))],
        "Labels": [("l", _ints(22, 4, 9, 1))]},
        {"BatchMetrics": ["b"]}, {"class_number": 4}, ()),
    # class ids out of range, read as JAX's gather reads them
    "precision_recall_ids_out_of_range": ("precision_recall", {
        "MaxProbs": [("mp", np.random.RandomState(36).rand(6, 1)
                      .astype(np.float32))],
        "Indices": [("i", np.array([[0], [5], [-1], [2], [-4], [1]],
                                   np.int64))],
        "Labels": [("l", np.array([[0], [2], [3], [-2], [1], [9]],
                                  np.int64))]},
        {"BatchMetrics": ["b"]}, {"class_number": 3}, ()),
    "edit_distance": ("edit_distance", {
        "Hyps": [("h", _ints(23, 4, 3, 6))],
        "Refs": [("rf", _ints(24, 4, 3, 4))]},
        {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": False}, ()),
    "edit_distance_normalized_unequal": ("edit_distance", {
        "Hyps": [("h", _ints(25, 3, 4, 3))],
        "Refs": [("rf", _ints(26, 3, 4, 7))]},
        {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": True}, ()),
    "edit_distance_one_row": ("edit_distance", {
        "Hyps": [("h", _ints(27, 5, 8))], "Refs": [("rf", _ints(28, 5, 5))]},
        {"Out": ["o"], "SequenceNum": ["n"]}, {"normalized": True}, ()),
    "positive_negative_pair_query_id": ("positive_negative_pair", {
        "Score": [("s", np.round(np.random.RandomState(29).rand(12, 1), 1)
                   .astype(np.float32))],
        "Label": [("l", _ints(30, 3, 12, 1).astype(np.float32))],
        "QueryID": [("q", _ints(31, 3, 12, 1))]},
        {"PositivePair": ["a"], "NegativePair": ["b"],
         "NeutralPair": ["c"]}, {}, ()),
    "positive_negative_pair_lod": ("positive_negative_pair", {
        "Score": [("s", (np.round(np.random.RandomState(32).rand(9, 1), 1)
                         .astype(np.float32), [[0, 4, 4, 9]]))],
        "Label": [("l", _ints(33, 3, 9, 1).astype(np.float32))]},
        {"PositivePair": ["a"], "NegativePair": ["b"],
         "NeutralPair": ["c"]}, {}, ()),
}

# outputs compared exactly: counts, distances, masks, selections (a
# normalized distance is a float quotient: XLA may divide by a
# reciprocal, so it is held to OP_TOL)
EXACT = ("edit_distance", "positive_negative_pair", "maxout",
         "scale_sub_region", "dropout", "dropout_grad")


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_and_grad_match_jax(name):
    op, ins, outs, attrs, diff = CASES[name]
    jax_got, port_got, fetch, _, _ = one_op(op, ins, outs, attrs,
                                            diff=diff)
    for n, j, t in zip(fetch, jax_got, port_got):
        j, t = value_of(j), value_of(t)
        assert t.shape == j.shape, (n, t.shape, j.shape)
        exact = op in EXACT and not attrs.get("normalized")
        if exact or not np.issubdtype(j.dtype, np.floating):
            np.testing.assert_array_equal(t, j, err_msg=n)
            continue
        # cells that are not finite (a window wholly in padding) agree
        # in place and value
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        np.testing.assert_array_equal(t[~np.isfinite(j)],
                                      j[~np.isfinite(j)])
        ok = np.isfinite(j)
        assert rel(t[ok], j[ok]) <= OP_TOL, (n, rel(t[ok], j[ok]))
    if op == "edit_distance":
        # SequenceNum is int64 as declared (ROADMAP.md Queue 3 #26)
        assert value_of(port_got[1]).dtype == np.int64


def _dropout_program(p, is_test=False, seed=11, n=MASK_DRAWS):
    main = tir.Program()
    main.random_seed = seed
    blk = main.global_block()
    blk.create_var(name="x", shape=(n,), dtype="float32")
    for name in ("o", "m"):
        blk.create_var(name=name, dtype="float32")
    blk.append_op(type="dropout", inputs={"X": ["x"]},
                  outputs={"Out": ["o"], "Mask": ["m"]},
                  attrs={"dropout_prob": p, "is_test": is_test})
    return main


@pytest.mark.parametrize("p", [0.1, 0.5, 0.75])
def test_dropout_mask_rate_and_a_seeded_rerun(p):
    """2^16 draws keep 1 - p of X within 4 standard errors; Out = X *
    Mask exactly; a second run from the same seed draws the same mask."""
    main = _dropout_program(p)
    x = np.random.RandomState(5).rand(MASK_DRAWS).astype(np.float32) + 1.0
    runs = [TExecutor("cpu").run(main, feed={"x": x}, fetch_list=["o", "m"],
                                 scope=TScope()) for _ in range(2)]
    (o, m), (o2, m2) = runs
    assert set(np.unique(m)) <= {0.0, 1.0}
    kept = m.mean()
    se = np.sqrt(p * (1 - p) / MASK_DRAWS)
    assert abs(kept - (1 - p)) <= 4 * se, (kept, 1 - p, se)
    np.testing.assert_array_equal(o, x * m)
    np.testing.assert_array_equal(m, m2)
    np.testing.assert_array_equal(o, o2)


def test_dropout_draws_a_new_mask_at_each_compiled_run():
    """One scope, one compiled step key: every run draws anew from the
    scope's generator (on the card, each replay of the captured graph;
    ``tests/test_torch_convnet_ops_cuda.py``)."""
    main = _dropout_program(0.5, n=4096)
    x = np.ones(4096, np.float32)
    exe, scope = TExecutor("cpu"), TScope()
    masks = [exe.run(main, feed={"x": x}, fetch_list=["m"], scope=scope)[0]
             for _ in range(4)]
    assert exe.stats["jit_runs"] == 4 and exe.stats["eager_runs"] == 0
    for a in range(4):
        for b in range(a):
            assert not np.array_equal(masks[a], masks[b]), (a, b)


def test_dropout_trains_through_its_mask():
    """The backward of a training dropout is ``dropout_grad`` on the saved
    Mask: X@GRAD = w * Mask / numel for a mean(Out * w) loss."""
    from torch_optim import PORT
    main = PORT.Program()
    with PORT.unique_name.guard(), PORT.program_guard(main, PORT.Program()):
        x = PORT.layers.data("x", shape=[6, 5], dtype="float32",
                             append_batch_size=False)
        x.stop_gradient = False
        out = PORT.layers.dropout(x, dropout_prob=0.4)
        w = PORT.layers.data("w", shape=[6, 5], dtype="float32",
                             append_batch_size=False)
        PORT.append_backward(PORT.layers.mean(
            PORT.layers.elementwise_mul(out, w)))
    types = [op.type for op in main.global_block().ops]
    assert "dropout_grad" in types
    mask_name = next(op for op in main.global_block().ops
                     if op.type == "dropout").output("Mask")[0]
    feed = {"x": _r(34, 6, 5), "w": _r(35, 6, 5)}
    m, g = TExecutor("cpu").run(main, feed=feed,
                                fetch_list=[mask_name, "x@GRAD"],
                                scope=TScope())
    np.testing.assert_allclose(g, feed["w"] * m / 30.0, rtol=1e-6)
