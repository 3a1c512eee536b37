"""``split_lod_tensor`` / ``merge_lod_tensor`` and the row-masked IfElse
of the port against the JAX package, on the CPU: twins of
``tests/test_split_merge_lod.py`` but ``test_split_selected_rows_op``
(the selected-rows op is in ROADMAP Queue 1 item 5c).

Each program is built alike in both packages, run in the JAX package as
its test runs it and in the port on the compiled and the per-op path
(``test_torch_control_flow.twin``): values within 1e-5 of max(1,
|the JAX value|), LoD equal, the runs' paths equal. The fixed-capacity
contract holds on every path: the chosen rows stably first, a zero
tail; merge inverts split on the real rows. A LoD input splits whole
sequences on the host's copy of its offsets, which a compiled step
cannot read: such a program runs per-op.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.core import lod as tlod  # noqa: E402
from test_torch_control_flow import LOD, run_port, twin  # noqa: E402
from torch_optim import PORT, build  # noqa: E402


def _np_split(x, mask):
    out_t, out_f = np.zeros_like(x), np.zeros_like(x)
    out_t[:mask.sum()] = x[mask]
    out_f[:(~mask).sum()] = x[~mask]
    return out_t, out_f


def _split_dense(pkg):
    L = pkg.layers
    x = L.data("x", shape=[3], append_batch_size=False)
    m = L.data("m", shape=[5], dtype="bool", append_batch_size=False)
    return list(L.split_lod_tensor(x, m))


def test_split_dense_compacts_and_zero_pads():
    xv = np.arange(15, dtype=np.float32).reshape(5, 3)
    mv = np.array([True, False, True, False, True])
    twin(_split_dense, lambda pkg: [{"x": xv, "m": mv}])
    main, start, fetch = build(PORT, _split_dense)
    (t, _), (f, _) = run_port(main, start, [{"x": xv, "m": mv}],
                              [v.name for v in fetch])[0][0]
    want_t, want_f = _np_split(xv, mv)
    np.testing.assert_array_equal(t, want_t)
    np.testing.assert_array_equal(f, want_f)


def _merge_split(pkg):
    L = pkg.layers
    x = L.data("x", shape=[2], append_batch_size=False)
    m = L.data("m", shape=[6], dtype="bool", append_batch_size=False)
    t, f = L.split_lod_tensor(x, m)
    return [L.merge_lod_tensor(in_true=t, in_false=f, x=x, mask=m)]


def test_merge_inverts_split():
    xv = np.random.RandomState(7).randn(6, 2).astype(np.float32)
    feeds = [{"x": xv, "m": np.array(p, dtype=bool)}
             for p in ([1, 1, 0, 0, 1, 0], [0] * 6, [1] * 6)]
    twin(_merge_split, lambda pkg: feeds)
    main, start, fetch = build(PORT, _merge_split)
    for run in run_port(main, start, feeds, [fetch[0].name])[0]:
        np.testing.assert_array_equal(run[0][0], xv)


def _split_merge_grad(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4, 3], append_batch_size=False)
    x.stop_gradient = False
    m = L.data("m", shape=[4], dtype="bool", append_batch_size=False)
    t, f = L.split_lod_tensor(x, m)
    out = L.merge_lod_tensor(in_true=L.scale(t, scale=2.0),
                             in_false=L.scale(f, scale=-1.0), x=x, mask=m)
    loss = L.reduce_sum(out)
    return list(pkg.calc_gradient(loss, [x]))


def test_split_merge_gradient_routes_by_mask():
    """d(sum(merge(2 t, -f)))/dx: 2 on the true rows, -1 on the false."""
    import paddle_tpu as jpt
    from paddle_tpu_torch.core import backward as tb
    from torch_optim import JAX
    JAX.calc_gradient, PORT.calc_gradient = jpt.calc_gradient, \
        tb.calc_gradient
    xv = np.random.RandomState(3).randn(4, 3).astype(np.float32)
    mv = np.array([True, False, False, True])
    try:
        twin(_split_merge_grad, lambda pkg: [{"x": xv, "m": mv}])
        main, start, fetch = build(PORT, _split_merge_grad)
    finally:
        del JAX.calc_gradient, PORT.calc_gradient
    g, = run_port(main, start, [{"x": xv, "m": mv}],
                  [fetch[0].name])[0][0]
    np.testing.assert_array_equal(g[0], np.broadcast_to(
        np.where(mv[:, None], 2.0, -1.0), (4, 3)))


def _split_lod(pkg):
    L = pkg.layers
    x = L.data("x", shape=[1], lod_level=1)
    m = L.data("m", shape=[3], dtype="bool", append_batch_size=False)
    return list(L.split_lod_tensor(x, m))


SEQS = [np.array([[1.], [2.]], np.float32), np.array([[3.]], np.float32),
        np.array([[4.], [5.], [6.]], np.float32)]
SEQ_MASK = np.array([True, False, True])


def _seq_feeds(pkg):
    return [{"x": LOD[pkg.name].build_lod_tensor(SEQS), "m": SEQ_MASK}]


def test_split_lod_sequences_eager():
    """Whole sequences routed by the mask, on the per-op path of both
    (``use_jit=False``, as the JAX test runs it); the port's compiled
    path reads the offsets at its warm-up and goes per-op (a
    RuntimeWarning), with the same values."""
    twin(_split_lod, _seq_feeds, jax_use_jit=False, port_paths=("per_op",))
    main, start, fetch = build(PORT, _split_lod)
    with pytest.warns(RuntimeWarning, match="per-op path"):
        got, paths, _ = run_port(main, start, _seq_feeds(PORT),
                                 [v.name for v in fetch])
    (t, t_lod), (f, f_lod) = got[0]
    np.testing.assert_array_equal(t.reshape(-1), [1, 2, 4, 5, 6])
    np.testing.assert_array_equal(f.reshape(-1), [3])
    assert t_lod == [[0, 2, 5]] and f_lod == [[0, 1]]
    assert paths == {"jit_runs": 0, "eager_runs": 1, "hybrid_runs": 0}


def _ifelse_mnist(pkg):
    L = pkg.layers
    img = L.data("x", shape=[8, 16], append_batch_size=False)
    img.stop_gradient = False
    label = L.data("y", shape=[8, 1], dtype="int64", append_batch_size=False)
    limit = L.fill_constant(shape=[8, 1], dtype="int64", value=5)
    ie = L.IfElse(L.less_than(label, limit))
    for block, width in ((ie.true_block, 24), (ie.false_block, 32)):
        with block():
            hidden = L.fc(ie.input(img), size=width, act="tanh")
            ie.output(L.fc(hidden, size=10, act="softmax"))
    avg = L.mean(L.cross_entropy(ie()[0], label))
    pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(avg)
    return [avg]


def test_ifelse_rowmask_trains_mnist_style():
    """``test_mnist_if_else_op.py``'s shape: rows with label < 5 through
    one fc stack, the rest through another, merged, Momentum: 12 steps
    as JAX's, on the compiled path (both branches in one step), the loss
    falling."""
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 16).astype(np.float32),
            "y": rng.randint(0, 10, (8, 1)).astype(np.int64)}
    twin(_ifelse_mnist, lambda pkg: [feed] * 12, state=True)
    from torch_optim import JAX, jax_startup_state
    main, start, (avg,) = build(PORT, _ifelse_mnist)
    got, paths, _ = run_port(
        main, start, [feed] * 12, [avg.name],
        state=jax_startup_state(*build(JAX, _ifelse_mnist)[:2]))
    losses = [float(r[0][0].reshape(-1)[0]) for r in got]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert paths == {"jit_runs": 12, "eager_runs": 0, "hybrid_runs": 0}


def _ifelse_one_sided(pkg):
    L = pkg.layers
    a = L.data("a", shape=[3, 1], append_batch_size=False)
    zero = L.fill_constant(shape=[3, 1], dtype="float32", value=0.0)
    ie = L.IfElse(L.less_than(a, zero))
    with ie.true_block():
        ie.output(L.scale(ie.input(a), scale=-1.0))
    return [ie()[0]]


def test_ifelse_single_branch_output():
    """A one-sided IfElse gives the true table as it is (compacted, zero
    tail)."""
    av = np.array([[-2.0], [3.0], [-4.0]], np.float32)
    twin(_ifelse_one_sided, lambda pkg: [{"a": av}])
    main, start, fetch = build(PORT, _ifelse_one_sided)
    got = run_port(main, start, [{"a": av}], [fetch[0].name])[0]
    np.testing.assert_array_equal(got[0][0][0].reshape(-1), [2.0, 4.0, 0.0])


def _ifelse_scalar_multirow(pkg):
    L = pkg.layers
    a = L.data("a", shape=[1], append_batch_size=False)
    x = L.data("x", shape=[4, 2], append_batch_size=False)
    five = L.fill_constant(shape=[1], dtype="float32", value=5.0)
    ie = L.IfElse(L.less_than(a, five))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), scale=-1.0))
    return [ie()[0]]


def test_ifelse_scalar_cond_multirow_passthrough():
    """A one-row condition over many rows selects a whole branch."""
    xv = np.arange(8, dtype=np.float32).reshape(4, 2)
    feeds = [{"a": np.array([v], np.float32), "x": xv} for v in (3.0, 7.0)]
    twin(_ifelse_scalar_multirow, lambda pkg: feeds)
    main, start, fetch = build(PORT, _ifelse_scalar_multirow)
    got = run_port(main, start, feeds, [fetch[0].name])[0]
    np.testing.assert_array_equal(got[0][0][0], 2.0 * xv)
    np.testing.assert_array_equal(got[1][0][0], -xv)


def _split_mismatch(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4, 2], append_batch_size=False)
    m = L.data("m", shape=[3], dtype="bool", append_batch_size=False)
    return [L.split_lod_tensor(x, m)[0]]


@pytest.mark.parametrize("use_jit", [True, False], ids=["compiled", "per_op"])
def test_split_mask_length_mismatch_raises(use_jit):
    main, start, fetch = build(PORT, _split_mismatch)
    with pytest.raises(Exception, match="mask has 3 rows but X has 4"):
        run_port(main, start, [{"x": np.zeros((4, 2), np.float32),
                                "m": np.array([True, False, True])}],
                 [fetch[0].name], use_jit=use_jit)


def _split_merge_seq_grad(pkg):
    L = pkg.layers
    x = L.data("x", shape=[1], lod_level=1)
    x.stop_gradient = False
    m = L.data("m", shape=[3], dtype="bool", append_batch_size=False)
    t, f = L.split_lod_tensor(x, m)
    out = L.merge_lod_tensor(in_true=L.scale(t, scale=2.0),
                             in_false=L.scale(f, scale=-1.0), x=x, mask=m)
    return list(pkg.calc_gradient(L.reduce_sum(out), [x]))


def test_split_merge_sequence_gradient():
    """A LoD split / merge's gradient reassembles whole sequences: seq0
    and seq2 went true (x2), seq1 false (x-1)."""
    import paddle_tpu as jpt
    from paddle_tpu_torch.core import backward as tb
    from torch_optim import JAX
    JAX.calc_gradient, PORT.calc_gradient = jpt.calc_gradient, \
        tb.calc_gradient
    try:
        twin(_split_merge_seq_grad, _seq_feeds, jax_use_jit=False,
             port_paths=("per_op",))
        main, start, fetch = build(PORT, _split_merge_seq_grad)
    finally:
        del JAX.calc_gradient, PORT.calc_gradient
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, _, _ = run_port(main, start, _seq_feeds(PORT),
                             [fetch[0].name])
    g, lod = got[0][0]
    np.testing.assert_array_equal(g.reshape(-1), [2, 2, -1, 2, 2, 2])
    assert lod == [[0, 2, 3, 6]]
    assert tlod.build_lod_tensor(SEQS).lod() == lod


def _scale_lod(pkg):
    L = pkg.layers
    x = L.data("x", shape=[1], lod_level=1)
    x.stop_gradient = False
    y = L.scale(x, scale=3.0, bias=1.0)
    return [y] + list(pkg.calc_gradient(L.reduce_sum(y), [x]))


def test_scale_keeps_the_lod():
    """ROADMAP Queue 3 #37: the port's ``scale`` (and its grad) on a LoD
    input keeps the LoD, as the JAX lowering does; it raised a TypeError
    on the LoD value."""
    import paddle_tpu as jpt
    from paddle_tpu_torch.core import backward as tb
    from torch_optim import JAX
    JAX.calc_gradient, PORT.calc_gradient = jpt.calc_gradient, \
        tb.calc_gradient
    try:
        twin(_scale_lod, _seq_feeds)
    finally:
        del JAX.calc_gradient, PORT.calc_gradient
