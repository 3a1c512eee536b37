"""SelectedRows in the port against the JAX package
(``paddle_tpu/ops/selected_rows.py``, the sparse branches of
``optimizer_ops.py`` and of ``sum``): the sparse grad with and without
``padding_idx``, the SGD row update, Adam's non-lazy densify and its
lazy row update over duplicate, padding and absent rows, ``sum`` over
SelectedRows, ``split_selected_rows``, and a fetched ``W@GRAD``.

Tolerances: rows equal (int64 in the port, int32 in JAX: Queue 3 #26);
values and updates within 1e-6 of max(1, |the JAX value|) (``OP_TOL``)
where the sums run in another order, bit-identical where they do not.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import torch_optim as T
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core.executor import FunctionalContext as JCtx
from paddle_tpu.ops import selected_rows as jsr
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core.executor import FunctionalContext as TCtx
from paddle_tpu_torch.ops import selected_rows as tsr

pytestmark = pytest.mark.smoke

HEIGHT, DIM = 20, 3


def _table_program(pkg, padding_idx=None, lookups=(True,), opt=None):
    """ids -> one lookup of table "tbl" per entry of ``lookups`` (its
    is_sparse) -> the sum of their means; with ``opt(pkg)`` minimized,
    else the backward alone."""
    ids = pkg.layers.data("ids", shape=[1], dtype="int64")
    outs = [pkg.layers.embedding(ids, size=[HEIGHT, DIM], is_sparse=sp,
                                 padding_idx=padding_idx,
                                 param_attr=pkg.ParamAttr(name="tbl"))
            for sp in lookups]
    w = pkg.layers.data("w", shape=[DIM], dtype="float32")
    loss = pkg.layers.mean(pkg.layers.elementwise_mul(outs[0], w))
    for o in outs[1:]:
        loss = pkg.layers.elementwise_add(loss, pkg.layers.mean(o))
    if opt is not None:
        opt(pkg).minimize(loss)
    else:
        pkg.append_backward(loss)
    return loss.name


def _feed(ids, seed=0):
    ids = np.asarray(ids, np.int64).reshape(-1, 1)
    w = np.random.RandomState(seed).randn(len(ids), DIM).astype(np.float32)
    return {"ids": ids, "w": w}


def _both(fn, feeds, fetch, use_jit=True):
    jm, js, _ = T.build(T.JAX, fn)
    tm, _ts, _ = T.build(T.PORT, fn)
    state = T.jax_startup_state(jm, js)
    scope = jpt.Scope()
    exe = jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, v)
        jo = [exe.run(jm, feed=f, fetch_list=fetch) for f in feeds]
        jfinal = {n: np.asarray(scope.find_var(n)) for n in state}
    texe = T.TExecutor("cpu")
    tscope = T.scope_from_numpy(state, device="cpu")
    to = [texe.run(tm, feed=f, fetch_list=fetch, scope=tscope,
                   use_jit=use_jit) for f in feeds]
    tfinal = T.scope_to_numpy(tscope, names=state)
    return jo, to, jfinal, tfinal, state, tm


def _same_rows(tv, jv):
    assert isinstance(tv, tsr.SelectedRowsVal), type(tv)
    assert tv.rows.dtype == np.int64
    np.testing.assert_array_equal(tv.rows, np.asarray(jv.rows))
    assert tv.height == jv.height == HEIGHT
    assert T.rel(tv.values, np.asarray(jv.values)) < T.OP_TOL


@pytest.mark.parametrize("padding_idx", [None, 5])
def test_lookup_table_sparse_grad(padding_idx):
    ids = [2, 5, 7, 2, 5, 19]
    jo, to, _jf, _tf, _s, tm = _both(
        lambda pkg: _table_program(pkg, padding_idx), [_feed(ids)],
        ["tbl@GRAD"])
    assert "lookup_table_sparse_grad" in T.op_types(tm)
    _same_rows(to[0][0], jo[0][0])
    vals = np.asarray(to[0][0].values)
    if padding_idx is not None:
        assert not vals[np.asarray(ids) == padding_idx].any()
    assert vals[np.asarray(ids) != 5].any()


def test_sparse_grad_metadata():
    """The grad maker leaves a dense table on the generic grad, and the
    new op types are registered."""
    for t in ("lookup_table_sparse_grad", "split_selected_rows"):
        assert tregistry.lookup(t) is not None, t
    assert tregistry.op_is_host(tregistry.lookup("split_selected_rows"),
                                None)
    tm, _ts, _ = T.build(T.PORT, lambda pkg: _table_program(
        pkg, lookups=(False,)))
    assert "lookup_table_sparse_grad" not in T.op_types(tm)


def test_sgd_row_update_equals_dense_sgd():
    """SGD over a sparse table = SGD over the dense one, and = JAX's."""
    def opt(pkg):
        return pkg.optimizer.SGD(learning_rate=0.3)
    feeds = [_feed([2, 2, 7, 11], 1), _feed([3, 7], 2)]
    final = {}
    for sparse in (True, False):
        _jo, _to, jf, tf, state, _tm = _both(
            lambda pkg: _table_program(pkg, lookups=(sparse,), opt=opt),
            feeds, [])
        assert T.rel(tf["tbl"], jf["tbl"]) < T.OP_TOL
        final[sparse] = tf["tbl"]
    assert T.rel(final[True], final[False]) < T.OP_TOL
    moved = np.nonzero(np.abs(final[True] - state["tbl"]).sum(1))[0]
    assert moved.tolist() == [2, 3, 7, 11]


def _adam_ctx(pkg, grad, state, attrs):
    """A FunctionalContext over one ``adam`` op of ``pkg`` fed ``grad``."""
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        blk = main.global_block()
        outs = {s: [s.lower()] for s in ("ParamOut", "Moment1Out",
                                          "Moment2Out")}
        for names in outs.values():
            blk.create_var(name=names[0], dtype="float32")
        op = blk.append_op(type="adam", inputs={}, outputs=outs,
                           attrs=attrs)
    ins = dict(state)
    ins["Grad"] = [grad]
    if pkg is T.JAX:
        return JCtx(op, ins, attrs)
    return TCtx(op, ins, attrs, torch.device("cpu"))


def _adam_state(seed=0):
    rng = np.random.RandomState(seed)
    return {"Param": rng.randn(HEIGHT, DIM).astype(np.float32),
            "Moment1": rng.rand(HEIGHT, DIM).astype(np.float32) * 0.1,
            "Moment2": rng.rand(HEIGHT, DIM).astype(np.float32) * 0.1,
            "Beta1Pow": np.array([0.9 ** 3], np.float32),
            "Beta2Pow": np.array([0.999 ** 3], np.float32),
            "LearningRate": np.array([0.05], np.float32)}


def _run_adam(pkg, state, rows, vals, lazy, dense=False):
    import jax.numpy as jnp
    if pkg is T.JAX:
        st = {k: [jnp.asarray(v)] for k, v in state.items()}
        g = jsr.SelectedRowsVal(jnp.asarray(rows, jnp.int32),
                                jnp.asarray(vals), HEIGHT)
        if dense:
            g = g.to_dense()
    else:
        st = {k: [torch.tensor(v)] for k, v in state.items()}
        g = tsr.SelectedRowsVal(torch.tensor(rows, dtype=torch.int64),
                                torch.tensor(vals), HEIGHT)
        if dense:
            g = g.to_dense()
    ctx = _adam_ctx(pkg, g, st, {"lazy_mode": lazy})
    (jregistry if pkg is T.JAX else tregistry).lookup_checked(
        "adam").lower(ctx)
    return {s: np.asarray(ctx.collected[s][0]) for s in
            ("ParamOut", "Moment1Out", "Moment2Out")}


def test_adam_non_lazy_selected_rows_equals_dense():
    """Non-lazy Adam on a SelectedRows gradient = Adam on its dense
    form, bit for bit on the CPU, and = JAX's."""
    rng = np.random.RandomState(4)
    rows = np.array([2, 9, 2, 17, 0], np.int64)
    vals = rng.randn(5, DIM).astype(np.float32)
    state = _adam_state()
    sparse = _run_adam(T.PORT, state, rows, vals, lazy=False)
    dense = _run_adam(T.PORT, state, rows, vals, lazy=False, dense=True)
    jax = _run_adam(T.JAX, state, rows, vals, lazy=False)
    for s in sparse:
        np.testing.assert_array_equal(sparse[s], dense[s], err_msg=s)
        assert T.rel(sparse[s], jax[s]) < T.OP_TOL, s


def test_lazy_adam_rows_against_jax():
    """Lazy Adam at the op: duplicates merged, the padding lanes of the
    fixed-size row set (rows 2 and 9 repeat) never land, absent rows
    bit-identical; equal to JAX's within OP_TOL."""
    rng = np.random.RandomState(5)
    rows = np.array([9, 2, 9, 2, 2, 13], np.int64)
    vals = rng.randn(6, DIM).astype(np.float32)
    state = _adam_state(1)
    got = _run_adam(T.PORT, state, rows, vals, lazy=True)
    want = _run_adam(T.JAX, state, rows, vals, lazy=True)
    absent = np.setdiff1d(np.arange(HEIGHT), rows)
    names = {"ParamOut": "Param", "Moment1Out": "Moment1",
             "Moment2Out": "Moment2"}
    for s, n in names.items():
        assert T.rel(got[s], want[s]) < T.OP_TOL, s
        np.testing.assert_array_equal(got[s][absent], state[n][absent])
        assert (got[s][[2, 9, 13]] != state[n][[2, 9, 13]]).all(), s


def test_lazy_adam_three_steps_with_padding_against_jax():
    """Three steps of lazy Adam through the Executor with duplicate ids,
    the padding id and rows absent from each batch, on the compiled and
    the per-op path: every persistable within OP_TOL of JAX's (XLA's
    segment sum may add a row's three duplicates in another order: one
    ulp on 2 of 60 moments), the rows no batch looked up bit-identical."""
    def fn(pkg):
        return _table_program(pkg, padding_idx=4, opt=lambda p:
                              p.optimizer.Adam(learning_rate=0.1,
                                               lazy_mode=True))
    feeds = [_feed([4, 2, 2, 8], 0), _feed([8, 8, 8, 4, 1], 1),
             _feed([19, 0], 2)]
    for use_jit in (True, False):
        _jo, _to, jf, tf, state, _tm = _both(fn, feeds, [], use_jit)
        for n in jf:
            assert T.rel(tf[n], jf[n]) < T.OP_TOL, n
        for n in ("tbl", "tbl_moment1_0", "tbl_moment2_0"):
            # the padding row's gradient is zero, so its moments move
            # (decay) but never row 3, 5, 6, 7 or 9..18
            untouched = [3, 5, 6, 7] + list(range(9, 19))
            np.testing.assert_array_equal(tf[n][untouched],
                                          state[n][untouched])


def test_sum_of_two_sparse_grads_shared_table():
    """A table looked up twice: backward sums its two SelectedRows
    gradients, which concatenate their rows; fetched and applied as
    JAX's."""
    jo, to, jf, tf, _s, tm = _both(
        lambda pkg: _table_program(pkg, lookups=(True, True), opt=lambda p:
                                   p.optimizer.SGD(learning_rate=0.5)),
        [_feed([1, 6, 6], 3)], ["tbl@GRAD"])
    assert T.op_types(tm).count("lookup_table_sparse_grad") == 2
    assert "sum" in T.op_types(tm)
    _same_rows(to[0][0], jo[0][0])
    assert np.asarray(to[0][0].rows).tolist() == [1, 6, 6, 1, 6, 6]
    assert T.rel(tf["tbl"], jf["tbl"]) < T.OP_TOL


def test_sum_of_sparse_and_dense_grads():
    """A sparse and a dense lookup of one table: ``sum`` makes the
    sparse part dense; the fetched gradient equals JAX's."""
    jo, to, _jf, _tf, _s, tm = _both(
        lambda pkg: _table_program(pkg, lookups=(True, False)),
        [_feed([1, 6, 6, 12], 4)], ["tbl@GRAD"])
    assert "sum" in T.op_types(tm)
    got = to[0][0]
    assert isinstance(got, np.ndarray) and got.shape == (HEIGHT, DIM)
    assert T.rel(got, np.asarray(jo[0][0])) < T.OP_TOL


@pytest.mark.parametrize("sections", [[], [10, 10], [5, 8, 7]])
def test_split_selected_rows_against_jax(sections):
    import jax.numpy as jnp
    rng = np.random.RandomState(6)
    rows = np.array([0, 19, 4, 5, 12, 12, 13, 7], np.int64)
    vals = rng.randn(8, DIM).astype(np.float32)
    n_out = max(len(sections), 1)
    attrs = {"height_sections": sections}
    got = {}
    for pkg in T.PKGS:
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            blk = main.global_block()
            outs = ["out%d" % i for i in range(n_out)]
            for n in outs:
                blk.create_var(name=n, dtype="float32")
            op = blk.append_op(type="split_selected_rows", inputs={},
                               outputs={"Out": outs}, attrs=attrs)
        if pkg is T.JAX:
            x = jsr.SelectedRowsVal(jnp.asarray(rows, jnp.int32),
                                    jnp.asarray(vals), HEIGHT)
            ctx = JCtx(op, {"X": [x]}, attrs)
            jregistry.lookup_checked("split_selected_rows").lower(ctx)
        else:
            x = tsr.SelectedRowsVal(torch.tensor(rows), torch.tensor(vals),
                                    HEIGHT)
            ctx = TCtx(op, {"X": [x]}, attrs, torch.device("cpu"))
            tregistry.lookup_checked("split_selected_rows").lower(ctx)
        got[pkg.name] = ctx.collected["Out"]
    assert len(got["port"]) == len(got["jax"]) == n_out
    for tv, jv in zip(got["port"], got["jax"]):
        assert tv.height == jv.height
        np.testing.assert_array_equal(tv.rows.numpy(), np.asarray(jv.rows))
        np.testing.assert_array_equal(tv.values.numpy(),
                                      np.asarray(jv.values))


def test_fetched_w_grad_is_selected_rows_on_both_paths():
    """A fetched ``W@GRAD`` is a ``SelectedRowsVal`` of host arrays on the
    compiled path (warm-up, then the step that stands in for a capture,
    then a replay) and on the per-op path; ``to_dense`` equals JAX's."""
    feeds = [_feed([3, 3, 10], i) for i in range(3)]
    for use_jit in (True, False):
        jo, to, _jf, _tf, _s, _tm = _both(
            lambda pkg: _table_program(pkg, opt=lambda p:
                                       p.optimizer.SGD(learning_rate=0.1)),
            feeds, ["tbl@GRAD"], use_jit)
        for j, t in zip(jo, to):
            _same_rows(t[0], j[0])
            assert isinstance(t[0].values, np.ndarray)
            assert T.rel(t[0].to_dense(), np.asarray(j[0].to_dense())) \
                < T.OP_TOL
