"""The CTR slice of the port against the JAX package: twins of the five
local tests of ``tests/test_ctr.py`` at its sizes (6 slots, dense 4,
vocab 50, embedding 4), each also run in both packages from one state
(the JAX startup's, carried into the port's scope) on the same seeded
batches, and the pin of Queue 3 #38 (lazy Adam moved rows it did not
look up, because the sparse embedding took the dense generic grad).

Tolerances: losses within 1e-5 relative at every step (``LOSS_TOL``),
persistables within 1e-5 of max(1, the largest magnitude)
(``STATE_TOL``), AUC within 1e-6; the lazy-Adam pin bit-identical.
"""
import numpy as np
import pytest

import paddle_tpu.models as jmodels
import paddle_tpu_torch.models as tmodels
import torch_optim as T

pytestmark = pytest.mark.smoke

SLOTS, DENSE, VOCAB, EMB = 6, 4, 50, 4
AUC_TOL = 1e-6


def _models(pkg):
    return jmodels if pkg is T.JAX else tmodels


def _train_both(build, steps, lr, batch, seed, sparse=True):
    """Train ``build(models)`` under Adam in both packages from one
    state: (JAX losses, port losses, JAX final, port final, JAX AUCs,
    port AUCs, the port's Executor)."""
    def fn(pkg):
        avg_cost, auc_var, _prob, _feeds = build(_models(pkg))
        pkg.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
        fetch = [avg_cost.name] + ([auc_var.name] if auc_var is not None
                                   else [])
        return fetch

    jm, js, jfetch = T.build(T.JAX, fn)
    tm, _ts, tfetch = T.build(T.PORT, fn)
    assert jfetch == tfetch
    state = T.jax_startup_state(jm, js)
    rng = np.random.RandomState(seed)
    feeds = [jmodels.synthetic_click_batch(rng, batch, SLOTS, DENSE, VOCAB)
             for _ in range(steps)]
    jo, jf, _ = T.jax_run(jm, state, feeds, jfetch)
    to, tf, _, exe = T.port_run(tm, state, feeds, tfetch)
    jl = [float(np.asarray(o[0]).reshape(-1)[0]) for o in jo]
    tl = [float(np.asarray(o[0]).reshape(-1)[0]) for o in to]
    ja = [float(np.asarray(o[1]).reshape(-1)[0]) for o in jo if len(o) > 1]
    ta = [float(np.asarray(o[1]).reshape(-1)[0]) for o in to if len(o) > 1]
    return jl, tl, jf, tf, ja, ta, exe


def _assert_same_run(jl, tl, jf, tf, ja, ta):
    assert T.loss_rel(tl, jl) < T.LOSS_TOL, (tl, jl)
    assert set(jf) == set(tf)
    for n in jf:
        assert T.rel(tf[n], jf[n]) < T.STATE_TOL, n
    if ja:
        assert np.max(np.abs(np.asarray(ta) - np.asarray(ja))) < AUC_TOL


def test_wide_deep_trains_and_jits():
    jl, tl, jf, tf, ja, ta, exe = _train_both(
        lambda m: m.wide_deep(num_sparse_slots=SLOTS, dense_dim=DENSE,
                              vocab_size=VOCAB, embed_dim=EMB,
                              hidden_sizes=(16, 8)),
        steps=40, lr=0.01, batch=64, seed=0)
    assert np.isfinite(tl).all()
    assert np.mean(tl[-5:]) < 0.85 * np.mean(tl[:5]), tl
    assert 0.5 < ta[-1] <= 1.0, ta[-1]
    _assert_same_run(jl, tl, jf, tf, ja, ta)
    # the sparse lookup and the SelectedRows Adam stay on the compiled
    # path: every step after the warm-up is a step of one compiled key
    assert exe.stats["jit_runs"] == 40 and exe.stats["eager_runs"] == 0
    assert exe.stats["hybrid_runs"] == 0, exe.stats


def test_deepfm_trains():
    jl, tl, jf, tf, ja, ta, _exe = _train_both(
        lambda m: m.deepfm(num_sparse_slots=SLOTS, dense_dim=DENSE,
                           vocab_size=VOCAB, embed_dim=EMB,
                           hidden_sizes=(16,)),
        steps=40, lr=0.01, batch=64, seed=0)
    assert np.isfinite(tl).all()
    assert np.mean(tl[-5:]) < 0.95 * np.mean(tl[:5]), tl
    assert 0.5 < ta[-1] <= 1.0, ta[-1]
    _assert_same_run(jl, tl, jf, tf, ja, ta)


def test_wide_deep_sparse_matches_dense_embedding_grads():
    """is_sparse=True (SelectedRows grads) and is_sparse=False train
    alike: the non-lazy Adam makes the sparse gradient dense. The port
    holds its two runs at the JAX test's rtol 2e-4 / atol 2e-5, and each
    against the JAX run of the same kind."""
    out = {}
    for sparse in (True, False):
        jl, tl, jf, tf, ja, ta, _exe = _train_both(
            lambda m: m.wide_deep(
                num_sparse_slots=SLOTS, dense_dim=DENSE, vocab_size=VOCAB,
                embed_dim=EMB, hidden_sizes=(8,), is_sparse=sparse,
                with_auc=False),
            steps=6, lr=0.01, batch=32, seed=7)
        _assert_same_run(jl, tl, jf, tf, ja, ta)
        out[sparse] = tl
    np.testing.assert_allclose(out[True], out[False], rtol=2e-4, atol=2e-5)


def _lazy_program(pkg):
    ids = pkg.layers.data("ids", shape=[1], dtype="int64")
    emb = pkg.layers.embedding(ids, size=[20, 3], is_sparse=True,
                               param_attr=pkg.ParamAttr(name="lazy_emb"))
    loss = pkg.layers.mean(emb)
    pkg.optimizer.Adam(learning_rate=0.5, lazy_mode=True).minimize(loss)
    return loss.name


@pytest.mark.parametrize("use_jit", [True, False])
def test_adam_lazy_mode_touches_only_looked_up_rows(use_jit):
    """Queue 3 #38's pin: ids [2, 2, 7], then [3], learning rate 0.5.
    The program carries ``lookup_table_sparse_grad``; the touched rows
    are [2, 7], then [3]; row 2 moves 1.500 in all (the dense generic
    grad moved it 2.505, and every other row with it); the untouched
    rows and their moments are bit-identical, and every persistable
    equals JAX's bit for bit, on the compiled and the per-op path."""
    jm, js, jloss = T.build(T.JAX, _lazy_program)
    tm, _ts, tloss = T.build(T.PORT, _lazy_program)
    types = T.op_types(tm)
    assert "lookup_table_sparse_grad" in types, types
    assert "generic_grad" not in types, types
    assert types == T.op_types(jm)
    state = T.jax_startup_state(jm, js)
    feeds = [{"ids": np.array([[2], [2], [7]], np.int64)},
             {"ids": np.array([[3]], np.int64)}]
    names = ["lazy_emb", "lazy_emb_moment1_0", "lazy_emb_moment2_0"]
    prev = {n: state[n] for n in names}
    touched_at = []
    scope = None
    exe = T.TExecutor("cpu")
    for i, feed in enumerate(feeds):
        jo, jf, _ = T.jax_run(jm, state if i == 0 else jstate, [feed],
                              [jloss])
        jstate = jf
        _to, tf, scope, exe = T.port_run(
            tm, state if i == 0 else tstate, [feed], [tloss],
            use_jit=use_jit, exe=exe)
        tstate = tf
        for n in jf:
            np.testing.assert_array_equal(tf[n], jf[n], err_msg=n)
        moved = np.abs(tf["lazy_emb"] - prev["lazy_emb"]).sum(axis=1)
        touched = sorted(np.nonzero(moved > 0)[0].tolist())
        touched_at.append(touched)
        untouched = np.setdiff1d(np.arange(20), touched)
        for n in names:
            np.testing.assert_array_equal(tf[n][untouched],
                                          prev[n][untouched], err_msg=n)
        prev = {n: tf[n] for n in names}
    assert touched_at == [[2, 7], [3]], touched_at
    total2 = np.abs(tstate["lazy_emb"][2] - state["lazy_emb"][2]).sum()
    assert abs(total2 - 1.5) < 1e-3, total2


def test_ctr_inference_prob_shape():
    """Serving slice: the click probability head feeds without labels,
    equal to JAX's inference program from the same state."""
    from paddle_tpu.io import get_inference_program as jinfer
    from paddle_tpu_torch.io import get_inference_program as tinfer

    def fn(pkg):
        _c, _a, prob, _f = _models(pkg).wide_deep(
            num_sparse_slots=SLOTS, dense_dim=DENSE, vocab_size=VOCAB,
            embed_dim=EMB, hidden_sizes=(8,), with_auc=False)
        infer = (jinfer if pkg is T.JAX else tinfer)([prob])
        return prob.name, infer

    jm, js, (jprob, jinf) = T.build(T.JAX, fn)
    tm, _ts, (tprob, tinf) = T.build(T.PORT, fn)
    state = T.jax_startup_state(jm, js)
    feed = jmodels.synthetic_click_batch(np.random.RandomState(2), 16,
                                         SLOTS, DENSE, VOCAB)
    feed.pop("click")
    jo, _jf, _ = T.jax_run(jinf, state, [feed], [jprob])
    to, _tf, _, _exe = T.port_run(tinf, state, [feed], [tprob])
    out = to[0][0]
    assert out.shape == (16, 1)
    assert ((out >= 0) & (out <= 1)).all()
    assert T.rel(out, jo[0][0]) < T.OP_TOL


def test_wide_deep_fetched_grad_is_selected_rows():
    """A fetched sparse ``W@GRAD`` comes back with its rows, on the
    compiled path after its capture too, equal to JAX's."""
    from paddle_tpu_torch.ops.selected_rows import SelectedRowsVal

    def fn(pkg):
        avg_cost, _a, _p, _f = _models(pkg).wide_deep(
            num_sparse_slots=SLOTS, dense_dim=DENSE, vocab_size=VOCAB,
            embed_dim=EMB, hidden_sizes=(8,), with_auc=False)
        pkg.optimizer.Adam(learning_rate=0.01,
                           lazy_mode=True).minimize(avg_cost)
        return [avg_cost.name, "emb_C0@GRAD", "wide_C3@GRAD"]

    jm, js, fetch = T.build(T.JAX, fn)
    tm, _ts, _ = T.build(T.PORT, fn)
    state = T.jax_startup_state(jm, js)
    rng = np.random.RandomState(3)
    feeds = [jmodels.synthetic_click_batch(rng, 16, SLOTS, DENSE, VOCAB)
             for _ in range(3)]
    scope = T.jpt.Scope()
    exe = T.jpt.Executor(T.jpt.CPUPlace())
    with T.jpt.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, v)
        jouts = [exe.run(jm, feed=f, fetch_list=fetch) for f in feeds]
    texe = T.TExecutor("cpu")
    tscope = T.scope_from_numpy(state, device="cpu")
    for f, jo in zip(feeds, jouts):
        to = texe.run(tm, feed=f, fetch_list=fetch, scope=tscope)
        for jv, tv in zip(jo[1:], to[1:]):
            assert isinstance(tv, SelectedRowsVal)
            assert tv.rows.dtype == np.int64          # Queue 3 #26
            np.testing.assert_array_equal(tv.rows, np.asarray(jv.rows))
            assert tv.height == jv.height
            assert T.rel(tv.values, np.asarray(jv.values)) < T.OP_TOL
            assert T.rel(tv.to_dense(), np.asarray(jv.to_dense())) \
                < T.OP_TOL
    assert texe.stats["jit_runs"] == 3 and texe.stats["eager_runs"] == 0


def test_sparse_wide_deep_memory_plan_matches_the_jax_package():
    """The planner prices a sparse ``W@GRAD`` at its declared shape, as
    the JAX package's does: the two plans of the lazy-Adam wide&deep step
    are equal record for record."""
    from paddle_tpu.analysis import memory as jmem
    from paddle_tpu_torch.analysis import memory as tmem

    def fn(pkg):
        avg_cost, _a, _p, _f = _models(pkg).wide_deep(
            num_sparse_slots=SLOTS, dense_dim=DENSE, vocab_size=VOCAB,
            embed_dim=EMB, hidden_sizes=(16, 8))
        pkg.optimizer.Adam(learning_rate=0.01,
                           lazy_mode=True).minimize(avg_cost)
        return avg_cost.name

    got = {}
    for pkg, mem in ((T.JAX, jmem), (T.PORT, tmem)):
        main, _s, cost = T.build(pkg, fn)
        plan = mem.plan_memory(main, batch=64, fetches=[cost], vmem=False)
        summary = plan.summary()
        summary.pop("vmem_scratch_bytes")
        got[pkg.name] = (summary, plan.unknown,
                         {n: (r.nbytes, r.cls, r.start, r.end)
                          for n, r in plan.records.items()})
    assert got["port"] == got["jax"]
    assert got["port"][2]["emb_C0@GRAD"][0] == VOCAB * EMB * 4
