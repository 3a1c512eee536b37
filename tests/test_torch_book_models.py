"""The two book models of the dense slice, ``word2vec`` and
``recommender`` (``tests/torch_book.py``), in the port against the JAX
package on the CPU, fed the JAX package's synthetic ``imikolov`` 5-grams
and ``movielens`` rows (read here only; the port's config carries a
reader of its own).

- Built alike, the two programs have the same ops; trained from one
  state (the JAX startup's) over the same batches, the losses agree
  within 1e-5 relative and the parameters within 1e-5 of max(1, the
  largest magnitude) (``torch_book.REL_TOL``).
- ``word2vec`` has one parameter ``shared_w``, read by four
  ``lookup_table`` ops; its gradient is the running ``sum`` of their
  four generic grads, equal to JAX's at step 1 and to ``torch.autograd``
  of a plain model written here.
- The compiled CPU path: a fixed batch runs as one step key with one
  warm-up, bit-identical to the per-op path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_book as book  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.core.scope import scope_from_numpy  # noqa: E402

BOOK_KINDS = ("word2vec", "recommender")
STEPS = book.BOOK_BATCHES


def _op_types(main):
    return [op.type for op in main.global_block().ops]


@pytest.mark.parametrize("kind", BOOK_KINDS)
def test_book_model_trains_like_jax(kind):
    jmain, jstart, jspec = book.build("jax", kind)
    tmain, _, tspec = book.build("port", kind)
    assert _op_types(tmain) == _op_types(jmain)
    state = book.jax_startup_state(jmain, jstart)
    cost = jspec["cost"].name
    jouts, jfinal = book.jax_run(jmain, state, book.feeds(kind, "jax", STEPS),
                                 [cost])
    touts, tfinal = book.port_run(tmain, state,
                                  book.feeds(kind, "port", STEPS), [cost])
    jl = [float(o[0].reshape(-1)[0]) for o in jouts]
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert book.loss_rel(tl, jl) <= book.REL_TOL, (tl, jl)
    assert np.isfinite(tl).all()
    for n in jfinal:
        assert book.rel(tfinal[n], jfinal[n]) <= book.REL_TOL, n


def test_word2vec_has_one_shared_table_and_sums_its_four_grads():
    tmain, _, _ = book.build("port", "word2vec")
    jmain, jstart, _ = book.build("jax", "word2vec")
    for main in (tmain, jmain):
        names = [p.name for p in main.all_parameters()]
        assert names.count("shared_w") == 1
    ops = tmain.global_block().ops
    assert sum(op.type == "lookup_table" for op in ops) == 4
    grads = [op for op in ops if op.type == "generic_grad"
             and op.attrs["__fwd_type__"] == "lookup_table"]
    assert len(grads) == 4
    assert all(op.output("W@GRAD")[0].startswith("shared_w@GRAD")
               for op in grads)
    # the backward's accumulation: a running sum of the four
    sums = [op for op in ops if op.type == "sum"
            and op.output("Out")[0].startswith("shared_w@GRAD@ACC")]
    assert len(sums) == 3
    state = book.jax_startup_state(jmain, jstart)
    feed = book.feeds("word2vec", "port", 1)
    jg = book.jax_run(jmain, state, book.feeds("word2vec", "jax", 1),
                      ["shared_w@GRAD"])[0][0][0]
    tg = book.port_run(tmain, state, feed, ["shared_w@GRAD"])[0][0][0]
    assert book.rel(tg, jg) <= book.REL_TOL
    assert np.abs(tg).sum() > 0


def _plain_w2v_grads(state, feed):
    """torch.autograd of the word2vec model written out by hand: the four
    lookups from one leaf table."""
    leaves = {n: torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for n, v in state.items()}
    w = leaves["shared_w"]
    emb = torch.cat([w[torch.as_tensor(feed["w%d" % i]).reshape(-1)]
                     for i in range(4)], dim=1)
    h = torch.sigmoid(emb @ leaves["fc_0.w_0"] + leaves["fc_0.b_0"])
    p = torch.softmax(h @ leaves["fc_1.w_0"] + leaves["fc_1.b_0"], dim=1)
    label = torch.as_tensor(feed["next_word"]).reshape(-1, 1)
    loss = -torch.log(torch.gather(p, 1, label)).mean()
    names = sorted(leaves)
    return dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names])))


def test_word2vec_step1_gradients_match_autograd():
    tmain, tstart, _ = book.build("port", "word2vec")
    jmain, jstart, _ = book.build("jax", "word2vec")
    state = book.jax_startup_state(jmain, jstart)
    params = sorted(p.name for p in tmain.all_parameters())
    feed = book.feeds("word2vec", "port", 1)[0]
    got = book.port_run(tmain, state, [feed],
                        [n + "@GRAD" for n in params])[0][0]
    want = _plain_w2v_grads({n: state[n] for n in params}, feed)
    for n, g in zip(params, got):
        w = want[n].numpy()
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), n


@pytest.mark.parametrize("kind", BOOK_KINDS)
def test_book_model_runs_one_compiled_key_on_a_fixed_batch(kind):
    """Four runs of one batch (the recommender's ragged, one max_lens):
    one step key, warmed up once, then captured (on the CPU, run) and
    replayed; the losses and parameters equal the per-op path's."""
    tmain, tstart, tspec = book.build("port", kind)
    jmain, jstart, _ = book.build("jax", kind)
    state = book.jax_startup_state(jmain, jstart)
    feed = book.feeds(kind, "port", 1)[0]
    cost = tspec["cost"].name
    runs = {}
    for use_jit in (True, False):
        exe, scope = TExecutor("cpu"), TScope()
        scope_from_numpy(state, device="cpu", scope=scope)
        losses = [float(exe.run(tmain, feed=feed, fetch_list=[cost],
                                scope=scope, use_jit=use_jit)[0]
                        .reshape(-1)[0]) for _ in range(4)]
        runs[use_jit] = (losses, {n: scope.find_var(n).numpy().copy()
                                  for n in state}, exe)
    exe = runs[True][2]
    assert exe.stats["jit_runs"] == 4 and exe.stats["eager_runs"] == 0
    keys = [k for k in exe._cache if k[1] == tmain._uid]
    assert len(keys) == 1 and exe._cache[keys[0]].runs == 4
    assert runs[True][0] == runs[False][0]
    assert runs[True][0][-1] < runs[True][0][0]
    for n, v in runs[False][1].items():
        assert np.array_equal(runs[True][1][n], v), n
