"""The book models of the dense slice, ``word2vec`` and ``recommender``,
and of the conv-net slice, ``image_classification_vgg`` and
``recognize_digits_nets`` (``tests/torch_book.py``), in the port
against the JAX package on the CPU, fed the JAX package's synthetic
``imikolov`` 5-grams and ``movielens`` rows (read here only; the port's
config carries a reader of its own), and seeded synthetic images.

- Built alike, the two programs have the same ops; trained from one
  state (the JAX startup's) over the same batches, the losses agree
  within 1e-5 relative and the parameters within 1e-5 of max(1, the
  largest magnitude) (``torch_book.REL_TOL``); the VGG, whose batch
  norms flip relus at the JAX package's float32 statistics, within
  1e-5 at step 1 and 1e-3 after (ROADMAP.md Queue 3 #29), and, built
  in float64 in both packages (the JAX side in a process of its own
  with 64-bit types on), its whole trajectory within 1e-5 under the
  kind's Momentum and under the book's Adam.
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

BOOK_KINDS = ("word2vec", "recommender", "image_classification_vgg",
              "recognize_digits_nets")
# the kinds whose whole trajectory agrees within REL_TOL; the VGG's batch
# norms flip relus (test_image_classification_vgg_trains_close_to_jax)
TRAJECTORY_KINDS = ("word2vec", "recommender", "recognize_digits_nets")
# the VGG's later losses and its parameters after BOOK_BATCHES steps
BN_FLIP_TOL = 1e-3
STEPS = book.BOOK_BATCHES


def _op_types(main):
    return [op.type for op in main.global_block().ops]


@pytest.mark.parametrize("kind", TRAJECTORY_KINDS)
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


def test_image_classification_vgg_trains_close_to_jax():
    """The VGG of the image-classification book from one state: the same
    ops; the step-1 loss within REL_TOL; the later losses and the
    parameters after BOOK_BATCHES Momentum steps within BN_FLIP_TOL. Its
    batch norms take statistics over 16 x 32 x 32 values a channel,
    where the JAX package's float32 sums on the CPU are ~3.7e-6 off
    (the port's ~9e-8; ROADMAP.md Queue 3 #29): a relu whose input lies
    that close to 0 flips, and the gradient behind it differs by the
    cotangent there, so the trajectories part after step 1 by more than
    float32 noise."""
    kind = "image_classification_vgg"
    jmain, jstart, jspec = book.build("jax", kind)
    tmain, _, _ = book.build("port", kind)
    assert _op_types(tmain) == _op_types(jmain)
    state = book.jax_startup_state(jmain, jstart)
    cost = jspec["cost"].name
    jouts, jfinal = book.jax_run(jmain, state, book.feeds(kind, "jax", STEPS),
                                 [cost])
    touts, tfinal = book.port_run(tmain, state,
                                  book.feeds(kind, "port", STEPS), [cost])
    jl = [float(o[0].reshape(-1)[0]) for o in jouts]
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert book.loss_rel(tl[:1], jl[:1]) <= book.REL_TOL, (tl, jl)
    assert book.loss_rel(tl, jl) <= BN_FLIP_TOL, (tl, jl)
    params = [p.name for p in tmain.all_parameters()]
    for n in params:
        assert book.rel(tfinal[n], jfinal[n]) <= BN_FLIP_TOL, n


VGG = "image_classification_vgg"


def _feeds64(pkg):
    """The VGG kind's feeds with the images in float64."""
    return [{k: v.astype(np.float64) if v.dtype == np.float32 else v
             for k, v in f.items()} for f in book.feeds(VGG, pkg, STEPS)]


def _jax_float64_run(opt, out):
    """The JAX side of the float64 witness, run as ``python
    test_torch_book_models.py float64 <opt> <out>`` with 64-bit types on:
    (the startup state, the losses, the final persistables) into the
    pickle ``out``."""
    import pickle
    jmain, jstart, jspec = book.build("jax", VGG, dtype="float64",
                                      book_adam=opt == "adam")
    state = book.jax_startup_state(jmain, jstart)
    jouts, jfinal = book.jax_run(jmain, state, _feeds64("jax"),
                                 [jspec["cost"].name])
    with open(out, "wb") as fh:
        pickle.dump((state, [float(o[0].reshape(-1)[0]) for o in jouts],
                     jfinal), fh)


@pytest.mark.parametrize("opt", ["momentum", "adam"])
def test_image_classification_vgg_trains_like_jax_in_float64(opt, tmp_path):
    """ROADMAP.md Queue 3 #29's witness: the VGG kind built in float64
    in both packages, where the JAX package's batch-norm sums are no
    longer float32, trained from one state (the JAX startup's, in
    float64) over BOOK_BATCHES batches: the losses and every persistable
    (velocities and moments included) within REL_TOL over the whole
    trajectory, under the kind's Momentum and under the book's Adam
    (0.002), whose step on the zero-but-noise biases ahead of a batch
    norm is ~lr * noise / epsilon there. Measured: losses within 8.6e-9,
    persistables within 2.8e-14 (Momentum) and 8.7e-11 (Adam); in
    float32 the Momentum losses part by 5.9e-6, 3.2e-5 and 9.1e-5 at
    steps 2-4."""
    import os
    import pickle
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "jax64.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=root)
    subprocess.run([sys.executable, os.path.abspath(__file__), "float64",
                    opt, out], check=True, env=env, timeout=300)
    with open(out, "rb") as fh:
        state, jl, jfinal = pickle.load(fh)
    tmain, _, tspec = book.build("port", VGG, dtype="float64",
                                 book_adam=opt == "adam")
    # the optimizer's learning rate and Adam's beta powers stay float32
    # as declared
    assert all(state[p.name].dtype == np.float64
               for p in tmain.all_parameters())
    touts, tfinal = book.port_run(tmain, state, _feeds64("port"),
                                  [tspec["cost"].name])
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert book.loss_rel(tl, jl) <= book.REL_TOL, (tl, jl)
    assert set(tfinal) == set(jfinal)
    for n in jfinal:
        assert tfinal[n].dtype == jfinal[n].dtype, n
        assert book.rel(tfinal[n], jfinal[n]) <= book.REL_TOL, n


def test_jax_batch_norm_statistics_are_float32_sums_on_the_cpu():
    """ROADMAP.md Queue 3 #29's pin: the mean and variance a batch norm
    takes over [16, 8, 32, 32] (the VGG book kind's first block) against
    float64: the JAX package's lowering on the CPU is ~1e-6 off, the
    port's 40x closer."""
    import jax
    import jax.numpy as jnp
    x = np.random.RandomState(0).rand(16, 8, 32, 32).astype(np.float32) \
        * 3 + 1
    ref = x.astype(np.float64)
    jm = np.asarray(jax.jit(lambda a: jnp.mean(a, axis=(0, 2, 3)))(x))
    jv = np.asarray(jax.jit(lambda a: jnp.var(a, axis=(0, 2, 3)))(x))
    tx = torch.from_numpy(x)
    tm = torch.mean(tx, dim=(0, 2, 3)).numpy()
    tv = torch.var(tx, dim=(0, 2, 3), unbiased=False).numpy()
    want_m, want_v = ref.mean(axis=(0, 2, 3)), ref.var(axis=(0, 2, 3))

    def err(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())
    assert err(jm, want_m) > 1e-6 and err(jv, want_v) > 3e-7
    assert err(tm, want_m) < 2e-7 and err(tv, want_v) < 1e-7
    assert err(tm, want_m) * 10 < err(jm, want_m)


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


if __name__ == "__main__":
    import sys
    if sys.argv[1] == "float64":
        import jax
        jax.config.update("jax_enable_x64", True)
        _jax_float64_run(sys.argv[2], sys.argv[3])
