"""The sequence layers, ``nets.sequence_conv_pool``, ``ChunkEvaluator``
and the sentiment and semantic-role book models of the port against the
JAX package's, on the CPU.

- Programs: each of the sequence slice's 23 layer functions
  (``layers/sequence.py``'s 21, ``im2sequence`` and ``hsigmoid``) and
  ``sequence_conv_pool`` builds, through each package's layers under its
  name guard, main and startup programs whose ops have the same types,
  inputs, outputs and attrs and whose variables the same names, shapes,
  dtypes, LoD levels and flags.
- Twins of ``tests/test_sequence.py``'s tests of the newly ported ops,
  run in the port against the same numpy or brute-force expectation.
- ``chunk_eval`` is a host op: a program that holds it runs on the
  hybrid path, the same program without it on the compiled one.
- The three book kinds (``tests/torch_book.py``) train alike in both
  packages from one state: 4 steps, losses within 1e-5 relative
  (``REL_TOL``), every persistable within 1e-5 of max(1, |value|).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import nets as jnets  # noqa: E402
import torch_book as book  # noqa: E402
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch import nets as tnets  # noqa: E402
from paddle_tpu_torch import optimizer as toptimizer  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import lod as tlod  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.core.scope import scope_guard as tscope_guard  # noqa: E402
from paddle_tpu_torch.initializer import Constant  # noqa: E402
from paddle_tpu_torch.param_attr import ParamAttr as TParamAttr  # noqa: E402
from test_torch_convnet_layers import program_of  # noqa: E402
from torch_optim import JAX, PKGS, PORT, build  # noqa: E402

LAYERS = ("dynamic_lstmp", "lstm_unit", "gru_unit", "sequence_conv",
          "sequence_softmax", "sequence_expand", "sequence_concat",
          "sequence_reshape", "sequence_reverse", "sequence_slice",
          "sequence_erase", "lod_reset", "row_conv", "linear_chain_crf",
          "crf_decoding", "warpctc", "ctc_greedy_decoder", "chunk_eval",
          "nce", "kmax_seq_score", "sub_nested_seq", "im2sequence",
          "hsigmoid")
NETS = {JAX.name: jnets, PORT.name: tnets}


def _seq(L, name="x", width=4, dtype="float32", lod_level=1):
    return L.data(name, shape=[width], dtype=dtype, lod_level=lod_level)


def _dense(L, name, shape, dtype="float32"):
    return L.data(name=name, shape=shape, dtype=dtype,
                  append_batch_size=False)


def _crf_pair(p):
    L = p.layers
    em = _seq(L, "em", 5)
    lab = _seq(L, "lab", 1, "int64")
    attr = p.ParamAttr(name="crfw")
    return [L.linear_chain_crf(em, lab, param_attr=attr),
            L.crf_decoding(em, param_attr=attr, label=lab),
            L.crf_decoding(em, param_attr=attr)]


def _nce(p, sampler):
    L = p.layers
    x = _dense(L, "x", [6, 8])
    y = _dense(L, "y", [6, 1], "int64")
    dist = (_dense(L, "dist", [20]) if sampler == "custom_dist" else None)
    return L.nce(x, y, num_total_classes=20, num_neg_samples=5,
                 sampler=sampler, custom_dist=dist)


BUILDERS = {
    "dynamic_lstmp": lambda p: p.layers.dynamic_lstmp(
        _seq(p.layers, width=16), size=16, proj_size=3, name="lstmp"),
    "dynamic_lstmp_no_peep_no_bias": lambda p: p.layers.dynamic_lstmp(
        _seq(p.layers, width=16), size=16, proj_size=2, use_peepholes=False,
        bias_attr=False, is_reverse=True, proj_activation="relu"),
    "lstm_unit": lambda p: p.layers.lstm_unit(
        _dense(p.layers, "x", [3, 5]), _dense(p.layers, "h", [3, 4]),
        _dense(p.layers, "c", [3, 4]), forget_bias=1.0),
    "gru_unit": lambda p: p.layers.gru_unit(
        _dense(p.layers, "x", [3, 12]), _dense(p.layers, "h", [3, 4]),
        size=12, activation="relu"),
    "sequence_conv": lambda p: p.layers.sequence_conv(
        _seq(p.layers), num_filters=6, filter_size=3, act="tanh"),
    "sequence_conv_no_bias": lambda p: p.layers.sequence_conv(
        _seq(p.layers), num_filters=2, filter_size=4, bias_attr=False),
    "sequence_softmax": lambda p: p.layers.sequence_softmax(
        _seq(p.layers, width=1)),
    "sequence_expand": lambda p: p.layers.sequence_expand(
        _dense(p.layers, "x", [3, 4]), _seq(p.layers, "y", 2)),
    "sequence_concat": lambda p: p.layers.sequence_concat(
        [_seq(p.layers, "a"), _seq(p.layers, "b")]),
    "sequence_reshape": lambda p: p.layers.sequence_reshape(
        _seq(p.layers), 8),
    "sequence_reverse": lambda p: p.layers.sequence_reverse(_seq(p.layers)),
    "sequence_slice": lambda p: p.layers.sequence_slice(
        _seq(p.layers), _dense(p.layers, "off", [2, 1], "int64"),
        _dense(p.layers, "len", [2, 1], "int64")),
    "sequence_slice_open": lambda p: p.layers.sequence_slice(
        _seq(p.layers), None, _dense(p.layers, "len", [2, 1], "int64")),
    "sequence_erase": lambda p: p.layers.sequence_erase(
        _seq(p.layers, width=1, dtype="int64"), [2, 5]),
    "lod_reset_target": lambda p: p.layers.lod_reset(
        _dense(p.layers, "x", [6, 2]), target_lod=[0, 2, 6]),
    "lod_reset_y": lambda p: p.layers.lod_reset(
        _dense(p.layers, "x", [6, 2]), y=_seq(p.layers, "y", 1)),
    "row_conv": lambda p: p.layers.row_conv(
        _seq(p.layers), future_context_size=2, act="relu"),
    "crf": _crf_pair,
    "warpctc": lambda p: p.layers.warpctc(
        _seq(p.layers, "x", 5), _seq(p.layers, "y", 1, "int64"), blank=4,
        norm_by_times=True),
    "ctc_greedy_decoder": lambda p: p.layers.ctc_greedy_decoder(
        _seq(p.layers, "x", 5), blank=0),
    "chunk_eval": lambda p: list(p.layers.chunk_eval(
        _seq(p.layers, "inf", 1, "int64"), _seq(p.layers, "lab", 1, "int64"),
        "IOB", 3, excluded_chunk_types=[1])),
    "nce_uniform": lambda p: _nce(p, "uniform"),
    "nce_log_uniform": lambda p: _nce(p, "log_uniform"),
    "nce_custom_dist": lambda p: _nce(p, "custom_dist"),
    "kmax_seq_score": lambda p: p.layers.kmax_seq_score(
        _seq(p.layers, width=1), beam_size=3),
    "sub_nested_seq": lambda p: p.layers.sub_nested_seq(
        _seq(p.layers, lod_level=2),
        _dense(p.layers, "sel", [2, 2], "int64")),
    "im2sequence": lambda p: p.layers.im2sequence(
        _dense(p.layers, "img", [2, 3, 8, 8]), filter_size=[3, 2],
        stride=2, padding=[1, 0]),
    "hsigmoid": lambda p: p.layers.hsigmoid(
        _dense(p.layers, "x", [4, 6]), _dense(p.layers, "y", [4, 1], "int64"),
        num_classes=7),
    "hsigmoid_no_bias": lambda p: p.layers.hsigmoid(
        _dense(p.layers, "x", [4, 6]), _dense(p.layers, "y", [4, 1], "int64"),
        num_classes=5, bias_attr=False),
    "sequence_pool_stride": lambda p: p.layers.sequence_pool(
        _seq(p.layers), "max", stride=3),
    "sequence_conv_pool": lambda p: NETS[p.name].sequence_conv_pool(
        _seq(p.layers, width=6), num_filters=4, filter_size=3, act="tanh",
        pool_type="sqrt"),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layer_builds_the_jax_program(name):
    progs = {}
    for pkg in PKGS:
        main, start, _ = build(pkg, BUILDERS[name])
        progs[pkg.name] = program_of(main, start)
    assert progs["port"] == progs["jax"]


def test_every_layer_function_of_the_slice_is_exported():
    assert len(LAYERS) == 23
    for name in LAYERS:
        assert callable(getattr(PORT.layers, name)), name
        assert callable(getattr(JAX.layers, name)), name
    from paddle_tpu.layers import sequence as jseq
    from paddle_tpu_torch.layers import sequence as tseq
    assert tseq.__all__ == jseq.__all__
    j_all = {n for n in dir(JAX.layers) if not n.startswith("_")
             and callable(getattr(JAX.layers, n))}
    t_all = {n for n in dir(PORT.layers) if not n.startswith("_")
             and callable(getattr(PORT.layers, n))}
    # 135 with this slice, 164 since the control flow slice's 29
    assert len(j_all) == 183 and len(t_all & j_all) == 164


def test_stride_pool_layer_refuses_a_bad_stride():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="stride"):
            build(pkg, lambda p: p.layers.sequence_pool(_seq(p.layers), "sum",
                                                        stride=0))


# -- twins of tests/test_sequence.py ------------------------------------------

def _lod_feed(arrays):
    return tlod.build_lod_tensor([np.asarray(a, np.float32) for a in arrays])


def _run(main, start, fetch, feed, state=None, use_jit=True):
    exe, scope = TExecutor("cpu"), TScope()
    with tscope_guard(scope):
        exe.run(start)
        for n, v in (state or {}).items():
            scope.set_var(n, torch.as_tensor(v))
        return exe.run(main, feed=feed, fetch_list=fetch,
                       use_jit=use_jit), exe


def _programs(fn):
    main, start = tir.Program(), tir.Program()
    with tir.program_guard(main, start):
        out = fn()
    return main, start, out


L = tlayers


def test_sequence_softmax():
    seqs = [np.array([[1.0], [2.0], [3.0]]), np.array([[5.0], [1.0]])]
    main, start, out = _programs(lambda: L.sequence_softmax(
        L.data("x", shape=[1], dtype="float32", lod_level=1)))
    (r,), _ = _run(main, start, [out], {"x": _lod_feed(seqs)})
    r = np.asarray(r.numpy()).reshape(-1)

    def sm(v):
        e = np.exp(v - v.max())
        return e / e.sum()
    np.testing.assert_allclose(r[:3], sm(np.array([1.0, 2, 3])), rtol=1e-5)
    np.testing.assert_allclose(r[3:], sm(np.array([5.0, 1])), rtol=1e-5)


def test_sequence_expand_row_per_seq():
    x_rows = np.array([[1.0, 1], [2, 2]], np.float32)
    y_seqs = [np.zeros((3, 1), np.float32), np.zeros((2, 1), np.float32)]
    main, start, out = _programs(lambda: L.sequence_expand(
        L.data("x", shape=[2], dtype="float32"),
        L.data("y", shape=[1], dtype="float32", lod_level=1)))
    (r,), _ = _run(main, start, [out], {"x": x_rows,
                                        "y": _lod_feed(y_seqs)})
    np.testing.assert_allclose(np.asarray(r.numpy()),
                               np.array([[1, 1]] * 3 + [[2, 2]] * 2))


def test_sequence_reshape():
    seqs = [np.arange(8, dtype=np.float32).reshape(4, 2)]
    main, start, out = _programs(lambda: L.sequence_reshape(
        L.data("x", shape=[2], dtype="float32", lod_level=1), 4))
    (r,), _ = _run(main, start, [out], {"x": _lod_feed(seqs)})
    np.testing.assert_allclose(np.asarray(r.numpy()),
                               np.arange(8, dtype=np.float32).reshape(2, 4))


def test_sequence_concat():
    a = [np.array([[1.0], [2]]), np.array([[3.0]])]
    b = [np.array([[4.0]]), np.array([[5.0], [6]])]
    main, start, out = _programs(lambda: L.sequence_concat(
        [L.data("x", shape=[1], dtype="float32", lod_level=1),
         L.data("y", shape=[1], dtype="float32", lod_level=1)]))
    (r,), _ = _run(main, start, [out], {"x": _lod_feed(a),
                                        "y": _lod_feed(b)})
    np.testing.assert_allclose(np.asarray(r.numpy()).reshape(-1),
                               [1, 2, 4, 3, 5, 6])
    assert r.lod() == [[0, 3, 6]]


def test_sequence_slice_and_erase_eager():
    seqs = [np.arange(5, dtype=np.float32).reshape(5, 1),
            np.arange(10, 14, dtype=np.float32).reshape(4, 1)]

    def fn():
        x = L.data("x", shape=[1], dtype="float32", lod_level=1)
        off = L.data("off", shape=[1], dtype="int64")
        ln = L.data("ln", shape=[1], dtype="int64")
        t = L.data("t", shape=[1], dtype="int64", lod_level=1)
        return L.sequence_slice(x, off, ln), L.sequence_erase(t, [2, 4])
    main, start, (out, erased) = _programs(fn)
    toks = tlod.build_lod_tensor([np.array([[1], [2], [3]], np.int64),
                                  np.array([[4], [4]], np.int64),
                                  np.array([[5], [2]], np.int64)])
    for use_jit in (True, False):
        (r, e), exe = _run(main, start, [out, erased],
                           {"x": _lod_feed(seqs),
                            "off": np.array([[1], [0]], np.int64),
                            "ln": np.array([[2], [3]], np.int64),
                            "t": toks}, use_jit=use_jit)
        np.testing.assert_allclose(np.asarray(r.numpy()).reshape(-1),
                                   [1, 2, 10, 11, 12])
        assert r.lod() == [[0, 2, 5]]
        assert np.asarray(e.numpy()).reshape(-1).tolist() == [1, 3, 5]
        assert e.lod() == [[0, 2, 2, 3]]
        assert exe.stats["hybrid_runs" if use_jit else "eager_runs"] == 1


def test_chunk_eval_ioe_end_tags():
    t = tlod.LoDTensor(np.array([[0], [1], [0], [1]], np.int64), [[0, 4]])
    main, start, outs = _programs(lambda: L.chunk_eval(
        L.data("x", shape=[1], dtype="int64", lod_level=1),
        L.data("y", shape=[1], dtype="int64", lod_level=1), "IOE", 1))
    rs, _ = _run(main, start, [outs[3], outs[4], outs[5]], {"x": t, "y": t})
    assert tuple(int(np.asarray(v)[0]) for v in rs) == (2, 2, 2)


def test_sequence_conv_window():
    seqs = [np.ones((4, 2), np.float32)]
    main, start, out = _programs(lambda: L.sequence_conv(
        L.data("x", shape=[2], dtype="float32", lod_level=1), num_filters=1,
        filter_size=3, param_attr=TParamAttr(initializer=Constant(1.0)),
        bias_attr=False))
    (r,), _ = _run(main, start, [out], {"x": _lod_feed(seqs)})
    # interior rows see 3 ctx rows * 2 feats = 6; the edges see 4
    np.testing.assert_allclose(np.asarray(r.numpy()).reshape(-1),
                               [4, 6, 6, 4])


def _crf_program(K, decode=False):
    def fn():
        x = L.data("x", shape=[K], dtype="float32", lod_level=1)
        y = L.data("y", shape=[1], dtype="int64", lod_level=1)
        nll = L.linear_chain_crf(x, y, param_attr=TParamAttr(name="crfw"))
        path = L.crf_decoding(x, TParamAttr(name="crfw")) if decode else None
        return nll, path
    return _programs(fn)


def test_linear_chain_crf_sums_to_prob():
    """exp(-nll) summed over every label path of a tiny CRF is 1."""
    np.random.seed(3)
    K, T = 3, 2
    em = np.random.randn(T, K).astype(np.float32)
    trans = np.random.randn(K + 2, K).astype(np.float32) * 0.3
    main, start, (nll, _) = _crf_program(K)
    total = 0.0
    for labels in itertools.product(range(K), repeat=T):
        (r,), _ = _run(main, start, [nll], {
            "x": tlod.LoDTensor(em, [[0, T]]),
            "y": tlod.LoDTensor(np.array(labels, np.int64).reshape(-1, 1),
                                [[0, T]])}, state={"crfw": trans})
        total += np.exp(-float(np.asarray(r)[0, 0]))
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_crf_decoding_matches_bruteforce():
    np.random.seed(4)
    K, T = 3, 4
    em = np.random.randn(T, K).astype(np.float32)
    trans = np.random.randn(K + 2, K).astype(np.float32) * 0.5
    best, best_score = None, -1e9
    for path in itertools.product(range(K), repeat=T):
        s = trans[0, path[0]] + trans[1, path[-1]] + sum(
            em[t, path[t]] for t in range(T)) + sum(
            trans[2 + path[t], path[t + 1]] for t in range(T - 1))
        if s > best_score:
            best, best_score = path, s
    main, start, (_, path_var) = _crf_program(K, decode=True)
    (r,), _ = _run(main, start, [path_var], {
        "x": tlod.LoDTensor(em, [[0, T]]),
        "y": tlod.LoDTensor(np.zeros((T, 1), np.int64), [[0, T]])},
        state={"crfw": trans})
    np.testing.assert_array_equal(np.asarray(r.numpy()).reshape(-1),
                                  list(best))


def test_warpctc_loss_positive_and_trains():
    np.random.seed(5)
    T, K = 6, 5

    def fn():
        x = L.data("x", shape=[K], dtype="float32", lod_level=1)
        x.stop_gradient = False
        y = L.data("y", shape=[1], dtype="int64", lod_level=1)
        avg = L.mean(L.warpctc(x, y, blank=0))
        toptimizer.SGD(learning_rate=0.0).minimize(avg)
        return avg
    main, start, avg = _programs(fn)
    (r, g), _ = _run(main, start, [avg, "x@GRAD"], {
        "x": tlod.build_lod_tensor([np.random.randn(T, K).astype(
            np.float32)]),
        "y": tlod.LoDTensor(np.array([[1], [2], [3]], np.int64),
                            [[0, 3]])})
    assert float(np.asarray(r)) > 0
    # the gradient of a CTC loss in the logits sums to 0 over each row
    np.testing.assert_allclose(np.asarray(g.numpy()).sum(axis=1), 0,
                               atol=1e-6)


def test_ctc_greedy_decoder():
    T, K = 6, 3
    logits = np.full((T, K), -5.0, np.float32)
    for t, k in enumerate([1, 1, 0, 2, 2, 0]):
        logits[t, k] = 5.0
    main, start, out = _programs(lambda: L.ctc_greedy_decoder(
        L.data("x", shape=[K], dtype="float32", lod_level=1), blank=0))
    (r,), exe = _run(main, start, [out],
                     {"x": tlod.build_lod_tensor([logits])})
    np.testing.assert_array_equal(np.asarray(r.numpy()).reshape(-1), [1, 2])
    assert exe.stats["hybrid_runs"] == 1


def test_chunk_eval_iob():
    inf = tlod.LoDTensor(np.array([[0], [1], [2], [0]], np.int64), [[0, 4]])
    lab = tlod.LoDTensor(np.array([[0], [1], [2], [2]], np.int64), [[0, 4]])
    main, start, outs = _programs(lambda: L.chunk_eval(
        L.data("x", shape=[1], dtype="int64", lod_level=1),
        L.data("y", shape=[1], dtype="int64", lod_level=1), "IOB", 1))
    rs, _ = _run(main, start, list(outs), {"x": inf, "y": lab})
    assert float(np.asarray(rs[0])) == 0.5 and float(np.asarray(rs[1])) == 1.0


def test_nce_trains():
    np.random.seed(6)

    def fn():
        x = L.data("x", shape=[8], dtype="float32")
        y = L.data("y", shape=[1], dtype="int64")
        loss = L.mean(L.nce(x, y, num_total_classes=20, num_neg_samples=5))
        toptimizer.SGD(learning_rate=0.1).minimize(loss)
        return loss
    main, start, loss = _programs(fn)
    main.random_seed = start.random_seed = 6
    feed = {"x": np.random.randn(4, 8).astype(np.float32),
            "y": np.array([[1], [2], [3], [4]], np.int64)}
    exe, scope = TExecutor("cpu"), TScope()
    with tscope_guard(scope):
        exe.run(start)
        jit0 = exe.stats["jit_runs"]
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss])[0]))
                  for _ in range(11)]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]
    # the sampler draws anew at each compiled run
    assert exe.stats["jit_runs"] - jit0 == 11
    assert exe.stats["eager_runs"] == 0


def test_row_conv():
    seqs = [np.ones((3, 2), np.float32)]
    main, start, out = _programs(lambda: L.row_conv(
        L.data("x", shape=[2], dtype="float32", lod_level=1),
        future_context_size=1,
        param_attr=TParamAttr(initializer=Constant(1.0))))
    (r,), _ = _run(main, start, [out], {"x": _lod_feed(seqs)})
    # out[t] = x[t] + x[t+1] (the last row only itself)
    np.testing.assert_allclose(np.asarray(r.numpy()),
                               [[2, 2], [2, 2], [1, 1]])


# -- the hybrid path ----------------------------------------------------------

def _tagger(with_eval):
    """A CRF tagger's training step, with chunk_eval over its decoded
    path when ``with_eval``."""
    def fn():
        words = L.data("w", shape=[1], dtype="int64", lod_level=1)
        target = L.data("t", shape=[1], dtype="int64", lod_level=1)
        em = L.fc(L.embedding(words, size=[20, 8]), size=5)
        attr = TParamAttr(name="crfw")
        cost = L.mean(L.linear_chain_crf(em, target, param_attr=attr))
        toptimizer.SGD(learning_rate=0.01).minimize(cost)
        fetch = [cost]
        if with_eval:
            path = L.crf_decoding(em, param_attr=attr)
            fetch += list(L.chunk_eval(path, target, "IOB", 2)[:3])
        return fetch
    return _programs(fn)


@pytest.mark.parametrize("with_eval", [True, False])
def test_a_program_with_chunk_eval_runs_on_the_hybrid_path(with_eval):
    main, start, fetch = _tagger(with_eval)
    rng = np.random.RandomState(2)
    feed = {"w": tlod.LoDTensor(rng.randint(0, 20, (9, 1)), [[0, 4, 9]]),
            "t": tlod.LoDTensor(rng.randint(0, 5, (9, 1)), [[0, 4, 9]])}
    exe, scope = TExecutor("cpu"), TScope()
    with tscope_guard(scope):
        exe.run(start)
        before = dict(exe.stats)
        outs = [exe.run(main, feed=feed, fetch_list=fetch)
                for _ in range(3)]
    runs = {k: exe.stats[k] - before[k] for k in ("jit_runs", "hybrid_runs",
                                                  "eager_runs")}
    assert runs == ({"jit_runs": 0, "hybrid_runs": 3, "eager_runs": 0}
                    if with_eval else
                    {"jit_runs": 3, "hybrid_runs": 0, "eager_runs": 0})
    losses = [float(np.asarray(o[0]).reshape(-1)[0]) for o in outs]
    assert losses[-1] < losses[0]
    if with_eval:
        p = float(np.asarray(outs[-1][1])[0])
        assert 0.0 <= p <= 1.0


# -- book models --------------------------------------------------------------

@pytest.mark.parametrize("kind", book.SENT_KINDS + ("label_semantic_roles",))
def test_book_model_trains_like_jax(kind):
    jmain, jstart, jspec = book.build("jax", kind)
    tmain, _, _ = book.build("port", kind)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    state = book.jax_startup_state(jmain, jstart)
    cost = jspec["cost"].name
    steps = book.BOOK_BATCHES
    jouts, jfinal = book.jax_run(jmain, state, book.feeds(kind, "jax", steps),
                                 [cost])
    touts, tfinal = book.port_run(tmain, state,
                                  book.feeds(kind, "port", steps), [cost])
    jl = [float(o[0].reshape(-1)[0]) for o in jouts]
    tl = [float(o[0].reshape(-1)[0]) for o in touts]
    assert book.loss_rel(tl, jl) <= book.REL_TOL, (tl, jl)
    assert np.isfinite(tl).all()
    for n in jfinal:
        assert book.rel(tfinal[n], jfinal[n]) <= book.REL_TOL, n


def test_semantic_role_decode_and_chunks_match_jax():
    """The trained tagger's decoded paths and the chunk counts of
    ``ChunkEvaluator``-style ``chunk_eval`` over them, from the JAX
    startup's state, equal in both packages."""
    kind = "label_semantic_roles"
    outs = {}
    for pkg in ("jax", "port"):
        main, start, spec = book.build(pkg, kind, minimize=False)
        L_ = book.jlayers if pkg == "jax" else tlayers
        guard = jpt.program_guard if pkg == "jax" else tir.program_guard
        with guard(main, start):
            chunks = L_.chunk_eval(spec["prediction"], spec["target"], "IOB",
                                   (book.SRL["labels"] - 1) // 2)
        fetch = [spec["prediction"].name] + [c.name for c in chunks[3:]]
        if pkg == "jax":
            state = book.jax_startup_state(main, start)
            outs[pkg] = book.jax_run(main, state, book.feeds(kind, pkg, 2),
                                     fetch)[0]
        else:
            outs[pkg] = book.port_run(main, state, book.feeds(kind, pkg, 2),
                                      fetch)[0]
    for j, t in zip(outs["jax"], outs["port"]):
        for jv, tv in zip(j, t):
            np.testing.assert_array_equal(np.asarray(tv).reshape(-1),
                                          np.asarray(jv).reshape(-1))
