"""``chip_smoke.py``'s phase 19 helpers rehearsed on the CPU, at sizes the
CPU takes (the phase itself runs on the card at the book's widths):

- every case of ``_sequence_cases`` builds and runs on the per-op path,
  and ``_sequence_ops_check`` passes with the CPU on both sides (the
  samplers' law gates included);
- the sentiment nets and the role tagger, built by ``_sent_model`` and
  ``_srl_model`` at narrow widths, pass ``_seq_grad_check`` (their
  float32 step 1 against the same program built in float64), the
  peephole-free net passes ``_seq_fused_vs_loop`` (on the CPU both
  routes are the time loop), and ``_srl_decode_check`` passes;
- ``_viterbi_margins`` finds the brute-force best path and its margins;
  ``_pool_flips`` finds a max pool that picked another row and the gap
  between the two largest inputs there.

JAX-free: nothing of the JAX package is needed here.
"""
import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _smoke():
    return importlib.import_module("chip_smoke")


def test_sequence_op_cases_pass_with_the_cpu_on_both_sides():
    per_op = _smoke()._sequence_ops_check(torch.device("cpu"))
    assert len(per_op) == 30      # 27 op types with cases, 3 samplers
    for op, rec in per_op.items():
        assert rec["max_rel_err"] == 0.0, op
    for op in ("uniform_random_int", "log_uniform_random_int",
               "custom_dist_random_int"):
        assert per_op[op]["z_max_cpu"] <= 4.0
    assert per_op["warpctc"]["grad"] and per_op["sequence_pool"]["cases"] == 9


@pytest.fixture
def narrow(monkeypatch):
    """The phase's models at widths the CPU takes."""
    smoke = _smoke()
    for d, kw in ((smoke.SENT_BOOK, dict(vocab=50, batch=4, min_len=2,
                                         max_len=7)),
                  (smoke.SENT_CONV, dict(emb=6, hid=5)),
                  (smoke.SENT_LSTM, dict(emb=6, hid=16)),
                  (smoke.SRL_BOOK, dict(words=40, preds=9, labels=7,
                                        word_dim=6, mark_dim=3, hidden=16,
                                        depth=3, batch=3, min_len=2,
                                        max_len=6))):
        for k, v in kw.items():
            monkeypatch.setitem(d, k, v)
    return smoke


def _on_cpu(smoke, build, names, batch):
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    main, start, spec, trainer = smoke._seq_build(build, "cpu")
    feed = smoke._seq_host_feed(names, batch)
    scope = Scope()
    with scope_guard(scope):
        trainer._maybe_init()
    return trainer, spec, feed, scope


@pytest.mark.parametrize("net", ["conv", "lstm", "lstm_fused", "srl"])
def test_models_pass_the_grad_check_on_the_cpu(narrow, net):
    from paddle_tpu_torch.core.scope import scope_guard
    smoke = narrow
    if net == "srl":
        build, names, batch = (smoke._srl_model, smoke.SRL_FEED_NAMES,
                               smoke._srl_batch(0))
    else:
        kw = (dict(use_peepholes=False, lstm_impl="pallas")
              if net == "lstm_fused" else {})
        base = net.split("_")[0]

        def build(dt):
            return smoke._sent_model(base, dt, **kw)
        names, batch = ("words", "label"), smoke._sent_batch(0)
    trainer, spec, feed, scope = _on_cpu(smoke, build, names, batch)
    with scope_guard(scope):
        if net == "lstm_fused":
            rec = smoke._seq_fused_vs_loop(net, trainer, spec, feed)
            assert rec["hidden_rel_err"] == rec["grad_rel_err"] == 0.0
        checks, outs = smoke._seq_grad_check(net, trainer, spec, feed, build)
        assert checks["norm_rel_err"] <= smoke.SEQ_GRAD_REL_TOL
        assert checks["max_pool_flips"] == 0
        assert checks["params_checked"] == len(
            [p for p in trainer.main_program.all_parameters()
             if p.trainable])
        if net == "srl":
            rec = smoke._srl_decode_check(trainer, spec, batch, feed)
            assert rec["paths_equal"]
            assert rec["chunk_counts_card"] == rec["chunk_counts_cpu"]
            assert rec["positions"] == sum(s[0].shape[0] for s in batch)


def test_viterbi_margins_find_the_best_path():
    smoke = _smoke()
    rng = np.random.RandomState(4)
    K, lens = 3, [4, 1, 3]
    em = rng.randn(sum(lens), K)
    trans = rng.randn(K + 2, K) * 0.5
    offs = [0] + list(np.cumsum(lens))
    margins, best = smoke._viterbi_margins(em, trans, offs)
    for a, b in zip(offs, offs[1:]):
        e = em[a:b]
        scores = {}
        for path in itertools.product(range(K), repeat=b - a):
            scores[path] = trans[0, path[0]] + trans[1, path[-1]] + sum(
                e[t, path[t]] for t in range(b - a)) + sum(
                trans[2 + path[t], path[t + 1]] for t in range(b - a - 1))
        top = max(scores, key=scores.get)
        assert list(best[a:b]) == list(top)
        for t in range(b - a):
            other = max(v for p, v in scores.items() if p[t] != top[t])
            assert abs(margins[a + t] - (scores[top] - other)) < 1e-9


def test_pool_flips_measure_the_gap_at_each_flip():
    from paddle_tpu_torch.core.lod import LoDTensor
    smoke = _smoke()
    x = np.array([[1.0, 5.0], [3.0, 2.0], [3.0 - 1e-7, 0.0], [7.0, 1.0]])
    ref = {"mi": np.array([[1, 0], [3, 3]]), "x": LoDTensor(x, [[0, 3, 4]])}
    got = {"mi": np.array([[2, 0], [3, 3]])}
    gaps = smoke._pool_flips([("mi", "x")], got, ref)
    assert len(gaps) == 1 and abs(gaps[0] - 1e-7 / 3.0) < 1e-12
    assert smoke._pool_flips([("mi", "x")], ref, ref) == []
