"""The sequence slice on the card, where the CPU tests cannot reach:

- every op of the slice and its grad on the card against the CPU on the
  same inputs (``chip_smoke._sequence_cases``: offsets, paths, selections
  and chunk counts bit-identical, floats within ``SEQ_OP_TOL``), and the
  int samplers' draws against their laws;
- the semantic role tagger's training step (db_lstm and the CRF, at
  narrow widths) captured once and replayed with no fallback, its
  losses within 1e-6 relative of the per-op path's;
- a program with ``chunk_eval`` on the hybrid path, its counts the
  CPU's;
- the peephole-free sentiment LSTM at D 128, N 128 through row 7
  (``fused_lstm``) against the time loop: loss and each lstm's Hidden
  within ``FUSED_LOOP_REL_TOL``, every gradient within its gate (wider
  where a max pool picks another row at a near tie).

JAX-free, so that it runs where the card is.
"""
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _smoke():
    return importlib.import_module("chip_smoke")


@pytest.mark.cuda
def test_every_op_and_grad_matches_the_cpu(cuda_device):
    per_op = _smoke()._sequence_ops_check(cuda_device)
    assert len(per_op) == 30
    for op, rec in per_op.items():
        if rec["bit_identical"] and not rec["grad"]:
            assert rec["max_rel_err"] == 0.0, op


def _narrow(monkeypatch, smoke):
    for d, kw in ((smoke.SRL_BOOK, dict(words=300, preds=20, labels=9,
                                        hidden=64, depth=3, batch=4)),
                  (smoke.SENT_BOOK, dict(min_len=3, max_len=12))):
        for k, v in kw.items():
            monkeypatch.setitem(d, k, v)


@pytest.mark.cuda
def test_srl_step_is_captured_once_and_replayed(cuda_device, monkeypatch):
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    smoke = _smoke()
    _narrow(monkeypatch, smoke)
    batch = smoke._srl_batch(1)
    losses = {}
    for use_jit in (True, False):
        main, start, spec, trainer = smoke._seq_build(smoke._srl_model,
                                                      cuda_device)
        main.random_seed = start.random_seed = 5
        feed = smoke._seq_host_feed(smoke.SRL_FEED_NAMES, batch)
        with scope_guard(Scope()), warnings.catch_warnings(
                record=True) as caught:
            warnings.simplefilter("always")
            trainer._maybe_init()
            losses[use_jit] = [float(np.asarray(trainer.exe.run(
                main, feed=feed, fetch_list=[spec["cost"]],
                use_jit=use_jit)[0]).reshape(-1)[0]) for _ in range(4)]
        fallbacks = [str(w.message) for w in caught
                     if "per-op path" in str(w.message)]
        assert not fallbacks, fallbacks
        stats = trainer.exe.stats
        if use_jit:
            assert (stats["graph_captures"], stats["graph_replays"],
                    stats["eager_runs"]) == (1, 3, 0), stats
        trainer.exe.close()
    # the same kernels in both; atomics may sum in another order
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
    assert np.isfinite(losses[True]).all()


@pytest.mark.cuda
def test_chunk_eval_runs_on_the_hybrid_path(cuda_device):
    from paddle_tpu_torch import evaluator, layers
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.core.scope import Scope
    main, start = ir.Program(), ir.Program()
    with ir.program_guard(main, start):
        inf = layers.data("inf", shape=[1], dtype="int64", lod_level=1)
        lab = layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        ev = evaluator.ChunkEvaluator(inf, lab, "IOB", 3)
    rng = np.random.RandomState(0)
    lod = [[0, 5, 6, 12]]
    tags = rng.randint(0, 7, (12, 1)).astype(np.int64)
    pred = np.where(rng.rand(12, 1) < 0.3, rng.randint(0, 7, (12, 1)),
                    tags).astype(np.int64)
    counts = {}
    for dev in (cuda_device, torch.device("cpu")):
        exe, scope = Executor(dev), Scope()
        exe.run(start, scope=scope)
        for _ in range(3):
            exe.run(main, feed={"inf": LoDTensor(pred, lod),
                                "lab": LoDTensor(tags, lod)},
                    fetch_list=[ev.metrics[0]], scope=scope)
        assert exe.stats["hybrid_runs"] == 3 and exe.stats["eager_runs"] == 0
        counts[dev.type] = [int(scope.find_var(s.name).cpu().numpy()[0])
                            for s in ev.states]
    assert counts["cuda"] == counts["cpu"] and counts["cpu"][1] > 0


@pytest.mark.cuda
def test_sentiment_lstm_through_row_7_matches_the_time_loop(cuda_device,
                                                            monkeypatch):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    smoke = _smoke()
    _narrow(monkeypatch, smoke)
    assert smoke.SENT_LSTM["hid"] // 4 == 128
    assert smoke.SENT_BOOK["batch"] == 128

    def build(dt):
        return smoke._sent_model("lstm", dt, use_peepholes=False,
                                 lstm_impl="pallas")
    main, start, spec, trainer = smoke._seq_build(build, cuda_device)
    batch = smoke._sent_batch(2)
    feed = smoke._seq_host_feed(("words", "label"), batch)
    with scope_guard(Scope()):
        trainer._maybe_init()
        kernels.reset_launches()
        rec = smoke._seq_fused_vs_loop("test", trainer, spec, feed)
    # 3 layers: each forward and its replay in the generic grad
    assert kernels.launch_counts()["fused_lstm"] == 6
    assert rec["hidden_rel_err"] <= smoke.FUSED_LOOP_REL_TOL
    assert rec["grad_rel_err"] <= rec["grad_tolerance_rel"]
    trainer.exe.close()
