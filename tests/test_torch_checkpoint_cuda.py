"""Checkpoints and inference models on the card, with the Executor's
compiled step (a CUDA graph replayed, the scope's state tensors written
in place).

- An async save at step k, then step k + 1 at once: the replay writes the
  state tensors while the save's thread writes the files, which hold
  step k's values, bit for bit (the save's host copy is taken before it
  returns).
- A load into an Executor whose step is captured: the next replays run
  from the loaded values (the losses of a run that never left them).
- An inference model of an LM loaded and run compiled: one capture,
  the flash forward's launches a run (one a layer), no backward launch,
  the output the test program's bit for bit.

JAX-free, so that it runs where the card is. Tolerance: none.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import checkpoint, io, kernels, tune  # noqa: E402
from paddle_tpu_torch.configs import tiny_lm  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope, global_scope,  # noqa: E402
                                         scope_guard, scope_to_numpy)
from paddle_tpu_torch.flags import flags_guard  # noqa: E402
from paddle_tpu_torch.trainer import EndIteration, Trainer  # noqa: E402

LM = dict(hidden=64, num_heads=2, num_layers=2, seq=64, batch=4,
          samples=4 * 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


@pytest.fixture
def tune_dir(tmp_path):
    """An empty winner cache, so that no winner on the machine reroutes
    a gemm."""
    with flags_guard(tune_cache_dir=str(tmp_path / "tune"), tune=True):
        tune.clear_memory_cache()
        yield str(tmp_path / "tune")
    tune.clear_memory_cache()


def _lm_trainer(**kw):
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        spec = tiny_lm.model(**LM)
        tr = Trainer(spec["cost"], spec["optimizer"], spec["feed_list"],
                     device="cuda", main_program=main,
                     startup_program=start, **kw)
    return tr, spec


def _reader(spec, lo, hi):
    batches = list(spec["reader"]())
    return lambda: iter(batches[lo:hi])


def _persist(tr):
    return sorted(v.name for v in tr.main_program.list_vars()
                  if v.persistable)


@pytest.mark.cuda
def test_async_save_races_the_next_replay(cuda_device, tune_dir, tmp_path):
    with scope_guard(Scope()):
        tr, spec = _lm_trainer()
        tr.train(_reader(spec, 0, 4), pipeline=False)  # captured, replayed
        assert tr.exe.stats["graph_replays"] >= 2
        want = scope_to_numpy(global_scope(), _persist(tr))
        h = tr.save_checkpoint(str(tmp_path / "ck"), async_=True, step=4)
        tr.train(_reader(spec, 4, 5), pipeline=False)  # step k + 1
        d = h.result(timeout=120)
        after = scope_to_numpy(global_scope(), _persist(tr))
    assert any(not np.array_equal(after[n], want[n]) for n in want)
    fresh = Scope()
    assert checkpoint.load_checkpoint(d, tr.main_program, scope=fresh,
                                      device="cpu") == 4
    got = scope_to_numpy(fresh, _persist(tr))
    for n, v in want.items():
        assert np.array_equal(got[n], v), n


@pytest.mark.cuda
def test_load_into_a_captured_executor(cuda_device, tune_dir, tmp_path):
    with scope_guard(Scope()):
        tr, spec = _lm_trainer()
        losses = []

        def handler(e):
            if isinstance(e, EndIteration):
                losses.append(e.cost)

        tr.train(_reader(spec, 0, 4), event_handler=handler, pipeline=False)
        d = tr.save_checkpoint(str(tmp_path / "ck"), sharded=True)
        tr.train(_reader(spec, 4, 6), event_handler=handler, pipeline=False)
        ref = list(losses)
        captures = tr.exe.stats["graph_captures"]
        checkpoint.load_checkpoint(d, tr.main_program)
        assert global_scope().find_var(
            _persist(tr)[0]).device.type == "cuda"
        del losses[:]
        tr.train(_reader(spec, 4, 6), event_handler=handler, pipeline=False)
        assert losses == ref[4:6]
        assert tr.exe.stats["graph_captures"] == captures
        assert tr.exe.stats["eager_runs"] == 0


@pytest.mark.cuda
def test_inference_model_runs_compiled_on_the_flash_forward(
        cuda_device, tune_dir, tmp_path):
    d = str(tmp_path / "model")
    with scope_guard(Scope()):
        tr, spec = _lm_trainer()
        tr.train(_reader(spec, 0, 2), pipeline=False)
        logits = spec["cost"].block.var(
            spec["cost"].op.input("X")[0]).op.input("Logits")[0]
        feed = {"toks": np.stack([s[0] for s in next(iter(
            spec["reader"]()))])}
        tr.save_inference_model(d, ["toks"], [logits])
        want = tr.exe.run(tr._test_program([logits]), feed=feed,
                          fetch_list=[logits])[0]
    assert not any("moment" in f for f in os.listdir(d))
    with scope_guard(Scope()):
        exe = Executor("cuda")
        program, feeds, fetches = io.load_inference_model(d, exe)
        outs, counts = [], []
        for _ in range(3):
            kernels.reset_launches()
            outs.append(exe.run(program, feed=feed, fetch_list=fetches)[0])
            counts.append(kernels.launch_counts())
        assert exe.stats["graph_captures"] == 1
        assert exe.stats["graph_replays"] == 2
        exe.close()
    for c in counts:
        assert c["flash_attention_fwd"] == LM["num_layers"], c
        assert c["flash_attention_bwd_dkv"] == c["flash_attention_bwd_dq"] \
            == 0
    for got in outs:
        assert np.array_equal(got, want)
