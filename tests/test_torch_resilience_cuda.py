"""The numeric guardrails and the step watchdog on the card, with the
Executor's compiled step (a CUDA graph replayed, the scope's state
tensors written in place).

- A NaN written through the scope into a weight of a captured LM step
  before batch 2: batches 2 and 3 are skipped (``nonfinite``), one
  ``guard_rewind`` follows, batches 4-5 are accepted and finite; the
  rewind installs the checkpoint's tensors and the next replay copies
  them into the captured ones, so ``graph_captures`` does not move and
  every step is one replay; the accepted losses equal, bit for bit, a
  rerun of batches 4-5 from the same checkpoint on the same Trainer
  (the Adam moments, beta powers and parameters all came back). The
  flash forward and backward launch on this path. Synchronous and
  pipelined.
- ``python -m paddle_tpu_torch train`` on the card under
  ``PADDLE_TPU_FLAGS=step_timeout_s=5`` and a seeded hang
  (``trainer.step:delay:nth=3``) exits 75 from the monitor thread, with
  one durable ``step_hung`` line and a timeline artifact.

JAX-free, so that it runs where the card is. Tolerance: none.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels, profiler, tune  # noqa: E402
from paddle_tpu_torch.configs import tiny_lm  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.scope import Scope, global_scope, scope_guard  # noqa: E402,E501
from paddle_tpu_torch.flags import flags_guard  # noqa: E402
from paddle_tpu_torch.resilience import events  # noqa: E402
from paddle_tpu_torch.resilience.watchdog import STEP_HUNG_EXIT  # noqa: E402
from paddle_tpu_torch.trainer import Trainer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = dict(hidden=64, num_heads=2, num_layers=2, seq=64, batch=4,
          samples=4 * 9)
NAN_AT = 2


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


@pytest.fixture(autouse=True)
def _clean():
    events.clear_events()
    profiler.reset_trainer_counters()
    yield
    events.clear_events()


def _lm_trainer(checkpoint_dir):
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        spec = tiny_lm.model(**LM)
        tr = Trainer(spec["cost"], spec["optimizer"], spec["feed_list"],
                     device="cuda", main_program=main, startup_program=start,
                     checkpoint_dir=checkpoint_dir)
    return tr, spec


def _reader(batches):
    return lambda: iter(list(batches))


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["sync", "pipelined"])
def test_nan_in_a_captured_step_is_skipped_and_rewound_without_recapture(
        cuda_device, tune_dir, tmp_path, pipeline):
    ck = str(tmp_path / "ck")
    with scope_guard(Scope()):
        tr, spec = _lm_trainer(ck)
        batches = list(spec["reader"]())
        tr.train(_reader(batches[:3]), pipeline=pipeline)   # saves
        shutil.copytree(ck, str(tmp_path / "clean"))
        weight = sorted(p.name for p in
                        tr.main_program.global_block().all_parameters()
                        if len(p.shape) == 2)[0]
        captures = tr.exe.stats["graph_captures"]
        replays = tr.exe.stats["graph_replays"]
        losses = {}

        def handler(e):
            if type(e).__name__ == "BeginIteration" and \
                    e.batch_id == NAN_AT:
                global_scope().find_var(weight)[0, 0] = float("nan")
            elif type(e).__name__ == "EndIteration":
                losses[e.batch_id] = float(e.cost)

        kernels.reset_launches()
        with flags_guard(loss_skip_budget=2):
            tr.train(_reader(batches[3:9]), event_handler=handler,
                     pipeline=pipeline)
        launches = kernels.launch_counts()
        trail = [(e["kind"], e.get("reason"), e["batch_id"])
                 for e in events.events()
                 if e["kind"] in ("batch_skipped", "guard_rewind")]
        assert trail == [("batch_skipped", "nonfinite", NAN_AT),
                         ("batch_skipped", "nonfinite", NAN_AT + 1),
                         ("guard_rewind", "nonfinite", NAN_AT + 1)]
        assert profiler.trainer_counters() == {"batches_skipped": 2.0,
                                               "guard_rewinds": 1.0}
        assert tr.exe.stats["graph_captures"] == captures
        assert tr.exe.stats["graph_replays"] == replays + 6
        assert tr.exe.stats["eager_runs"] == 0
        assert launches["flash_attention_fwd"] > 0
        assert launches["flash_attention_bwd_dkv"] > 0
        assert launches["flash_attention_bwd_dq"] > 0
        after = [losses[b] for b in (4, 5)]
        assert all(np.isfinite(after))
        tr.checkpoint_dir = str(tmp_path / "clean")
        assert tr._load_checkpoint_state() is True
        rerun = []
        tr.train(_reader(batches[3 + 4:9]), pipeline=pipeline,
                 event_handler=lambda e: rerun.append(float(e.cost))
                 if type(e).__name__ == "EndIteration" else None)
        assert rerun == after
        assert tr.exe.stats["graph_captures"] == captures
        tr.exe.close()


@pytest.mark.cuda
def test_a_wedged_step_exits_75_with_its_event_and_timeline(cuda_device,
                                                            tmp_path):
    state = tmp_path / "state"
    state.mkdir()
    env = dict(os.environ, PYTHONPATH=ROOT,
               PADDLE_TPU_FLAGS="step_timeout_s=5",
               PADDLE_TPU_FAULT_SPEC="trainer.step:delay:nth=3,delay=3600",
               PADDLE_TPU_ELASTIC_STATE=str(state))
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join(ROOT, "paddle_tpu_torch", "configs", "fit_a_line.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == STEP_HUNG_EXIT, out.stderr[-3000:]
    rows = [json.loads(ln) for ln in open(state / "events.jsonl")]
    hung = [r for r in rows if r["kind"] == "step_hung"]
    assert len(hung) == 1 and hung[0]["label"] == "pass0/batch2"
    art = json.load(open(hung[0]["timeline"]))
    assert art["schema"] == "paddle_tpu.timeline.v1"
    assert art["trainer"]["steps_hung"] == 1.0
