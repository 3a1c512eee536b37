"""Clipping, schedules and ModelAverage on the card, with the Executor's
compiled step (a CUDA graph replayed, the scope's state tensors written
in place).

- A scheduled program is captured once: the step counter stays int64
  and the LR fetched at each replay is the schedule's value at that
  step, not step 1's baked in (no host read of the counter or the LR).
- Global-norm clipping is captured: the replayed steps equal the per-op
  path's bit for bit, with one capture and no fallback.
- ``ModelAverage`` around replays: ``apply`` / ``restore`` between
  replays leave the training run bit-identical to one without them, and
  the averaged values reach the next run through the scope.

JAX-free, so that it runs where the card is. Tolerance: none (LRs within
1e-6 relative of their closed form).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import clip, learning_rate_decay, tune  # noqa: E402
from paddle_tpu_torch import optimizer, regularizer  # noqa: E402
from paddle_tpu_torch.configs import tiny_lm  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope  # noqa: E402
from paddle_tpu_torch.flags import flags_guard  # noqa: E402

LM = dict(hidden=64, num_heads=2, num_layers=2, seq=64, batch=4,
          samples=4 * 8)
STEPS = 6
COUNTER = "@LR_DECAY_COUNTER@"


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


def _lm(clip_norm=None, decay=None):
    """tiny_lm under Adam on an exponential schedule: (main, startup,
    spec, LR var)."""
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        spec = tiny_lm.model(**LM)
        if clip_norm is not None:
            clip.set_gradient_clip(clip.GradientClipByGlobalNorm(clip_norm))
        lr = learning_rate_decay.exponential_decay(
            0.01, decay_steps=2, decay_rate=0.5)
        optimizer.Adam(learning_rate=lr, regularization=(
            regularizer.L2Decay(decay) if decay else None)).minimize(
                spec["cost"])
    return main, start, spec, lr


def _feed(spec):
    b = next(iter(spec["reader"]()))
    return {"toks": np.stack([s[0] for s in b]),
            "tgt": np.stack([s[1] for s in b])}


def _run(dev, main, start, spec, lr, use_jit, steps=STEPS, between=None):
    exe, scope = Executor(dev), Scope()
    exe.run(start, scope=scope)
    feed = exe.prepare_feed(_feed(spec))
    outs = []
    for step in range(steps):
        if between is not None:
            between(step, scope)
        outs.append(exe.run(main, feed=feed, fetch_list=[spec["cost"], lr],
                            scope=scope, use_jit=use_jit))
    state = {v.name: scope.find_var(v.name).detach().cpu().clone()
             for v in main.list_vars() if v.persistable}
    stats = dict(exe.stats)
    exe.close()
    return outs, state, stats


@pytest.mark.cuda
def test_a_scheduled_program_is_captured_once_and_its_lr_moves(
        cuda_device, tune_dir):
    main, start, spec, lr = _lm()
    outs, state, stats = _run(cuda_device, main, start, spec, lr, True)
    assert stats["graph_captures"] == 1
    assert stats["graph_replays"] == STEPS - 1
    assert stats["eager_runs"] == 0
    lrs = [float(o[1][0]) for o in outs]
    for s, got in enumerate(lrs):
        want = 0.01 * 0.5 ** (s / 2)
        assert abs(got - want) <= 1e-6 * want, (s, got, want)
    assert len(set(lrs)) == STEPS
    assert state[COUNTER].dtype == torch.int64
    assert state[COUNTER].tolist() == [STEPS - 1]


@pytest.mark.cuda
def test_global_norm_clipping_is_captured_bit_identical_to_eager(
        cuda_device, tune_dir):
    main, start, spec, lr = _lm(clip_norm=0.1, decay=0.01)
    # both startups draw from a generator seeded alike
    got, g_state, stats = _run(cuda_device, main, start, spec, lr, True)
    want, w_state, _ = _run(cuda_device, main, start, spec, lr, False)
    assert stats["graph_captures"] == 1 and stats["eager_runs"] == 0
    for a, b in zip(got, want):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    for n, v in w_state.items():
        assert torch.equal(g_state[n], v), n
    assert not math.isnan(float(got[-1][0][0]))


@pytest.mark.cuda
def test_model_average_around_replays_leaves_training_unchanged(
        cuda_device, tune_dir):
    main, start, spec, lr = _lm(clip_norm=1.0)
    params = [p.name for p in main.all_parameters()]
    seen = {}

    def around(step, scope):
        if step == 3:
            # a window of 2 updates: the average of w and w / 2
            avg = optimizer.ModelAverage(min_average_window=2,
                                         max_average_window=2,
                                         program=main, scope=scope)
            avg.update()
            w = params[0]
            before = scope.find_var(w).clone()
            scope.set_var(w, before * 0.5)
            avg.update()
            avg.apply()
            seen["applied"] = scope.find_var(w).clone()
            seen["want"] = before * 0.75
            avg.restore()
            seen["restored"] = torch.equal(scope.find_var(w), before * 0.5)
            scope.set_var(w, before)

    plain, p_state, _ = _run(cuda_device, main, start, spec, lr, True)
    got, g_state, stats = _run(cuda_device, main, start, spec, lr, True,
                               between=around)
    assert stats["graph_captures"] == 1 and stats["eager_runs"] == 0
    torch.testing.assert_close(seen["applied"], seen["want"], rtol=1e-6,
                               atol=1e-7)
    assert seen["restored"]
    for a, b in zip(got, plain):
        assert np.array_equal(a[0], b[0])
    for n, v in p_state.items():
        assert torch.equal(g_state[n], v), n
