"""The Executor's memory on the card: each value freed at its last use,
and the memory preflight against the card's own memory.

JAX-free, so that it runs where the card is:

- a mid-size LM step on the per-op path peaks lower with the release
  schedule than through ``trace_ops`` keeping every value (the parent's
  Executor), with the same loss and state bit for bit;
- a step whose plan exceeds the card's memory (``mem_get_info``, no
  budget flag) is refused with PT030 before it allocates anything;
- a captured step's private pool is smaller with the release than with
  every value kept, the replays bit-identical.
"""
import contextlib
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.analysis import ProgramVerifyError  # noqa: E402
from paddle_tpu_torch.analysis import memory as tmem  # noqa: E402
from paddle_tpu_torch.configs import tiny_lm  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import Executor, trace_ops  # noqa: E402
from paddle_tpu_torch.core.scope import Scope  # noqa: E402
from paddle_tpu_torch.flags import flags_guard  # noqa: E402

# a mid-size LM: 4 layers at hidden 256 over 1024 tokens, batch 8
LM = dict(vocab=8192, seq=1024, hidden=256, num_layers=4, num_heads=4,
          batch=8, samples=1, learning_rate=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _lm(dev, **kw):
    """(main, cost name, feed on the card, state on the card)."""
    cfg = dict(LM, **kw)
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        spec = tiny_lm.model(**cfg)
        spec["optimizer"].minimize(spec["cost"])
    scope = Scope()
    exe = Executor(dev)
    exe.run(start, scope=scope)
    toks = np.random.RandomState(0).randint(
        0, cfg["vocab"], (cfg["batch"], cfg["seq"])).astype(np.int64)
    feed = exe.prepare_feed({"toks": toks, "tgt": (toks + 1) % cfg["vocab"]})
    state = {v.name: scope.find_var(v.name).clone()
             for v in main.list_vars() if v.persistable
             and isinstance(scope.find_var(v.name), torch.Tensor)}
    return main, spec["cost"].name, feed, state


@contextlib.contextmanager
def _keep_all(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(tmem, "release_schedule",
                  lambda block, ops, keep: [()] * len(ops))
        yield


def _peak(dev, fn):
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return out, torch.cuda.max_memory_allocated(dev) - base


@pytest.mark.cuda
def test_release_lowers_the_per_op_peak_with_the_same_bits(cuda_device):
    dev = cuda_device
    main, cost, feed, state = _lm(dev)

    def keep_all():
        env = dict(feed)
        env.update({n: t.clone() for n, t in state.items()})
        with torch.no_grad():
            trace_ops(main.global_block(), env,
                      torch.Generator(device=dev).manual_seed(0), dev)
        return env[cost].clone(), {n: env[n] for n in state}

    def release():
        scope = Scope()
        for n, t in state.items():
            scope.set_var(n, t.clone())
        loss, = Executor(dev).run(main, feed=feed, fetch_list=[cost],
                                  scope=scope, use_jit=False,
                                  return_numpy=False)
        return loss, {n: scope.find_var(n) for n in state}

    (k_loss, k_state), k_peak = _peak(dev, keep_all)
    (r_loss, r_state), r_peak = _peak(dev, release)
    assert torch.equal(k_loss, r_loss)
    for n in state:
        assert torch.equal(k_state[n], r_state[n]), n
    assert r_peak <= 0.8 * k_peak, (r_peak, k_peak)
    plan = tmem.plan_memory(main, batch=LM["batch"], fetches=[cost])
    assert plan.peak_bytes <= r_peak


@pytest.mark.cuda
def test_pt030_refuses_with_the_cards_memory_as_budget(cuda_device):
    dev = cuda_device
    main, cost, feed, state = _lm(dev, batch=4096)
    total = torch.cuda.mem_get_info(dev)[1]
    plan = tmem.plan_memory(main, batch=4096, fetches=[cost])
    assert plan.peak_bytes > total
    scope = Scope()
    for n, t in state.items():
        scope.set_var(n, t)
    exe = Executor(dev)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    with flags_guard(verify=True, memory_budget_gb=0.0):
        with pytest.raises(ProgramVerifyError) as ei:
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    torch.cuda.synchronize(dev)
    msg = str(ei.value)
    assert "PT030" in msg and plan.peak_op_ref() in msg
    assert "[budget %s]" % tmem.fmt_bytes(total) in msg
    assert torch.cuda.memory_allocated(dev) - before < (64 << 20)
    assert exe.stats["jit_runs"] == exe.stats["eager_runs"] == 0


def _pool_bytes(pool):
    return sum(seg["total_size"] for seg in
               torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


@pytest.mark.cuda
def test_a_captured_steps_pool_is_smaller_with_the_release(cuda_device,
                                                           monkeypatch):
    dev = cuda_device
    main, cost, feed, state = _lm(dev)

    def compiled():
        scope = Scope()
        for n, t in state.items():
            scope.set_var(n, t.clone())
        exe = Executor(dev)
        losses = [exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                          return_numpy=False)[0] for _ in range(4)]
        # the warm-up, the capture (which replays once) and two replays
        assert exe.stats["graph_captures"] == 1
        assert exe.stats["graph_replays"] == 3
        pool = _pool_bytes(exe._pool)
        final = {n: scope.find_var(n).clone() for n in state}
        exe.close()
        return losses, final, pool

    r_losses, r_final, r_pool = compiled()
    gc.collect()
    torch.cuda.empty_cache()
    with _keep_all(monkeypatch):
        k_losses, k_final, k_pool = compiled()
    for a, b in zip(r_losses, k_losses):
        assert torch.equal(a, b)
    for n in state:
        assert torch.equal(r_final[n], k_final[n]), n
    assert 0 < r_pool < k_pool, (r_pool, k_pool)
