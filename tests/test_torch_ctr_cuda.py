"""Sparse rows on the card: lazy Adam inside a captured step.

A small wide&deep (6 slots, vocabulary 5000, embedding 8) under
``Adam(lazy_mode=True)``, 5 compiled steps (the warm-up, the capture,
three replays) on batches with repeated ids:

- one capture and a replay a step, no eager fallback;
- the rows no step looked up, and their moments, bit-identical to the
  startup's (strict);
- each step's looked-up rows within 1e-6 of max(1, |p|) of a float64
  recomputation from the fetched SelectedRows gradient; a row's
  duplicates are summed by ``index_add_``, whose atomics on the card may
  add them in another order on each run, so the compiled run is held to
  the per-op run at that tolerance and not bit for bit;
- ``sgd`` on a SelectedRows gradient captured the same way.

JAX-free, so that it runs where the card is.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import models, optimizer  # noqa: E402
from paddle_tpu_torch.core import ir, unique_name  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope  # noqa: E402
from paddle_tpu_torch.flags import flags_guard  # noqa: E402

SLOTS, DENSE, VOCAB, EMB = 6, 4, 5000, 8
STEPS = 5
LR = 0.05
UPDATE_TOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _no_tune(tmp_path):
    with flags_guard(tune_cache_dir=str(tmp_path / "tune")):
        yield


def _program(opt):
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        cost, _a, _p, _f = models.wide_deep(
            num_sparse_slots=SLOTS, dense_dim=DENSE, vocab_size=VOCAB,
            embed_dim=EMB, hidden_sizes=(16,), with_auc=False)
        opt().minimize(cost)
    return main, start, cost.name


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        feed = models.synthetic_click_batch(rng, 64, SLOTS, DENSE, VOCAB)
        for i in range(SLOTS):
            # repeated ids: each batch looks some rows up several times
            feed["C%d" % i] = feed["C%d" % i] % 40 + 100 * i
        out.append(feed)
    return out


def _tables(main):
    slots = {}
    for op in main.global_block().ops:
        if op.type in ("adam", "sgd"):
            p = op.input("Param")[0]
            if p.startswith(("emb_", "wide_")):
                names = ("Grad", "Moment1", "Moment2", "Beta1Pow",
                         "Beta2Pow") if op.type == "adam" else ("Grad",)
                slots[p] = {s: op.input(s)[0] for s in names}
    return slots


@pytest.mark.cuda
def test_lazy_adam_captured_moves_only_looked_up_rows(cuda_device):
    dev = cuda_device
    main, start, cost = _program(
        lambda: optimizer.Adam(learning_rate=LR, lazy_mode=True))
    tables = _tables(main)
    exe, scope = Executor(dev), Scope()
    exe.run(start, scope=scope)
    names = [n for t, s in tables.items()
             for n in (t, s["Moment1"], s["Moment2"])]
    initial = {n: scope.find_var(n).clone() for n in names}
    ref_exe, ref_scope = Executor(dev), Scope()
    for n in scope.local_var_names():
        v = scope.find_var(n)
        if isinstance(v, torch.Tensor):
            ref_scope.set_var(n, v.clone())
    grads = [tables[t]["Grad"] for t in sorted(tables)]
    touched = {t: set() for t in tables}
    before = dict(exe.stats)
    worst = 0.0
    for feed in _batches():
        pre = {}
        for t in sorted(tables):
            ids = np.unique(feed["C" + t.rsplit("_C", 1)[1]])
            touched[t].update(ids.tolist())
            rows = torch.as_tensor(ids, device=dev)
            s = tables[t]
            pre[t] = (rows, scope.find_var(t)[rows].double(),
                      scope.find_var(s["Moment1"])[rows].double(),
                      scope.find_var(s["Moment2"])[rows].double(),
                      float(scope.find_var(s["Beta1Pow"]).reshape(-1)[0]),
                      float(scope.find_var(s["Beta2Pow"]).reshape(-1)[0]))
        out = exe.run(main, feed=feed, fetch_list=[cost] + grads,
                      scope=scope, return_numpy=False)
        ref_exe.run(main, feed=feed, fetch_list=[cost], scope=ref_scope,
                    use_jit=False)
        for t, g in zip(sorted(tables), out[1:]):
            rows, p, m1, m2, b1p, b2p = pre[t]
            uniq, inv = torch.unique(g.rows, sorted=True, return_inverse=True)
            assert torch.equal(uniq, rows)
            gr = torch.zeros((uniq.numel(), g.values.shape[1]),
                             dtype=torch.float64, device=dev)
            gr.index_add_(0, inv, g.values.double())
            lr = LR * math.sqrt(1 - b2p) / (1 - b1p)
            m1n = 0.9 * m1 + 0.1 * gr
            m2n = 0.999 * m2 + 0.001 * gr * gr
            pn = p - lr * m1n / (torch.sqrt(m2n) + 1e-8)
            scale = max(1.0, float(p.abs().max()))
            worst = max(worst, float(
                (scope.find_var(t)[rows].double() - pn).abs().max()) / scale)
    delta = {k: exe.stats[k] - before[k] for k in
             ("jit_runs", "eager_runs", "graph_captures", "graph_replays")}
    assert delta == {"jit_runs": STEPS, "eager_runs": 0,
                     "graph_captures": 1, "graph_replays": STEPS - 1}
    assert worst <= UPDATE_TOL, worst
    for t in tables:
        keep = torch.ones(VOCAB, dtype=torch.bool, device=dev)
        keep[torch.as_tensor(sorted(touched[t]), device=dev)] = False
        s = tables[t]
        for n in (t, s["Moment1"], s["Moment2"]):
            assert torch.equal(scope.find_var(n)[keep], initial[n][keep]), n
            got, want = scope.find_var(n), ref_scope.find_var(n)
            assert float((got - want).abs().max()) <= UPDATE_TOL * max(
                1.0, float(want.abs().max())), n


@pytest.mark.cuda
def test_sparse_sgd_captured_equals_per_op(cuda_device):
    dev = cuda_device
    main, start, cost = _program(lambda: optimizer.SGD(learning_rate=LR))
    tables = _tables(main)
    runs = {}
    for use_jit in (True, False):
        exe, scope = Executor(dev), Scope()
        exe.run(start, scope=scope)
        initial = {t: scope.find_var(t).clone() for t in tables}
        for feed in _batches():
            exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                    use_jit=use_jit)
        runs[use_jit] = {t: scope.find_var(t).clone() for t in tables}
        if use_jit:
            assert exe.stats["graph_captures"] == 1
        moved = {t: int((runs[use_jit][t] != initial[t]).any(1).sum())
                 for t in tables}
        assert all(0 < m <= 40 for m in moved.values()), moved
    for t in tables:
        a, b = runs[True][t], runs[False][t]
        assert float((a - b).abs().max()) <= UPDATE_TOL * max(
            1.0, float(b.abs().max())), t
