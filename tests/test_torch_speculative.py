"""Speculative decoding in the port, held against the JAX package on the
CPU: the k-wide face of the paged attention, the verify step, the
draft's propose step, the accept rule, the engine's rounds, the paired
artifact, the service and the HTTP body.

Weights are made with numpy from a seed and carried into both packages.
Greedy decode is exact in both, so greedy tokens must be identical
(to the port's plain engine, to the JAX engine and to the sequential
reference decoder), whatever the draft. Tempered rows draw from each
package's own stream, so they are held to their distribution (a
chi-square test of the accept rule) and to replay within the port.
Tolerances: 1e-5 absolute on attention outputs of size ~1 and 1e-5 of
the largest magnitude on logits, float32 on both sides, where only
summation orders differ.
"""
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from scipy import stats as sps  # noqa: E402

from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention_kwide as jax_kwide)
from paddle_tpu.models import transformer as jtm  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu_torch import inference as tinf  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402
from paddle_tpu_torch.resilience import events, faults  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    BlockTable, GenerationEngine, InferenceService, PagePool, PoolExhausted,
    make_server, reference_decode)

VOCAB, MAX_SEQ = 23, 48
TOL = 1e-5


def _np_params(jmodel):
    return {n: np.asarray(jmodel.params[n])
            for n in jtm.param_names(jmodel.config)}


@pytest.fixture(scope="module")
def jax_model():
    cfg = jtm.TransformerConfig(vocab_size=VOCAB, hidden=16, num_layers=2,
                                num_heads=2, max_seq=MAX_SEQ)
    return jtm.TransformerLM(jtm.init_params(cfg, seed=3), cfg)


@pytest.fixture(scope="module")
def jax_draft(jax_model):
    # a deliberately wrong draft: the target's weights plus noise, so
    # acceptance is partial and the reject path runs
    rng = np.random.RandomState(9)
    params = {k: v + rng.randn(*v.shape).astype(np.float32) * 0.02
              for k, v in _np_params(jax_model).items()}
    return jtm.TransformerLM(params, jax_model.config)


def _port(jmodel):
    return ttm.TransformerLM.from_numpy(_np_params(jmodel),
                                        jmodel.config.to_dict(),
                                        device="cpu")


@pytest.fixture(scope="module")
def model(jax_model):
    return _port(jax_model)


@pytest.fixture(scope="module")
def draft(jax_draft):
    return _port(jax_draft)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    events.clear_events()
    yield
    faults.reset()


def _engine(model, **kw):
    kw.setdefault("max_running", 4)
    kw.setdefault("kv_pages", 64)
    kw.setdefault("page_tokens", 8)
    kw.setdefault("queue_depth", 64)
    return GenerationEngine(model, **kw)


# -- the k-wide face of the paged attention -----------------------------------

def _kwide_operands(R, K1, pages, MB, T, nh, dh, seed):
    """Row 0 on the trash page at position 0; the other rows' lanes at
    consecutive positions, the last row's running past the table."""
    rng = np.random.RandomState(seed)
    q = rng.randn(R, K1, nh, dh).astype(np.float32)
    kp = rng.randn(pages + 1, T, nh, dh).astype(np.float32)
    vp = rng.randn(pages + 1, T, nh, dh).astype(np.float32)
    tables = rng.randint(0, pages, (R, MB)).astype(np.int32)
    start = rng.randint(0, MB * T, (R,))
    start[-1] = MB * T - 2
    positions = (start[:, None] + np.arange(K1)[None, :]).astype(np.int32)
    tables[0] = pages
    positions[0] = 0
    return q, kp, vp, tables, positions


KWIDE_GRID = [(3, 5, 12, 4, 8, 2, 8), (4, 3, 20, 6, 4, 3, 16),
              (2, 2, 6, 2, 16, 1, 32)]


@pytest.mark.parametrize("shape", KWIDE_GRID)
def test_kwide_plain_version_matches_jax_gather_path(shape):
    ops = _kwide_operands(*shape, seed=sum(shape))
    want = np.asarray(jax_kwide(
        *[jnp.asarray(a) for a in ops]))
    got = tpa.paged_attention_kwide_reference(
        *[torch.from_numpy(a) for a in ops]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", KWIDE_GRID)
def test_kwide_lanes_flattened_onto_rows_are_the_same_function(shape):
    # what the face hands the row-1 kernel on CUDA: R * K1 rows, each
    # row's table repeated, one position a row
    q, kp, vp, tables, positions = [
        torch.from_numpy(a) for a in _kwide_operands(*shape, seed=7)]
    R, K1, nh, dh = q.shape
    flat = tpa.paged_attention_reference(
        q.reshape(R * K1, nh, dh), kp, vp,
        tables.repeat_interleave(K1, dim=0), positions.reshape(R * K1))
    want = tpa.paged_attention_kwide_reference(q, kp, vp, tables,
                                               positions)
    torch.testing.assert_close(flat.reshape(R, K1, nh, dh), want, rtol=0,
                               atol=TOL)


def test_kwide_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    ops = [torch.from_numpy(a) for a in _kwide_operands(*KWIDE_GRID[0],
                                                         seed=5)]
    before = tpa.launches
    got = tpa.paged_attention_kwide(*ops)
    assert tpa.launches == before
    torch.testing.assert_close(
        got, tpa.paged_attention_kwide_reference(*ops), rtol=0, atol=0)


# -- the round's functions against the JAX package's -------------------------

def _pools(cfg, pages, T, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, pages + 1, T, cfg.num_heads, cfg.head_dim)
    return (rng.randn(*shape).astype(np.float32) * 0.5,
            rng.randn(*shape).astype(np.float32) * 0.5)


def _round_operands(seed, R=4, MB=6, T=8, pages=24):
    rng = np.random.RandomState(seed)
    tables = rng.permutation(pages)[:R * MB].reshape(R, MB).astype(np.int32)
    positions = np.array([5, 17, 30, 0][:R], np.int32)
    tokens = rng.randint(0, VOCAB, (R,)).astype(np.int32)
    active = np.array([True, True, True, False][:R])
    caps = np.array([4, 2, 0, 0][:R], np.int32)
    return tables, positions, tokens, active, caps


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_verify_step_logits_and_writes_match_jax(jax_model, model):
    cfg = jax_model.config
    T, pages, K1 = 8, 24, 5
    kp, vp = _pools(cfg, pages, T, 1)
    tables, positions, _, active, caps = _round_operands(2)
    tokens = np.random.RandomState(3).randint(
        0, VOCAB, (4, K1)).astype(np.int32)
    want, jkp, jvp = jtm.verify_step(
        jax_model.params, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(tokens),
        jnp.asarray(active), jnp.asarray(caps), cfg)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        got = ttm.verify_step(
            model.params, tkp, tvp, torch.from_numpy(tables),
            torch.from_numpy(positions), torch.from_numpy(tokens),
            torch.from_numpy(active), torch.from_numpy(caps), model.config)
    assert got.shape == (4, K1, VOCAB)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    # every page but the trash page holds what the JAX step wrote
    for mine, theirs in ((tkp, jkp), (tvp, jvp)):
        np.testing.assert_allclose(mine.numpy()[:, :pages],
                                   np.asarray(theirs)[:, :pages], rtol=0,
                                   atol=TOL)
    # and the lanes past the caps wrote nothing live
    assert not np.array_equal(tkp.numpy()[:, :pages], kp[:, :pages])
    live = np.zeros((pages,), bool)
    for r in range(4):
        if active[r]:
            for i in range(caps[r] + 1):
                live[tables[r, (positions[r] + i) // T]] = True
    np.testing.assert_array_equal(tkp.numpy()[:, :pages][:, ~live],
                                  kp[:, :pages][:, ~live])


def test_greedy_draft_propose_matches_jax(jax_draft, draft):
    cfg = jax_draft.config
    T, pages, k = 8, 24, 4
    kp, vp = _pools(cfg, pages, T, 4)
    tables, positions, tokens, active, caps = _round_operands(5)
    temps = np.zeros((4,), np.float32)
    seeds = np.arange(4, dtype=np.int32)
    jd, jl, jkp, _ = jtm.draft_propose_step(
        jax_draft.params, jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(tokens),
        jnp.asarray(active), jnp.asarray(temps), jnp.asarray(seeds),
        jnp.asarray(caps), k, cfg)
    tkp, tvp = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        d, dl = ttm.draft_propose_step(
            draft.params, tkp, tvp, torch.from_numpy(tables),
            torch.from_numpy(positions), torch.from_numpy(tokens),
            torch.from_numpy(active), torch.from_numpy(temps),
            torch.from_numpy(seeds), torch.from_numpy(caps), k,
            draft.config)
    assert d.dtype == torch.int32 and d.shape == (4, k)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert _rel(dl.numpy(), np.asarray(jl)) <= TOL
    np.testing.assert_allclose(tkp.numpy()[:, :pages],
                               np.asarray(jkp)[:, :pages], rtol=0, atol=TOL)


def _accept_operands(seed, R=6, K=4, V=VOCAB):
    """Target and draft logits, and drafts that agree with the target's
    argmax for a prefix of each row's own length, then not."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(R, K + 1, V).astype(np.float32) * 2.0
    dlogits = rng.randn(R, K, V).astype(np.float32) * 2.0
    greedy = logits.argmax(-1)
    drafts = greedy[:, :K].copy()
    for r in range(R):
        agree = r % (K + 1)
        if agree < K:
            drafts[r, agree] = (greedy[r, agree] + 1 + r) % V
    caps = np.array([K, K, 2, 0, K, 3][:R], np.int32)
    positions = rng.randint(0, 40, (R,)).astype(np.int32)
    return logits, drafts.astype(np.int32), dlogits, positions, caps


def test_greedy_speculative_accept_matches_jax():
    logits, drafts, dlogits, positions, caps = _accept_operands(11)
    R = logits.shape[0]
    temps = np.zeros((R,), np.float32)
    seeds = np.arange(R, dtype=np.int32)
    je, jn, jlp = jtm.speculative_accept(
        *[jnp.asarray(a) for a in (logits, drafts, dlogits, positions,
                                   temps, seeds, caps)])
    e, n, lp = ttm.speculative_accept(
        *[torch.from_numpy(a) for a in (logits, drafts, dlogits, positions,
                                        temps, seeds, caps)])
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
                               atol=TOL)
    # every row's own length of agreement, capped: 1..K1 tokens out
    assert sorted(set(n.tolist())) == sorted(set(np.asarray(jn).tolist()))
    assert n.min() >= 1 and (n.numpy() <= caps + 1).all()


def test_tempered_accept_emits_the_target_distribution():
    # rejection sampling promises that the first emitted token is
    # distributed as softmax(target / temperature), whatever the draft
    N, V, temp = 20000, 8, 0.7
    rng = np.random.RandomState(21)
    target = rng.randn(V).astype(np.float32) * 1.5
    drow = rng.randn(V).astype(np.float32) * 1.5
    q = np.exp((target / temp - (target / temp).max()).astype(np.float64))
    q /= q.sum()
    p = np.exp((drow / temp - (drow / temp).max()).astype(np.float64))
    p /= p.sum()
    logits = np.broadcast_to(target, (N, 2, V)).copy()
    dlogits = np.broadcast_to(drow, (N, 1, V)).copy()
    drafts = rng.choice(V, size=(N, 1), p=p).astype(np.int32)
    positions = rng.randint(0, 1000, (N,)).astype(np.int32)
    seeds = np.arange(N, dtype=np.int32)
    e, n, _ = ttm.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(dlogits), torch.from_numpy(positions),
        torch.full((N,), temp), torch.from_numpy(seeds),
        torch.ones((N,), dtype=torch.int32))
    first = e[:, 0].numpy()
    accepted = int((n == 2).sum())
    assert 0.2 * N < accepted < 0.95 * N      # both paths really ran
    counts = np.bincount(first, minlength=V)
    _, pval = sps.chisquare(counts, N * q)
    assert pval > 1e-3, (counts, N * q)


def test_plain_row_reproduces_the_plain_stream():
    # a cap-0 row's token is the plain device sampler's draw at the same
    # position, tempered included (the unsalted key)
    logits, drafts, dlogits, positions, _ = _accept_operands(13)
    R = logits.shape[0]
    temps = torch.tensor([0.0, 0.5, 0.9, 1.3, 0.7, 2.0])
    seeds = torch.arange(R, dtype=torch.int32) * 7 + 1
    caps = torch.zeros((R,), dtype=torch.int32)
    e, n, lp = ttm.speculative_accept(
        torch.from_numpy(logits), torch.from_numpy(drafts),
        torch.from_numpy(dlogits), torch.from_numpy(positions), temps,
        seeds, caps)
    want, want_lp = ttm.device_sample(torch.from_numpy(logits[:, 0]), temps,
                                      seeds,
                                      torch.from_numpy(positions) + 1)
    assert (n == 1).all()
    assert torch.equal(e[:, 0], want)
    assert torch.equal(lp[:, 0], want_lp)


# -- the engine ---------------------------------------------------------------

PROMPTS = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10], [2, 4, 6, 8]]


def test_greedy_tokens_identical_on_every_path(jax_model, jax_draft, model,
                                               draft):
    want = [reference_decode(model, p, 10) for p in PROMPTS]
    with JaxEngine(jax_model, max_running=4, kv_pages=64, page_tokens=8,
                   queue_depth=64, warm=False, draft_model=jax_draft,
                   spec_k=4) as jeng:
        jax_tokens = [h.wait(timeout=300).tokens
                      for h in [jeng.submit(p, max_new_tokens=10)
                                for p in PROMPTS]]
        jst = jeng.stats
    assert jax_tokens == want and jst["speculative"]
    with _engine(model) as plain:
        assert [plain.generate(p, max_new_tokens=10, timeout=120).tokens
                for p in PROMPTS] == want
    for d, self_draft in ((model, True), (draft, False)):
        with _engine(model, draft_model=d, spec_k=4, warm=True) as eng:
            handles = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
            got = [h.wait(timeout=120) for h in handles]
            st = eng.stats
        assert [g.tokens for g in got] == want
        assert all(len(g.logprobs) == 10 for g in got)
        assert st["speculative"] and not st["spec_degraded"]
        assert st["spec_steps"] > 0 and st["draft_tokens"] > 0
        assert st["host_logit_syncs"] == 0
        assert st["accepted_tokens"] > 0
        assert st["page_utilization"]["live"] == 0
        assert st["draft_page_utilization"]["live"] == 0
        if self_draft:
            assert st["acceptance_rate"] == 1.0
        else:
            assert 0.0 < st["acceptance_rate"] < 1.0


def test_dead_lanes_past_the_context_are_clamped(jax_model, draft, model):
    # a request run to max_seq - 1 with spec_k 4: the lanes past each
    # row's cap reach positions max_seq .. max_seq + 3, which an
    # unclamped embedding or table lookup refuses
    prompt = list(range(1, 20))
    n = MAX_SEQ - len(prompt)
    want = reference_decode(model, prompt, n)
    with JaxEngine(jax_model, max_running=2, kv_pages=64, page_tokens=8,
                   warm=False) as jeng:
        assert jeng.generate(prompt, max_new_tokens=n,
                             timeout=300).tokens == want
    with _engine(model, max_running=2, draft_model=draft, spec_k=4) as eng:
        res = eng.generate(prompt, max_new_tokens=n, timeout=120)
        after = eng.generate([3, 4, 5], max_new_tokens=6, timeout=120)
        st = eng.stats
    assert res.tokens == want and res.finish_reason == "length"
    assert after.tokens == reference_decode(model, [3, 4, 5], 6)
    assert st["failed"] == 0 and not st["spec_degraded"]


def test_spec_k_zero_request_matches_plain_engine(model, draft):
    prompt = [1, 2, 3, 4, 5]
    with _engine(model) as plain, \
            _engine(model, draft_model=draft, spec_k=4) as spec:
        for temp, seed in ((0.0, 0), (0.9, 5), (1.3, 17)):
            a = plain.generate(prompt, max_new_tokens=10, temperature=temp,
                               seed=seed, timeout=120)
            b = spec.generate(prompt, max_new_tokens=10, temperature=temp,
                              seed=seed, timeout=120, spec_k=0)
            assert a.tokens == b.tokens, temp
            # the verify step's products run on R * K1 rows, the plain
            # step's on R: the logprobs agree to float32 sum orders
            np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                       atol=TOL)
        assert spec.stats["draft_tokens"] == 0     # caps really were 0
        assert spec.stats["spec_steps"] > 0


def test_a_rounds_tokens_share_its_gap_in_the_intertoken_stats(model):
    # self-draft, k 3: the prefill's token, then 2 rounds of 4 tokens;
    # each round's 4 gaps are one even share of the round's time, so the
    # statistic reads per token (not one round gap and 3 near-zeros)
    with _engine(model, draft_model=model, spec_k=3) as eng:
        eng.generate([1, 2, 3, 4, 5], max_new_tokens=9, timeout=120)
        st = eng.stats
        itl = list(eng._intertoken_ms)
    assert st["spec_steps"] == 2 and st["acceptance_rate"] == 1.0
    assert len(itl) == 8
    assert itl[:4] == [itl[0]] * 4 and itl[4:] == [itl[4]] * 4
    assert min(itl) > 0


def test_per_request_spec_k_validated(model, draft):
    with _engine(model, draft_model=draft, spec_k=4) as eng:
        with pytest.raises(ValueError):
            eng.submit([1, 2], max_new_tokens=4, spec_k=-1)


def test_tempered_stream_deterministic_and_resumed_after_preemption(
        model, draft):
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    with _engine(model, draft_model=draft, spec_k=3) as big:
        want = [big.generate(p, max_new_tokens=8, temperature=0.6,
                             seed=i + 5, timeout=120).tokens
                for i, p in enumerate(prompts)]
        again = [big.generate(p, max_new_tokens=8, temperature=0.6,
                              seed=i + 5, timeout=120).tokens
                 for i, p in enumerate(prompts)]
        assert big.stats["accepted_tokens"] > 0
    assert again == want
    with _engine(model, max_running=2, kv_pages=6, page_tokens=4,
                 reserve="prompt", draft_model=draft, spec_k=3) as pre:
        with pre._cond:       # both queued before the engine admits
            handles = [pre.submit(p, max_new_tokens=8, temperature=0.6,
                                  seed=i + 5)
                       for i, p in enumerate(prompts)]
        got = [h.wait(timeout=120).tokens for h in handles]
        st = pre.stats
    assert st["preemptions"] >= 1      # the scenario really preempted
    assert not st["spec_degraded"]     # pool pressure preempts, never degrades
    assert got == want
    assert st["page_utilization"]["live"] == 0


def test_speculate_fault_at_build_degrades(model, draft):
    prompt = [1, 2, 3]
    faults.arm("serving.speculate", "raise", nth=1, times=1)
    with _engine(model, draft_model=draft, spec_k=4) as eng:
        res = eng.generate(prompt, max_new_tokens=6, timeout=120)
        st = eng.stats
    assert res.tokens == reference_decode(model, prompt, 6)
    assert st["spec_degraded"] and not st["speculative"]
    evs = events.events(kind="speculation_degraded")
    assert evs and evs[0]["phase"] == "build"


def test_speculate_fault_at_propose_degrades_midstream(model, draft):
    prompt = [5, 6, 7, 8]
    with _engine(model, draft_model=draft, spec_k=4) as eng:
        # the draft prefill is hit 1, the first propose 2: fail the second
        faults.arm("serving.speculate", "raise", nth=3, times=1)
        res = eng.generate(prompt, max_new_tokens=8, timeout=120)
        st = eng.stats
    assert res.tokens == reference_decode(model, prompt, 8)
    assert st["spec_degraded"] and st["spec_steps"] == 1
    assert st["failed"] == 0
    evs = events.events(kind="speculation_degraded")
    assert evs and evs[0]["phase"] == "propose"


def test_generate_fault_at_a_round_fails_the_running_rows(model, draft):
    with _engine(model, draft_model=draft, spec_k=4) as eng:
        faults.arm("serving.generate", "raise", nth=2, times=1)
        with pytest.raises(faults.FaultError):
            eng.generate([1, 2, 3], max_new_tokens=8, timeout=120)
        res = eng.generate([1, 2, 3], max_new_tokens=8, timeout=120)
        st = eng.stats
    assert res.tokens == reference_decode(model, [1, 2, 3], 8)
    assert st["failed"] == 1 and st["speculative"]
    assert st["page_utilization"]["live"] == 0
    assert events.events(kind="generate_failed")[0]["phase"] == "decode"


def test_block_table_trim_frees_tail_pages_loudly():
    pool = PagePool(num_pages=8, page_tokens=4, num_layers=1, num_heads=1,
                    head_dim=4)
    table = BlockTable(pool)
    table.ensure(14)                   # 4 pages for 14 optimistic tokens
    assert pool.live == 4
    tail_page = table.pages[-1]
    assert table.trim(6) == 2 and pool.live == 2
    assert table.trim(6) == 0          # the same floor again: no-op
    with pytest.raises(ValueError):    # a trimmed page is free already
        pool.free([tail_page])
    table.ensure(14)                   # growing again reuses them
    assert pool.live == 4
    table.release()
    assert pool.live == 0


def test_spec_engine_sheds_what_the_pool_cannot_hold(model, draft):
    with _engine(model, draft_model=draft, spec_k=2, kv_pages=4,
                 page_tokens=4, max_running=1) as eng:
        with pytest.raises(PoolExhausted):
            eng.submit([1, 2, 3] * 9, max_new_tokens=8)
        assert eng.pool.live == 0


def test_draft_engine_refuses_a_mismatched_pairing(model):
    other = ttm.TransformerLM.from_numpy(
        ttm.init_params(ttm.TransformerConfig(
            vocab_size=VOCAB + 1, hidden=16, num_layers=1, num_heads=2,
            max_seq=MAX_SEQ), seed=1),
        dict(vocab_size=VOCAB + 1, hidden=16, num_layers=1, num_heads=2,
             max_seq=MAX_SEQ), device="cpu")
    with _engine(model, draft_model=other, spec_k=2) as eng:
        st = eng.stats
    assert st["spec_degraded"] and not st["speculative"]
    assert "vocab_size" in events.events(
        kind="speculation_degraded")[0]["error"]


# -- the paired artifact, the service and the HTTP body -----------------------

def test_export_load_speculative_roundtrip_and_jax_pairing(
        tmp_path, jax_model, jax_draft, model, draft):
    art = str(tmp_path / "spec")
    tinf.export_speculative(art, model.config, draft.config, 3,
                            params=model.params, draft_params=draft.params)
    assert tinf.is_speculative_artifact(art)
    assert tinf.validate_generative_artifact(art) == []
    target, loaded, k = tinf.load_speculative(art, device="cpu")
    assert k == 3
    for n, t in draft.params.items():
        assert torch.equal(getattr(loaded, n), t)
    # the JAX package loads the port's pairing, and the port the JAX one
    jt, jd, jk = jinf.load_speculative(art)
    assert jk == 3 and jd.config.to_dict() == jax_draft.config.to_dict()
    jart = str(tmp_path / "jax_spec")
    jinf.export_speculative(jart, jax_model.config, jax_draft.config, 2,
                            params=_np_params(jax_model),
                            draft_params=_np_params(jax_draft))
    t2, d2, k2 = tinf.load_speculative(jart, device="cpu")
    assert k2 == 2
    for n, t in model.params.items():
        assert torch.equal(getattr(t2, n), t)
    for n, t in draft.params.items():
        assert torch.equal(getattr(d2, n), t)
    # a broken pairing is a failed export
    with pytest.raises(ValueError, match="vocab_size"):
        tinf.export_speculative(
            str(tmp_path / "bad"), model.config,
            dict(draft.config.to_dict(), vocab_size=VOCAB + 1), 3,
            params=model.params, draft_params=draft.params)
    # a damaged draft is a named problem, and the pairing will not load
    os.remove(os.path.join(art, tinf.DRAFT_SUBDIR, tinf.GEN_PARAMS_FILE))
    assert any(tinf.DRAFT_SUBDIR in p
               for p in tinf.validate_generative_artifact(art))
    with pytest.raises(tinf.ArtifactError):
        tinf.load_speculative(art, device="cpu")
    with pytest.raises(tinf.ArtifactError, match="__spec__"):
        tinf.load_speculative(str(tmp_path / "nothing"), device="cpu")


def test_service_auto_pairs_a_jax_pairing_and_http_takes_spec_k(
        tmp_path, jax_model, jax_draft, model):
    art = str(tmp_path / "jax_spec")
    jinf.export_speculative(art, jax_model.config, jax_draft.config, 3,
                            params=_np_params(jax_model),
                            draft_params=_np_params(jax_draft))
    plain = str(tmp_path / "plain")
    tinf.export_generative(plain, model.config, params=model.params)
    prompt = [2, 4, 6]
    want = reference_decode(model, prompt, 5)
    svc = InferenceService()
    try:
        svc.load_model("lm", art, warm=False, device="cpu", max_running=2,
                       kv_pages=32, page_tokens=8)
        st = svc.stats["generation"]["lm"]
        assert st["speculative"] and st["spec_k"] == 3
        server = make_server(svc, host="127.0.0.1", port=0)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        base = "http://%s:%d" % server.server_address[:2]
        try:
            for spec_k in (None, 0, 2):
                body = {"tokens": prompt, "max_new_tokens": 5}
                if spec_k is not None:
                    body["spec_k"] = spec_k
                req = urllib.request.Request(
                    base + "/v1/models/lm:generate",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    assert json.loads(r.read())["tokens"] == want
        finally:
            server.shutdown()
            server.server_close()
        t.join(timeout=10)
        drafted = svc.stats["generation"]["lm"]["draft_tokens"]
        assert drafted > 0
        # a plain artifact loaded over it serves without a draft
        svc.load_model("lm", plain, warm=False, device="cpu",
                       max_running=2, kv_pages=32, page_tokens=8)
        assert not svc.stats["generation"]["lm"]["speculative"]
        assert svc.generate("lm", prompt, max_new_tokens=5,
                            timeout=120).tokens == want
    finally:
        svc.close()


def test_serve_cli_refuses_a_draft_dir_that_is_not_an_artifact(
        tmp_path, model):
    from paddle_tpu_torch.cli import main
    art = str(tmp_path / "gen")
    tinf.export_generative(art, model.config, params=model.params)
    assert main(["serve", art, "--device", "cpu", "--draft_dir",
                 str(tmp_path)]) == 1


def test_default_device_without_a_card_raises(tmp_path, model, draft):
    if torch.cuda.is_available():
        pytest.skip("this process has a card: the default device works")
    from paddle_tpu_torch.cli import main
    from paddle_tpu_torch.device import NoDeviceError
    art = str(tmp_path / "spec")
    tinf.export_speculative(art, model.config, draft.config, 2,
                            params=model.params, draft_params=draft.params)
    with pytest.raises(NoDeviceError):
        tinf.load_speculative(art)
    with pytest.raises(NoDeviceError):
        InferenceService().load_model("lm", art)
    assert main(["serve", art, "--draft_dir",
                 os.path.join(art, tinf.DRAFT_SUBDIR)]) == 1


def test_serve_cli_pairs_a_draft_dir_and_turns_sharing_on(tmp_path, model,
                                                           draft):
    import signal
    import subprocess
    import sys
    art, dd = str(tmp_path / "gen"), str(tmp_path / "draft")
    tinf.export_generative(art, model.config, params=model.params)
    tinf.export_generative(dd, draft.config, params=draft.params)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", art, "--port",
         "0", "--device", "cpu", "--name", "lm", "--max_running", "2",
         "--kv_pages", "16", "--page_tokens", "8", "--draft_dir", dd,
         "--spec_k", "2", "--prefix_sharing"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())["serving"]
        assert ready["speculative"] and ready["spec_k"] == 2
        assert ready["prefix_sharing"]
        for spec_k in (None, 0):
            body = {"tokens": [2, 4, 6], "max_new_tokens": 4}
            if spec_k is not None:
                body["spec_k"] = spec_k
            req = urllib.request.Request(
                "http://%s:%d/v1/models/lm:generate" % (ready["host"],
                                                        ready["port"]),
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
            assert out["tokens"] == reference_decode(model, [2, 4, 6], 4)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    st = json.loads(stdout.strip().splitlines()[-1])[
        "serving_stopped"]["stats"]["generation"]["lm"]
    assert st["completed"] == 2 and st["draft_tokens"] > 0
    assert st["prefix_hits"] > 0
