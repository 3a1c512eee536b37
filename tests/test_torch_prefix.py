"""Copy-on-write prefix sharing in the port, held against the JAX package
on the CPU: the refcounted page pool's ledger, the chain keys, the
prefix cache, and the engine with sharing on and off.

The pool and the keys are host bookkeeping, so they must agree with the
JAX package exactly: one seeded sequence of alloc / ref / free / trim
gives the same page ids, refcounts and free counts in both, and
``chunk_keys`` gives the same bytes. Greedy decode is exact in both
packages, so greedy tokens with sharing on must equal those with it off,
the JAX engine's and the sequential reference decoder's, and the prefix
counters must equal the JAX engine's. Every test that needs requests to
be concurrent queues them all before the engine admits any (it holds the
engine's lock while submitting), so nothing depends on thread timing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.models import transformer as jtm  # noqa: E402
from paddle_tpu.serving import BlockTable as JaxBlockTable  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.serving import PagePool as JaxPagePool  # noqa: E402
from paddle_tpu.serving.prefix import chunk_keys as jax_chunk_keys  # noqa
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402
from paddle_tpu_torch.resilience import events, faults  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    BlockTable, GenerationEngine, PagePool, PrefixCache, chunk_keys,
    pages_for, reference_decode)

VOCAB, MAX_SEQ = 23, 48


@pytest.fixture(scope="module")
def jax_model():
    cfg = jtm.TransformerConfig(vocab_size=VOCAB, hidden=16, num_layers=2,
                                num_heads=2, max_seq=MAX_SEQ)
    return jtm.TransformerLM(jtm.init_params(cfg, seed=3), cfg)


@pytest.fixture(scope="module")
def model(jax_model):
    params = {n: np.asarray(jax_model.params[n])
              for n in jtm.param_names(jax_model.config)}
    return ttm.TransformerLM.from_numpy(params, jax_model.config.to_dict(),
                                        device="cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    events.clear_events()
    yield
    faults.reset()


def _pool(cls=PagePool, **kw):
    kw.setdefault("num_pages", 12)
    kw.setdefault("page_tokens", 4)
    kw.setdefault("num_layers", 1)
    kw.setdefault("num_heads", 1)
    kw.setdefault("head_dim", 4)
    return cls(**kw)


def _engine(model, **kw):
    kw.setdefault("max_running", 4)
    kw.setdefault("kv_pages", 64)
    kw.setdefault("page_tokens", 8)
    kw.setdefault("queue_depth", 64)
    return GenerationEngine(model, **kw)


def _jax_engine(model, **kw):
    kw.setdefault("max_running", 4)
    kw.setdefault("kv_pages", 64)
    kw.setdefault("page_tokens", 8)
    kw.setdefault("queue_depth", 64)
    kw.setdefault("warm", False)
    return JaxEngine(model, **kw)


def _serve_queued(eng, prompts, max_new_tokens):
    """Queue every prompt before the engine admits one, then wait."""
    with eng._cond:
        handles = [eng.submit(p, max_new_tokens=max_new_tokens)
                   for p in prompts]
    return [h.wait(timeout=300).tokens for h in handles], eng.stats


# -- the pool's ledger and the keys, against the JAX package ----------------

def test_pool_ledger_matches_jax_under_seeded_traffic():
    rng = np.random.RandomState(17)
    pools = (_pool(num_pages=16), _pool(JaxPagePool, num_pages=16))
    holders = []           # [(port table, JAX table)], each freed once
    for step in range(400):
        op = rng.randint(4)
        avail = pools[0].available
        if op == 0 and avail:
            n = int(rng.randint(1, avail + 1))
            holders.append((BlockTable(pools[0], pools[0].alloc(n)),
                            JaxBlockTable(pools[1], pools[1].alloc(n))))
        elif op == 1 and holders:
            src = holders[rng.randint(len(holders))]
            pair = []
            for pool, table, cls in zip(pools, src,
                                        (BlockTable, JaxBlockTable)):
                pool.ref(table.pages)
                pair.append(cls(pool, list(table.pages)))
            holders.append(tuple(pair))
        elif op == 2 and holders:
            i = rng.randint(len(holders))
            keep = int(rng.randint(0, 4 * len(holders[i][0].pages) + 1))
            freed = [t.trim(keep) for t in holders[i]]
            assert freed[0] == freed[1]
        elif holders:
            for t in holders.pop(rng.randint(len(holders))):
                t.release()
        port, jax = pools
        assert [t.pages for t, _ in holders] == \
            [t.pages for _, t in holders], step
        assert port.available == jax.available, step
        assert port.live == jax.live and port.effective == jax.effective
        assert [port.refcount(p) for p in range(17)] == \
            [jax.refcount(p) for p in range(17)], step
        u, ju = port.utilization(), jax.utilization()
        assert {k: u[k] for k in ju} == ju, step
    for pair in holders:
        for t in pair:
            t.release()
    assert pools[0].live == 0 and pools[0].effective == 0


@pytest.mark.parametrize("tokens,T", [(list(range(10)), 4),
                                      ([5, 300, 7, 50256] * 9, 16),
                                      ([1], 8), (list(range(64)), 16)])
def test_chunk_keys_are_the_jax_packages_bytes(tokens, T):
    assert list(chunk_keys(tokens, T)) == list(jax_chunk_keys(tokens, T))


# -- the allocator's loud discipline -----------------------------------------

def test_refcount_pin_and_release_cycle():
    pool = _pool()
    pages = pool.alloc(2)
    assert all(pool.refcount(p) == 1 for p in pages)
    pool.ref(pages)                       # a second holder pins
    assert all(pool.refcount(p) == 2 for p in pages)
    assert pool.is_shared(pages[0])
    pool.free(pages)                      # down to 1: still live
    assert pool.live == 2 and pool.available == 10
    pool.free(pages)                      # zero: back on the free list
    assert pool.live == 0 and pool.available == 12


@pytest.mark.parametrize("case", ["double_free", "duplicate_in_one_call",
                                  "foreign_free", "foreign_ref"])
def test_bad_frees_and_refs_stay_loud(case):
    pool = _pool()
    (p,) = pool.alloc(1)
    pool.ref([p])
    with pytest.raises(ValueError):
        if case == "double_free":
            pool.free([p])
            pool.free([p])
            pool.free([p])
        elif case == "duplicate_in_one_call":
            pool.free([p, p])
        elif case == "foreign_free":
            pool.free([999])
        else:
            pool.ref([999])
    if case != "double_free":
        assert pool.refcount(p) == 2      # the refused call dropped nothing


def test_trim_on_a_shared_page_frees_only_its_own_reference():
    pool = _pool(num_pages=8)
    a = BlockTable(pool)
    a.ensure(8)                           # 2 pages
    pool.ref(a.pages)                     # b pins a's pages
    b = BlockTable(pool, pages=list(a.pages))
    assert b.trim(4) == 1                 # b's tail reference dropped...
    assert [pool.refcount(p) for p in a.pages] == [2, 1]
    assert pool.live == 2 and b.capacity == 4  # ...nothing freed physically
    b.release()
    assert pool.live == 2                 # a still holds both
    a.release()
    assert pool.live == 0


# -- the prefix cache ---------------------------------------------------------

def test_prefix_probe_match_publish_roundtrip():
    pool = _pool(num_pages=8)
    cache = PrefixCache(pool, name="t")
    toks = list(range(10))                # 2 full pages + a 2-token tail
    t = BlockTable(pool)
    t.ensure(10)
    assert cache.publish(toks, t.pages) == 3   # the partial tail too
    assert cache.publish(toks, t.pages) == 0   # cached chunks are skipped
    assert cache.probe(toks) == 2              # full pages only
    pages, covered = cache.match(toks)
    assert pages == t.pages and covered == 10
    assert all(pool.refcount(p) == 3 for p in pages)  # table, cache, match
    assert cache.match(toks[:6]) == (t.pages[:1], 4)  # a partial 2nd chunk
    pool.free(t.pages[:1])
    st = cache.stats()
    assert st["hits"] == 4 and st["hit_requests"] == 2
    assert st["published"] == 3 and st["entries"] == 3
    pool.free(pages)
    t.release()
    assert pool.live == 3                 # the cache alone keeps them warm
    cache.clear()
    assert pool.live == 0


def test_prefix_chain_key_is_history_dependent():
    pool = _pool(num_pages=8)
    cache = PrefixCache(pool, name="t")
    t = BlockTable(pool)
    t.ensure(8)
    cache.publish([1, 2, 3, 4, 5, 6, 7, 8], t.pages)
    assert cache.probe([1, 2, 3, 4, 5, 6, 7, 8]) == 2
    assert cache.probe([9, 9, 9, 9, 5, 6, 7, 8]) == 0


def test_prefix_lru_reclaims_only_unshared_pages():
    pool = _pool(num_pages=4)
    cache = PrefixCache(pool, name="t")
    a = BlockTable(pool)
    a.ensure(8)
    cache.publish([1, 2, 3, 4, 5, 6, 7, 8], a.pages)
    b = BlockTable(pool)
    b.ensure(8)
    cache.publish([9, 10, 11, 12, 13, 14, 15, 16], b.pages)
    a.release()                           # the cache alone pins a's pages
    assert len(pool.alloc(2)) == 2        # a full pool: the hook fires
    assert cache.stats()["evictions"] == 2
    # b's entries survived: its table still shares their pages
    assert cache.probe([9, 10, 11, 12, 13, 14, 15, 16]) == 2
    assert cache.probe([1, 2, 3, 4, 5, 6, 7, 8]) == 0


# -- the prefill writes no pinned page ----------------------------------------

def test_prefill_with_a_match_writes_no_pinned_page(model):
    cfg = model.config
    T = 8
    pool = PagePool(6, T, *model.kv_spec)
    kp, vp = pool.zeros("cpu")
    kp.fill_(7.0)
    vp.fill_(7.0)
    prompt = list(range(1, 21))           # 20 tokens: pages 0, 1, 2
    pages = torch.tensor([0, 1, 2, 6, 6, 6], dtype=torch.int32)
    padded = torch.zeros((32,), dtype=torch.int32)
    padded[:20] = torch.tensor(prompt)
    with torch.no_grad():
        got = ttm.prefill_step(model.params, kp, vp, padded, 20, pages, cfg,
                               covered=16)
        full = ttm.prefill_step(model.params, *pool.zeros("cpu"), padded,
                                20, pages, cfg)
    assert (kp[:, :2] == 7.0).all() and (vp[:, :2] == 7.0).all()
    assert not (kp[:, 2, :4] == 7.0).any()     # positions 16..19 written
    assert (kp[:, 2, 4:] == 7.0).all()         # padding went to the trash
    torch.testing.assert_close(got, full, rtol=0, atol=0)


# -- the engine ---------------------------------------------------------------

BASE = list(range(1, 17))                 # two full pages of 8


def test_sharing_on_and_off_identical_and_counters_equal_jax(jax_model,
                                                            model):
    # the same base, distinct tails, one prompt twice and one that ends
    # inside a page: hits on full pages and on a partial tail, and
    # copy-on-write of the shared tail page
    prompts = [BASE + [17], BASE + [18, 19], BASE + [17], BASE[:12],
               BASE[:12], [5, 6, 7]]
    want = [reference_decode(model, p, 6) for p in prompts]
    with _jax_engine(jax_model, prefix_sharing=True) as jeng:
        jax_tokens, jst = _serve_queued(jeng, prompts, 6)
    assert jax_tokens == want
    for sharing in (False, True):
        with _engine(model, prefix_sharing=sharing) as eng:
            got, st = _serve_queued(eng, prompts, 6)
        assert got == want, sharing
        assert st["prefix_sharing"] == sharing
        assert not st["prefix_degraded"]
        assert st["page_utilization"]["live"] == (
            st["prefix_cache"]["entries"] if sharing else 0)
    for key in ("prefix_hits", "prefix_hit_requests", "prefix_published",
                "cow_copies"):
        assert st[key] == jst[key] and st[key] > 0, key


def test_prefix_sharing_with_speculation(jax_model, model):
    prompts = [BASE + [17], BASE + [18, 19], BASE[:12], BASE[:12]]
    want = [reference_decode(model, p, 8) for p in prompts]
    with _engine(model, prefix_sharing=True, draft_model=model,
                 spec_k=3) as eng:
        got, st = _serve_queued(eng, prompts, 8)
    assert got == want
    assert st["speculative"] and st["acceptance_rate"] == 1.0
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0


def test_pinned_pages_keep_their_bytes_across_a_prefill_in_another_bucket(
        model):
    # the second prompt pads to another bucket (32 against 16), so its
    # projections run on other rows; the pinned pages must stay the
    # bytes the first prefill wrote
    first = BASE[:8] + [20, 21, 22]           # 11 tokens: bucket 16
    second = BASE[:8] + list(range(1, 12))    # 19 tokens: bucket 32
    with _engine(model, prefix_sharing=True) as eng:
        eng.generate(first, max_new_tokens=2, timeout=120)
        page = eng._prefix.match(first[:8])[0][0]
        eng.pool.free([page])
        before = eng._kp[:, page].clone(), eng._vp[:, page].clone()
        res = eng.generate(second, max_new_tokens=4, timeout=120)
        st = eng.stats
        assert torch.equal(eng._kp[:, page], before[0])
        assert torch.equal(eng._vp[:, page], before[1])
    assert st["prefix_hits"] == 1
    assert res.tokens == reference_decode(model, second, 4)


def test_cow_splits_a_shared_tail_page(model):
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]   # 10 tokens, T 8
    want = reference_decode(model, prompt, 6)
    with _engine(model, prefix_sharing=True) as eng:
        first = eng.generate(prompt, max_new_tokens=6, timeout=120)
        second = eng.generate(prompt, max_new_tokens=6, timeout=120)
        st = eng.stats
    assert first.tokens == want and second.tokens == want
    assert st["cow_copies"] == 2          # each writer copies the tail
    assert st["prefix_hits"] == 2         # the full page and the tail


def test_same_prefix_requests_below_their_private_footprint(jax_model,
                                                            model):
    # each request alone needs pages_for(32 + 8) = 5 pages, 4 of them
    # 20; the pool holds 12. Warm the cache once, then queue 4 requests
    # with the same prompt: they share 4 prompt pages, so all four
    # admit together and the pool's peak stays below 20 pages
    prefix = BASE + BASE                  # 32 tokens = 4 full pages
    assert pages_for(32 + 8, 8) * 4 == 20
    want = reference_decode(model, prefix, 8)
    results = {}
    for name, make, m in (("port", _engine, model),
                          ("jax", _jax_engine, jax_model)):
        with make(m, prefix_sharing=True, kv_pages=12, max_running=4) as eng:
            assert eng.generate(prefix, max_new_tokens=8,
                                timeout=300).tokens == want
            got, st = _serve_queued(eng, [prefix] * 4, 8)
        assert got == [want] * 4
        assert st["shed"] == 0 == st["failed"]
        assert st["prefix_hit_requests"] == 4   # all but the warm one
        results[name] = st
    st = results["port"]
    assert st["page_utilization"]["max_live"] <= 12 < 20
    assert st["cow_copies"] == 0          # full pages: no shared write
    for key in ("prefix_hits", "prefix_published", "cow_copies"):
        assert st[key] == results["jax"][key], key


def test_distinct_prompts_past_the_pool_all_complete(model):
    # each prompt reserves pages_for(24 + 4, 8) = 4 of the 8 pages and
    # publishes its 3 full prompt pages, so from the third prompt on the
    # free list alone is short of the reservation while nothing runs:
    # admission itself must reclaim the cache's cold pages
    rng = np.random.RandomState(23)
    prompts = [list(rng.randint(0, VOCAB, 24)) for _ in range(6)]
    with _engine(model, prefix_sharing=True, kv_pages=8) as eng:
        got = [eng.generate(p, max_new_tokens=4, timeout=60).tokens
               for p in prompts]
        st = eng.stats
    assert got == [reference_decode(model, p, 4) for p in prompts]
    assert st["completed"] == 6 and st["prefix_published"] == 18
    # 2 cold pages evicted for the third prompt, 3 for each later one
    assert st["prefix_cache"]["evictions"] == 2 + 3 * 3


def test_preempt_resume_with_a_shared_prefix(model):
    prompts = [[1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 9, 10]]
    with _engine(model, prefix_sharing=True, max_running=2, kv_pages=5,
                 page_tokens=4, reserve="prompt") as eng:
        got, st = _serve_queued(eng, prompts, 8)
    assert got == [reference_decode(model, p, 8) for p in prompts]
    assert st["preemptions"] >= 1 and st["completed"] == 2
    assert st["prefix_hits"] >= 1


def test_armed_prefix_site_at_build_degrades_to_private_pages(model):
    faults.arm("serving.prefix", "raise", nth=1, times=1)
    with _engine(model, prefix_sharing=True) as eng:
        res = eng.generate([1, 2, 3, 4, 5], max_new_tokens=6, timeout=120)
        st = eng.stats
    assert res.tokens == reference_decode(model, [1, 2, 3, 4, 5], 6)
    assert st["prefix_degraded"] and not st["prefix_sharing"]
    evs = events.events(kind="prefix_degraded", site="serving.prefix")
    assert evs and evs[0]["phase"] == "build"


def test_armed_prefix_match_degrades_midstream(model):
    prompt = list(range(1, 9))
    with _engine(model, prefix_sharing=True) as eng:
        eng.generate(prompt, max_new_tokens=4, timeout=120)
        faults.arm("serving.prefix", "raise", nth=1, times=1)
        res = eng.generate(prompt, max_new_tokens=4, timeout=120)
        st = eng.stats
    assert res.tokens == reference_decode(model, prompt, 4)
    assert st["prefix_degraded"] and st["failed"] == 0
    assert events.events(kind="prefix_degraded")[0]["phase"] == "match"
    assert st["page_utilization"]["live"] == 0
