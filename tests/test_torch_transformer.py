"""The transformer LM's serving face: the port against the JAX package.

One config (vocab 61, hidden 32, 2 layers, 4 heads, max_seq 64), the JAX
package's ``init_params`` carried into the port by
``TransformerLM.from_numpy``, and token inputs made with numpy from a
seed. The JAX side runs its plain paths (dense causal attention, the
block-table gather), as its own tests run them on the CPU.

Tolerance: 1e-5 absolute on logits and cached K/V, float32 on both
sides; the two frameworks' matmuls and softmaxes sum in different
orders, which moves values of size ~1 by ~1e-6 through two layers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.models import transformer as jtm  # noqa: E402
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402

TOL = 1e-5
VOCAB, MAX_SEQ, T = 61, 64, 8


@pytest.fixture(scope="module")
def pair():
    cfg_j = jtm.TransformerConfig(vocab_size=VOCAB, hidden=32, num_layers=2,
                                  num_heads=4, max_seq=MAX_SEQ)
    params = jtm.init_params(cfg_j, seed=5)
    cfg_t = ttm.TransformerConfig.from_dict(cfg_j.to_dict())
    model = ttm.TransformerLM.from_numpy(params, cfg_t, device="cpu")
    return cfg_j, params, model


def _pools(cfg, pages):
    shape = (cfg.num_layers, pages + 1, T, cfg.num_heads, cfg.head_dim)
    return np.zeros(shape, np.float32), np.zeros(shape, np.float32)


def test_init_params_are_the_jax_packages_bytes():
    cfg_j = jtm.TransformerConfig(vocab_size=VOCAB, hidden=32, num_layers=2,
                                  num_heads=4, max_seq=MAX_SEQ)
    cfg_t = ttm.TransformerConfig(vocab_size=VOCAB, hidden=32, num_layers=2,
                                  num_heads=4, max_seq=MAX_SEQ)
    pj, pt = jtm.init_params(cfg_j, seed=9), ttm.init_params(cfg_t, seed=9)
    assert ttm.param_names(cfg_t) == jtm.param_names(cfg_j)
    assert sorted(pj) == sorted(pt)
    for n in pj:
        assert pj[n].dtype == pt[n].dtype and np.array_equal(pj[n], pt[n])


def test_forward_matches_jax(pair):
    cfg_j, params, model = pair
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, VOCAB, (2, 23)).astype(np.int32)
    want = np.asarray(jtm.forward(params, jnp.asarray(tokens), cfg_j))
    got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # _forward_kv's K/V are the per-layer projections the pool caches
    _, kj, vj = jtm._forward_kv(params, jnp.asarray(tokens), cfg_j)
    _, kt, vt = ttm._forward_kv(model.params, torch.from_numpy(tokens),
                                model.config)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=TOL)


def _prefill_both(pair, prompt, S_b, pages_row):
    cfg_j, params, model = pair
    kp, vp = _pools(cfg_j, 8)
    padded = np.zeros((S_b,), np.int32)
    padded[:len(prompt)] = prompt
    last_j, kp_j, vp_j = jtm.prefill_step(
        params, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(padded),
        np.int32(len(prompt)), jnp.asarray(pages_row), cfg_j)
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    last_t = ttm.prefill_step(model.params, kp_t, vp_t,
                              torch.from_numpy(padded), len(prompt),
                              torch.from_numpy(pages_row), model.config)
    return (np.asarray(last_j), np.asarray(kp_j), np.asarray(vp_j)), \
        (last_t.numpy(), kp_t.numpy(), vp_t.numpy())


def test_prefill_step_matches_jax_logits_and_pool(pair):
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, VOCAB, 13).astype(np.int32)
    pages_row = np.array([5, 2, 7, 8, 8, 8, 8, 8], np.int32)  # 8 = trash
    (lj, kj, vj), (lt, kt, vt) = _prefill_both(pair, prompt, 16, pages_row)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=TOL)
    # live pages hold the prompt's K/V; the trash page holds garbage
    for page in (5, 2):
        np.testing.assert_allclose(kt[:, page], kj[:, page], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(vt[:, page], vj[:, page], rtol=0,
                                   atol=TOL)
    untouched = [p for p in range(8) if p not in (5, 2)]
    assert not kt[:, untouched].any() and not vt[:, untouched].any()


def test_decode_steps_at_mixed_positions_match_jax(pair):
    # three live rows at different positions plus an inactive row parked
    # on the trash page; four steps, each compared with the JAX step
    cfg_j, params, model = pair
    rng = np.random.RandomState(2)
    R, MB, pages = 4, MAX_SEQ // T, 30
    kp, vp = _pools(cfg_j, pages)
    tables = np.full((R, MB), pages, np.int32)
    tables[0, :3] = [0, 1, 2]
    tables[1, :3] = [3, 4, 10]
    tables[2, :4] = [5, 6, 7, 9]
    lengths = [5, 15, 24]
    kp_j, vp_j = jnp.asarray(kp), jnp.asarray(vp)
    kp_t, vp_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    for row, n in enumerate(lengths):
        prompt = rng.randint(0, VOCAB, n).astype(np.int32)
        padded = np.zeros((32,), np.int32)
        padded[:n] = prompt
        _, kp_j, vp_j = jtm.prefill_step(
            params, kp_j, vp_j, jnp.asarray(padded), np.int32(n),
            jnp.asarray(tables[row]), cfg_j)
        ttm.prefill_step(model.params, kp_t, vp_t, torch.from_numpy(padded),
                         n, torch.from_numpy(tables[row]), model.config)
    positions = np.array(lengths + [0], np.int32)
    active = np.array([True, True, True, False])
    for step in range(4):
        tokens = rng.randint(0, VOCAB, R).astype(np.int32)
        lj, kp_j, vp_j = jtm.decode_step(
            params, kp_j, vp_j, jnp.asarray(tables), jnp.asarray(positions),
            jnp.asarray(tokens), jnp.asarray(active), cfg_j)
        lt = ttm.decode_step(model.params, kp_t, vp_t,
                             torch.from_numpy(tables),
                             torch.from_numpy(positions),
                             torch.from_numpy(tokens),
                             torch.from_numpy(active), model.config)
        np.testing.assert_allclose(lt.numpy()[:3], np.asarray(lj)[:3],
                                   rtol=0, atol=TOL)
        live = sorted(set(tables[:3].ravel()) - {pages})
        np.testing.assert_allclose(kp_t.numpy()[:, live],
                                   np.asarray(kp_j)[:, live], rtol=0,
                                   atol=TOL)
        positions[:3] += 1


def test_greedy_device_sample_and_logprobs_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(5, VOCAB).astype(np.float32) * 3
    temps = np.zeros((5,), np.float32)
    seeds = np.arange(5, dtype=np.int32)
    ctr = np.arange(5, dtype=np.int32) + 10
    tj, lj = jtm.device_sample(jnp.asarray(logits), jnp.asarray(temps),
                               jnp.asarray(seeds), jnp.asarray(ctr))
    tt_, lt = ttm.device_sample(*[torch.from_numpy(a) for a in
                                  (logits, temps, seeds, ctr)])
    assert tt_.dtype == torch.int32
    assert tt_.tolist() == np.asarray(tj).tolist()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=TOL)


def test_tempered_draw_is_a_pure_function_of_seed_and_position():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(3, VOCAB).astype(np.float32))
    temps = torch.full((3,), 0.8)
    seeds = torch.tensor([7, 7, 8], dtype=torch.int32)
    ctr = torch.tensor([12, 12, 12], dtype=torch.int32)
    a, _ = ttm.device_sample(logits[[0, 0, 0]], temps, seeds, ctr)
    b, _ = ttm.device_sample(logits[[0, 0, 0]], temps, seeds, ctr)
    assert a.tolist() == b.tolist()
    # the noise is keyed by (seed, position, vocab id) and nothing else
    n1 = ttm.gumbel_noise(seeds, ctr, VOCAB)
    assert torch.equal(n1[0], n1[1]) and not torch.equal(n1[0], n1[2])
    n2 = ttm.gumbel_noise(seeds, ctr + 1, VOCAB)
    assert not torch.equal(n1[0], n2[0])


def test_tempered_draw_follows_the_softmax_distribution():
    # in distribution the port samples what the JAX package samples:
    # softmax(logits / t); 4000 positions of one row, chi-square-sized
    # bound on the largest frequency error
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    n = 4000
    toks, _ = ttm.device_sample(
        logits.expand(n, 4), torch.full((n,), 0.7),
        torch.full((n,), 3, dtype=torch.int32),
        torch.arange(n, dtype=torch.int32))
    freq = np.bincount(toks.numpy(), minlength=4) / n
    want = torch.softmax(logits[0] / 0.7, dim=0).numpy()
    assert np.abs(freq - want).max() < 0.03


def test_from_numpy_checks_names_and_default_device_needs_a_card(pair):
    cfg_j, params, _ = pair
    partial = dict(params)
    del partial["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        ttm.TransformerLM.from_numpy(partial, cfg_j.to_dict(), device="cpu")
    if not torch.cuda.is_available():
        from paddle_tpu_torch.device import NoDeviceError
        with pytest.raises(NoDeviceError):
            ttm.TransformerLM.from_numpy(params, cfg_j.to_dict())
