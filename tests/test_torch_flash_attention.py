"""Flash attention forward: the port's plain version and wrapper against
the JAX package's ``flash_attention_with_lse`` (the Pallas kernel in
interpret mode).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 2e-5 absolute on ``o`` and ``lse``, float32 on both sides; the
JAX kernel's online softmax over 128-wide blocks and the port's dense
softmax sum in different orders, which moves results of size ~1 by
~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.flash_attention import (  # noqa: E402
    flash_attention_with_lse as jax_flash_attention_with_lse)
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest -m cuda tests/test_torch_*.py")
    return torch.device("cuda", 0)


def _qkv(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [5, 37, 128, 200])
def test_plain_version_matches_jax_kernel(S, causal):
    q, k, v = _qkv(2, S, 2, 16, seed=S + 7 * causal)
    o_j, lse_j = jax_flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o_t, lse_t = tfa.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block=64)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=0,
                               atol=TOL)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    q, k, v = [torch.from_numpy(a) for a in _qkv(1, 9, 2, 8, seed=1)]
    before = tfa.launches
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    assert tfa.launches == before
    o_r, lse_r = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, o_r, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_r, rtol=0, atol=0)
    torch.testing.assert_close(tfa.flash_attention(q, k, v, causal=True),
                               o_r, rtol=0, atol=0)


def test_causal_needs_aligned_lengths():
    q = torch.zeros(1, 4, 1, 8)
    k = torch.zeros(1, 5, 1, 8)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_reference(q, k, k, causal=True)


def test_wrapper_refuses_grad():
    """The flash wrapper has its backward now: a tensor that requires
    grad gets a differentiable output. Paged attention still has none
    and refuses."""
    from paddle_tpu_torch.kernels import paged_attention as tpa
    q, k, v = [torch.from_numpy(a) for a in _qkv(1, 4, 1, 8, seed=2)]
    k.requires_grad_(True)
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    assert o.requires_grad and lse.requires_grad
    pool = torch.zeros(2, 4, 1, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        tpa.paged_attention(q[:, 0], pool, pool,
                            torch.zeros(1, 1, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 64, 300])
def test_kernel_matches_plain_version_on_the_card(cuda_device, S):
    for causal in (True, False):
        q, k, v = [torch.from_numpy(a).to(cuda_device)
                   for a in _qkv(2, S, 3, 64, seed=S)]
        before = tfa.launches
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert tfa.launches == before + 1
        o_r, lse_r = tfa.flash_attention_reference(q, k, v, causal=causal)
        assert float((o - o_r).abs().max()) <= TOL
        assert float((lse - lse_r).abs().max()) <= TOL
