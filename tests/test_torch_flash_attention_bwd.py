"""Flash attention backward: the port's plain backward and its
``torch.autograd.Function`` wrapper against ``jax.grad`` of the JAX
package's ``flash_attention_with_lse`` (the Pallas dK/dV and dQ kernels
in interpret mode).

Inputs and the cotangents on both ``o`` and ``lse`` are made with numpy
from a seed and handed to both packages. Tolerance: 5e-5 absolute on
dq, dk and dv (values of size ~1), float32 on both sides; the JAX
kernels recompute the probabilities over 128-wide blocks and the port's
plain version over dense rows, which sums in other orders and moves
results by ~1e-6.

On bfloat16 q, k, v and dO (pure AMP) both packages compute in float32
and round dq, dk and dv once to bfloat16; ``lse``, its cotangent and
``delta`` are float32. Each gradient is held within one bfloat16 ulp as
``test_torch_flash_attention_cuda.bf16_errors`` measures it: every element
within one ulp of its own magnitude plus SUM_TOL of the largest, the
largest error within one ulp of the largest magnitude.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.flash_attention import (  # noqa: E402
    flash_attention_with_lse as jax_flash_attention_with_lse)
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from test_torch_flash_attention_cuda import bf16_errors  # noqa: E402

TOL = 5e-5
BF16 = np.dtype(ml_dtypes.bfloat16)


def _inputs(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = [rng.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4)]
    dlse = rng.randn(B, H, S).astype(np.float32)
    return q, k, v, do, dlse


def _jax_grads(q, k, v, do, dlse, causal):
    def loss(q, k, v):
        o, lse = jax_flash_attention_with_lse(q, k, v, causal=causal)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("S", [17, 100, 130])
def test_backward_matches_jax_grad(S, D, causal):
    q, k, v, do, dlse = _inputs(1, S, 2, D, seed=S + D + causal)
    want = _jax_grads(q, k, v, do, dlse, causal)
    qt, kt, vt, dot, dlt = [torch.from_numpy(a) for a in (q, k, v, do, dlse)]
    o, lse = tfa.flash_attention_reference(qt, kt, vt, causal=causal)
    plain = tfa.flash_attention_bwd_reference(qt, kt, vt, o, lse, dot, dlt,
                                              causal=causal, block=64)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    o2, lse2 = tfa.flash_attention_with_lse(*leaves, causal=causal)
    auto = torch.autograd.grad([o2, lse2], leaves, [dot, dlt])
    for got in (plain, auto):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)


def test_backward_without_lse_cotangent_matches_output_only_grad():
    q, k, v, do, _ = _inputs(2, 40, 2, 32, seed=3)

    def loss(q, k, v):
        o, _ = jax_flash_attention_with_lse(q, k, v, causal=True)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL)


def test_cpu_backward_counts_no_launch():
    kernels.reset_launches()
    q, k, v, do, dlse = [torch.from_numpy(a)
                         for a in _inputs(1, 9, 1, 32, seed=4)]
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    o, lse = tfa.flash_attention_with_lse(*leaves, causal=True)
    torch.autograd.grad([o, lse], leaves, [do, dlse])
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(17, 32), (130, 64), (100, 32)])
def test_backward_on_bfloat16_matches_jax_vjp(S, D, causal):
    """The plain backward on bfloat16 operands against ``jax.vjp`` of the
    JAX function, with cotangents on both o (bfloat16) and lse (float32):
    dq, dk and dv bfloat16, each within one ulp. The port's backward is
    fed the JAX forward's o and lse, the residuals its vjp keeps; the
    autograd wrapper, on its own forward, takes the same plain
    backward."""
    q, k, v, do, dlse = _inputs(2, S, 2, D, seed=S + D + causal)
    q, k, v, do = (a.astype(BF16) for a in (q, k, v, do))
    (o_j, lse_j), vjp = jax.vjp(
        lambda q, k, v: jax_flash_attention_with_lse(q, k, v, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(dlse)))]
    assert all(w.dtype == BF16 for w in want)
    qt, kt, vt, dot, o_t = (torch.from_numpy(np.asarray(a, np.float32))
                            .bfloat16() for a in (q, k, v, do, o_j))
    lse_t, dlt = torch.from_numpy(np.array(lse_j)), torch.from_numpy(dlse)
    plain = tfa.flash_attention_bwd_reference(qt, kt, vt, o_t, lse_t, dot,
                                              dlt, causal=causal, block=64)
    for name, g, w in zip(("dq", "dk", "dv"), plain, want):
        assert g.dtype == torch.bfloat16, name
        max_ulps, own_ulps, _ = bf16_errors(g.float().numpy(), w)
        assert max_ulps <= 1 and own_ulps <= 1, (name, max_ulps, own_ulps)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    o2, lse2 = tfa.flash_attention_with_lse(*leaves, causal=causal)
    auto = torch.autograd.grad([o2, lse2], leaves, [dot, dlt])
    again = tfa.flash_attention_bwd_reference(qt, kt, vt, o2.detach(),
                                              lse2.detach(), dot, dlt,
                                              causal=causal)
    for a, b in zip(auto, again):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
