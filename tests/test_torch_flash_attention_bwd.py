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

The bfloat16 backward's path rule (the wgmma kernels at D 64, the
mma.sync kernels at D 32 and 128) and its shared memory are mirrored in
Python; the mirror's constants are read back from the CUDA source here,
where the kernels cannot run.
"""
import os
import re

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


@pytest.mark.parametrize("D,path", [(32, "mma"), (64, "wgmma"),
                                    (128, "mma")])
def test_bf16_backward_path_mirror(D, path):
    """The bfloat16 backward's wgmma kernels take D 64 only; D 32 and 128
    keep the mma.sync kernels. The mirror's shared memory follows: the
    wgmma dK/dV block holds K and V (128 rows each), 4 stages of a q and
    a dO tile of 32 rows and their lse and delta; the dQ block q and dO
    (128 rows each) and 4 stages of a K and a V tile of 64 rows."""
    assert tfa.bwd_bf16_path(D) == path
    mma = {"dkv": (2 * 64 + 4 * 32) * (D + 8) * 2 + 4 * 32 * 4,
           "dq": (2 * 64 + 4 * 32) * (D + 8) * 2}
    wgmma = {"dkv": 2 * 128 * 64 * 2 + 4 * (2 * 32 * 64 * 2 + 2 * 64 * 4)
             + 1024,
             "dq": 2 * 128 * 64 * 2 + 4 * 2 * 64 * 64 * 2 + 1024}
    for which in ("dkv", "dq"):
        assert tfa.bwd_bf16_smem_bytes(D, which, "mma") == mma[which]
        want = wgmma[which] if path == "wgmma" else mma[which]
        assert tfa.bwd_bf16_smem_bytes(D, which) == want
        if path == "mma":
            with pytest.raises(ValueError, match="D 64 only"):
                tfa.bwd_bf16_smem_bytes(D, which, "wgmma")
    with pytest.raises(ValueError, match="head_dim"):
        tfa.bwd_bf16_path(D + 1)
    with pytest.raises(ValueError, match="'dkv' or 'dq'"):
        tfa.bwd_bf16_smem_bytes(D, "dk")


def test_bf16_bwd_wgmma_mirror_matches_the_source():
    """The wgmma kernels' blocks, tiles, ring, threads, head dim and shared
    memory in csrc/flash_attention_bwd.cu are those the mirror computes
    with; the path rule picks them by D; the mma.sync kernels' tiles are
    as they were; the products and sums are those of the design."""
    path = os.path.join(os.path.dirname(tfa.__file__), "csrc",
                        "flash_attention_bwd.cu")
    with open(path) as fh:
        src = fh.read()

    def ints(name):
        m = re.search(r"constexpr int %s = (\d+);" % name, src)
        return int(m.group(1))

    assert (ints("BK_W"), ints("BQ_W"), ints("BM_W"), ints("BN_W"),
            ints("RING_W"), ints("DW")) == \
        (tfa._BK_BWD_W, tfa._BQ_BWD_W, tfa._BM_BWD_W, tfa._BN_BWD_W,
         tfa._RING_BWD_W, tfa._DW) == (128, 32, 128, 64, 4, 64)
    assert ints("THREADS_W") == 384
    assert (ints("BN"), 16 * ints("WARPS")) == \
        (tfa._BN_BWD_MMA, tfa._BR_BWD_MMA) == (32, 64)
    assert "QT_W = BQ_W * DW" in src and "KT_W = BN_W * DW" in src
    flat = " ".join(src.split())
    assert "LBOX_W = BQ_W + 4;" in flat and "LPAD_W = BQ_W + 32;" in flat
    assert "2 * QT_W * (int)sizeof(bf16) + 2 * LBOX_W * (int)sizeof(float)" \
        in flat
    assert "DKV_SMEM_BYTES_W = 2 * BK_W * DW * (int)sizeof(bf16) + RING_W * " \
        "2 * QT_W * (int)sizeof(bf16) + RING_W * 2 * LPAD_W * " \
        "(int)sizeof(float) + 1024;" in flat
    assert "DQ_STAGE_BYTES_W = 2 * KT_W * (int)sizeof(bf16)" in src
    assert "2 * BM_W * DW * (int)sizeof(bf16) + RING_W * DQ_STAGE_BYTES_W " \
        "+ 1024" in src
    assert "bool wgmma_path(int D) { return D == DW; }" in src
    assert "return (2 * BR + 4 * BN) * (D + 8) * (int)sizeof(bf16) +\n" \
        "         4 * BN * (int)sizeof(float);" in src
    assert "return (2 * BR + 4 * BN) * (D + 8) * (int)sizeof(bf16);" in src
    # the turns of the two consumer warpgroups, s^T and s K-major, the
    # register-A products on the MN-major tiles
    assert src.count("bar_sync(mine, 256);") == 5
    assert "wgmma_bf16<BQ_W, 0>(st, desc_sw128(ka + 32 * kk" in src
    assert "wgmma_bf16<BN_W, 0>(sc, desc_sw128(qa + 32 * kk" in src
    # dk, dv and dq summed in the wgmma accumulator over the walk, a
    # turn's products one group (the source's measured decision)
    assert "wgmma_m64n64k16_rs(d, hi[j], yd, true);" in src
    assert "wgmma_m64n64k16_rs(dqa, dsh[j], kd, true);" in src
    assert src.count("wgmma_commit();") == 6
    # no atomics on either path
    assert "atomicAdd" not in src and "red.global" not in src


def test_bf16_bwd_mma_counters_are_kernel_counters():
    for which in ("dkv", "dq"):
        name = "flash_attention_bwd_%s_bf16_mma" % which
        attr = "launches_bwd_%s_bf16_mma" % which
        assert kernels.KERNEL_COUNTERS[name] == (tfa, attr)
        setattr(tfa, attr, 3)
        assert kernels.launch_counts()[name] == 3
        kernels.reset_launches()
        assert getattr(tfa, attr) == 0


@pytest.mark.parametrize("D", [32, 64, 128])
def test_bf16_backward_on_cpu_counts_no_launch_on_either_path(D):
    """On CPU tensors the bfloat16 backward is the plain version on both
    paths' head dims, and no counter moves."""
    q, k, v, do, dlse = [torch.from_numpy(a)
                         for a in _inputs(1, 9, 2, D, seed=D)]
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    before = kernels.launch_counts()
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse, causal=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o2, lse2 = tfa.flash_attention_with_lse(*leaves, causal=True)
    auto = torch.autograd.grad([o2, lse2], leaves, [do, dlse])
    assert kernels.launch_counts() == before
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                             causal=True)
    for g, a, w in zip(got, auto, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w) and torch.equal(a, w)
