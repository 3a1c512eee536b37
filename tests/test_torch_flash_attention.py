"""Flash attention forward: the port's plain version and wrapper against
the JAX package's ``flash_attention_with_lse`` (the Pallas kernel in
interpret mode).

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 2e-5 absolute on ``o`` and ``lse``, float32 on both sides; the
JAX kernel's online softmax over 128-wide blocks and the port's dense
softmax sum in different orders, which moves results of size ~1 by
~1e-6.

On bfloat16 q, k, v both compute in float32 and round ``o`` once to
bfloat16; ``lse`` is float32, within 1e-6. ``o`` is held within one
bfloat16 ulp as ``test_torch_flash_attention_cuda.bf16_errors`` measures
it, and at most 1 % of its elements may differ at all (about 1e-4 do: 4
of 32768 at B 2, S 128, H 2, D 64, causal).
"""
import math
import os
import re

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.flash_attention import (  # noqa: E402
    flash_attention_with_lse as jax_flash_attention_with_lse)
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from test_torch_flash_attention_cuda import bf16_errors  # noqa: E402

TOL = 2e-5
BF16 = np.dtype(ml_dtypes.bfloat16)
LSE_TOL = 1e-6


def _qkv(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


def _bf16_scores_reference(q, k, v, causal):
    """The plain forward as the port computed it on bfloat16 before its
    plain versions took float32: scores, softmax and p v each rounded to
    bfloat16 (a fault of the port, repaired; pinned here)."""
    B, S, H, D = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          float("-inf"))
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vh)
    return o.permute(0, 2, 1, 3)


BF16_CASES = [(2, 128, 2, 64, True), (1, 130, 3, 32, False),
              (2, 200, 2, 64, True), (1, 37, 2, 32, True),
              (2, 100, 2, 64, False)]


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=["B%d_S%d_H%d_D%d_%s" % (*c[:4], "causal" if c[4]
                                                      else "full")
                              for c in BF16_CASES])
def test_plain_version_on_bfloat16_matches_jax_kernel(case):
    B, S, H, D, causal = case
    q, k, v = [a.astype(BF16) for a in _qkv(B, S, H, D, seed=S + D)]
    o_j, lse_j = jax_flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    qt, kt, vt = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                  for a in (q, k, v))
    o_t, lse_t = tfa.flash_attention_reference(qt, kt, vt, causal=causal,
                                               block=64)
    assert o_t.dtype == torch.bfloat16 and o_j.dtype == BF16
    assert lse_t.dtype == torch.float32 and lse_j.dtype == np.float32
    got = o_t.float().numpy()
    max_ulps, own_ulps, differ = bf16_errors(got, o_j)
    assert max_ulps <= 1 and own_ulps <= 1, (max_ulps, own_ulps)
    assert differ <= 0.01 * got.size, (differ, got.size)
    np.testing.assert_allclose(lse_t.numpy(), lse_j, rtol=0, atol=LSE_TOL)
    # the fault this replaced: scores and softmax in bfloat16 are many
    # ulps of the small outputs off, and differ almost everywhere
    old = _bf16_scores_reference(qt, kt, vt, causal).float().numpy()
    old_max, old_own, old_differ = bf16_errors(old, o_j)
    assert old_own > 10 and old_differ > 0.2 * got.size, (
        old_max, old_own, old_differ)


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


@pytest.mark.parametrize("D,path", [(32, "mma"), (64, "wgmma"),
                                    (128, "mma")])
def test_bf16_forward_path_mirror(D, path):
    """The bfloat16 forward's wgmma kernel takes D 64 only; D 32 and 128
    keep the mma.sync kernel. The mirror's shared memory follows."""
    assert tfa.fwd_bf16_path(D) == path
    mma = 4 * 32 * (D + 8) * 2
    assert tfa.fwd_bf16_smem_bytes(D, "mma") == mma
    want = (128 * 64 + 4 * 2 * 128 * 64) * 2 + 1024 if path == "wgmma" \
        else mma
    assert tfa.fwd_bf16_smem_bytes(D) == want
    with pytest.raises(ValueError, match="head_dim"):
        tfa.fwd_bf16_path(D + 1)
    if path == "mma":
        with pytest.raises(ValueError, match="D 64 only"):
            tfa.fwd_bf16_smem_bytes(D, "wgmma")


def test_bf16_wgmma_mirror_matches_the_source():
    """The wgmma kernel's rows a block, keys a tile, ring, head dim and
    shared memory in csrc/flash_attention_fwd.cu are those the mirror
    computes with; the path rule picks it by D; the mma.sync kernel's
    tile is as it was."""
    path = os.path.join(os.path.dirname(tfa.__file__), "csrc",
                        "flash_attention_fwd.cu")
    with open(path) as fh:
        src = fh.read()

    def ints(name):
        m = re.search(r"constexpr int %s = (\d+);" % name, src)
        return int(m.group(1))

    assert (ints("BM_W"), ints("BN_W"), ints("RING_W"), ints("DW")) == \
        (tfa._BM_W, tfa._BN_W, tfa._RING_W, tfa._DW) == (128, 128, 4, 64)
    assert ints("BN") == tfa._BN_MMA == 32
    assert ints("THREADS_W") == 384
    assert "Q_TILE_W = BM_W * DW" in src and "KV_TILE_W = BN_W * DW" in src
    assert "STAGE_BYTES_W = 2 * KV_TILE_W * (int)sizeof(bf16)" in src
    assert "Q_TILE_W * (int)sizeof(bf16) + RING_W * STAGE_BYTES_W + 1024" \
        in src
    assert "bool wgmma_path(int D) { return D == DW; }" in src
    assert "return 4 * BN * (D + 8) * (int)sizeof(bf16);" in src
    # the turns of the two consumer warpgroups and the register-A p v
    assert "bar_sync(mine, 256);" in src
    assert "wgmma_m64n64k16_rs(pv, ph[j], vd, j > 0);" in src
    assert "wgmma_bf16<BN_W, 0>(s," in src


def test_bf16_mma_counter_is_a_kernel_counter():
    assert kernels.KERNEL_COUNTERS["flash_attention_fwd_bf16_mma"] == (
        tfa, "launches_bf16_mma")
    tfa.launches_bf16_mma = 3
    assert kernels.launch_counts()["flash_attention_fwd_bf16_mma"] == 3
    kernels.reset_launches()
    assert tfa.launches_bf16_mma == 0


@pytest.mark.parametrize("D", [32, 64, 128])
def test_bf16_on_cpu_counts_no_launch_on_either_path(D):
    q, k, v = [torch.from_numpy(a).bfloat16()
               for a in _qkv(1, 9, 2, D, seed=D)]
    before = kernels.launch_counts()
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    assert kernels.launch_counts() == before
    o_r, lse_r = tfa.flash_attention_reference(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16 and torch.equal(o, o_r)
    assert torch.equal(lse, lse_r)
