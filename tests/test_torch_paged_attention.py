"""Paged attention: the port's plain version and wrapper against the JAX
package's Pallas kernel (interpret mode) and its gather reference; the
CUDA kernel's split count and, emulated in float32 torch, its split
partials and fixed-order merge against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 2e-5 absolute, float32 on both sides; the two compute the
same softmax with different summation orders (online per page in the
Pallas kernel, dense in the references, by split then merged in the
emulation), which moves float32 results of size ~1 by ~1e-6.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_attention_reference)
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402

TOL = 2e-5


# the JAX parity grid of tests/test_kernels_parity.py:
# (R, pages, MB, T, nh, dh, block_r, block_kv)
PAGED_GRID = [
    (4, 6, 3, 8, 2, 16, 1, 1),
    (4, 6, 3, 8, 2, 16, 2, 1),
    (8, 10, 4, 4, 2, 8, 4, 2),
    (8, 12, 6, 8, 4, 8, 2, 3),
    (2, 4, 2, 16, 1, 32, 2, 2),
]


def _operands(R, pages, MB, T, nh, dh, seed):
    """numpy operands with row 0 parked on the trash page (position 0)
    and row 1 at position 0 over live pages."""
    rng = np.random.RandomState(seed)
    q = rng.randn(R, nh, dh).astype(np.float32)
    kp = rng.randn(pages + 1, T, nh, dh).astype(np.float32)
    vp = rng.randn(pages + 1, T, nh, dh).astype(np.float32)
    tables = rng.randint(0, pages, (R, MB)).astype(np.int32)
    positions = rng.randint(0, MB * T, (R,)).astype(np.int32)
    tables[0] = pages
    positions[0] = 0
    positions[1] = 0
    return q, kp, vp, tables, positions


@pytest.mark.parametrize("shape", PAGED_GRID)
def test_plain_version_matches_jax_kernel_and_reference(shape):
    R, pages, MB, T, nh, dh, br, bkv = shape
    ops = _operands(R, pages, MB, T, nh, dh, seed=R * 1000 + MB * 10 + dh)
    want_kernel = np.asarray(jax_paged_attention(
        *[jnp.asarray(a) for a in ops],
        config={"block_r": br, "block_kv": bkv}))
    want_ref = np.asarray(jax_paged_attention_reference(
        *[jnp.asarray(a) for a in ops]))
    got = tpa.paged_attention_reference(
        *[torch.from_numpy(a) for a in ops]).numpy()
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=TOL)


def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    ops = [torch.from_numpy(a) for a in _operands(4, 6, 3, 8, 2, 16, 3)]
    before = tpa.launches
    got = tpa.paged_attention(*ops)
    assert tpa.launches == before
    torch.testing.assert_close(got, tpa.paged_attention_reference(*ops),
                               rtol=0, atol=0)


def test_position_past_the_table_attends_every_column():
    # the kernel clamps such a row to the whole table; the plain version
    # masks nothing: both equal attention over all MB * T columns
    q, kp, vp, tables, positions = _operands(2, 5, 2, 4, 2, 8, 9)
    positions[:] = 2 * 4 + 5
    got = tpa.paged_attention_reference(
        *[torch.from_numpy(a) for a in (q, kp, vp, tables, positions)])
    full = positions.copy()
    full[:] = 2 * 4 - 1
    want = tpa.paged_attention_reference(
        *[torch.from_numpy(a) for a in (q, kp, vp, tables, full)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_refuses_grad():
    q, kp, vp, tables, positions = [
        torch.from_numpy(a) for a in _operands(4, 6, 3, 8, 2, 16, 4)]
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        tpa.paged_attention(q, kp, vp, tables, positions)


@pytest.mark.parametrize("MB,T", [(1, 1), (3, 16), (4, 16), (64, 16),
                                  (6, 24), (20, 24), (5, 13), (128, 8)])
def test_splits_is_the_columns_over_64_rounded_up(MB, T):
    assert tpa.splits(MB, T) == int(np.ceil(MB * T / 64)) == \
        -(-MB * T // tpa.SPLIT)


def test_mirror_matches_the_source():
    """The split length of csrc/paged_attention.cu is the mirror's."""
    path = os.path.join(os.path.dirname(tpa.__file__), "csrc",
                        "paged_attention.cu")
    with open(path) as fh:
        src = fh.read()
    m = re.search(r"constexpr int SPLIT = (\d+);", src)
    assert m is not None and int(m.group(1)) == tpa.SPLIT == 64


def _split_merge(q, kp, vp, tables, positions):
    """The kernel's arithmetic in float32 torch: each split of SPLIT
    columns writes its unnormalised partial (acc, m, den) to a workspace
    that starts as NaN; the merge reads the live splits in order. A
    split past the row's position is never written and never read."""
    R, nh, dh = q.shape
    T, MB = kp.shape[1], tables.shape[1]
    S = tpa.splits(MB, T)
    work = torch.full((R, nh, S, dh + 2), float("nan"))
    out = torch.empty_like(q)
    for r in range(R):
        n_cols = min(int(positions[r]), MB * T - 1) + 1
        cols = torch.arange(n_cols)
        kc = kp[tables[r, cols // T].long(), cols % T]    # [n, nh, dh]
        vc = vp[tables[r, cols // T].long(), cols % T]
        for s in range(S):
            c0, c1 = s * tpa.SPLIT, min((s + 1) * tpa.SPLIT, n_cols)
            if c0 >= n_cols:
                continue
            sc = torch.einsum("hd,chd->hc", q[r], kc[c0:c1]) * dh ** -0.5
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            work[r, :, s, :dh] = torch.einsum("hc,chd->hd", p, vc[c0:c1])
            work[r, :, s, dh] = m
            work[r, :, s, dh + 1] = p.sum(-1)
        live = -(-n_cols // tpa.SPLIT)
        big = work[r, :, :live, dh].max(-1).values
        den = torch.zeros(nh)
        acc = torch.zeros(nh, dh)
        for s in range(live):
            sc = torch.exp(work[r, :, s, dh] - big)
            den = den + work[r, :, s, dh + 1] * sc
            acc = acc + work[r, :, s, :dh] * sc[:, None]
        out[r] = acc / den.clamp_min(1e-20)[:, None]
    return out, S


# (R, pages, MB, T, nh, dh): shapes with more than one split
SPLIT_GRID = [
    (6, 40, 16, 16, 2, 32),   # S 4, splits of 4 whole pages
    (6, 20, 6, 24, 2, 64),    # S 3, splits that cut pages (T 24)
    (4, 12, 5, 13, 3, 32),    # S 2, an odd T
]


@pytest.mark.parametrize("shape", SPLIT_GRID)
def test_split_merge_matches_the_jax_reference(shape):
    R, pages, MB, T, nh, dh = shape
    q, kp, vp, tables, positions = _operands(R, pages, MB, T, nh, dh,
                                             seed=R * 100 + T)
    # row 0 inactive (trash page, position 0), row 1 at position 0, then
    # the last column of the first split, the first of the second, the
    # last column and a position past the table
    positions[2:] = [63, 64, MB * T - 1, MB * T + 40][:R - 2]
    want = np.asarray(jax_paged_attention_reference(
        *[jnp.asarray(a) for a in (q, kp, vp, tables, positions)]))
    ops = [torch.from_numpy(a) for a in (q, kp, vp, tables, positions)]
    got, S = _split_merge(*ops)
    assert S > 1
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(
        got.numpy(), tpa.paged_attention_reference(*ops).numpy(), rtol=0,
        atol=TOL)
