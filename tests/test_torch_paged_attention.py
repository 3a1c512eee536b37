"""Paged attention: the port's plain version and wrapper against the JAX
package's Pallas kernel (interpret mode) and its gather reference.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: 2e-5 absolute, float32 on both sides; the two compute the
same softmax with different summation orders (online per page in the
Pallas kernel, dense in the references), which moves float32 results of
size ~1 by ~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
    paged_attention_reference as jax_paged_attention_reference)
from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest -m cuda tests/test_torch_*.py")
    return torch.device("cuda", 0)


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


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card(cuda_device):
    # engine-shaped: mixed positions including 0, T-1, T and the last
    # column, and an all-trash row
    R, pages, MB, T, nh, dh = 8, 40, 8, 16, 4, 64
    q, kp, vp, tables, positions = _operands(R, pages, MB, T, nh, dh, 21)
    positions[2:6] = [T - 1, T, MB * T - 1, 37]
    ops = [torch.from_numpy(a).to(cuda_device)
           for a in (q, kp, vp, tables, positions)]
    before = tpa.launches
    got = tpa.paged_attention(*ops)
    torch.cuda.synchronize()
    assert tpa.launches == before + 1
    want = tpa.paged_attention_reference(*ops)
    assert float((got - want).abs().max()) <= TOL
