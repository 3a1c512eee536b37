"""Paged attention on the card: the CUDA kernel against its plain
version, at an engine-shaped batch (positions 0, T - 1, T and the last
column, and a row parked on the trash page).

JAX-free, so that it runs where the card is. Tolerance: 2e-5 absolute,
float32 on both sides; the kernel's online softmax per page and the
plain version's dense one sum in other orders, which moves results of
size ~1 by ~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.kernels import paged_attention as tpa  # noqa: E402

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


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
