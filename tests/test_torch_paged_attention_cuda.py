"""Paged attention on the card: the CUDA kernel (a split pass over 64
columns of a row at a time, then a merge of the splits in order) against
its plain version, at an engine-shaped batch (positions 0, T - 1, T and
the last column, and a row parked on the trash page), at every head dim,
where splits cut pages (T 24), at one split (MB * T < 64), one row at
its last column, positions past the table and an all-trash batch; each
launched twice, the second launch bit-identical to the first. Also the
library's split count against the mirror, and the refusal of an
operand the kernel's 16-byte loads cannot read.

JAX-free, so that it runs where the card is. Tolerance: 2e-5 absolute,
float32 on both sides; the kernel's online softmax by split and the
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
    if R > 1:
        positions[1] = 0
    return q, kp, vp, tables, positions


def _twice_against_plain(ops):
    """Launch the kernel twice; the second result must equal the first
    bit for bit, and both the plain version within TOL."""
    before = tpa.launches
    got = tpa.paged_attention(*ops)
    again = tpa.paged_attention(*ops)
    torch.cuda.synchronize()
    assert tpa.launches == before + 2
    assert torch.equal(got, again)
    want = tpa.paged_attention_reference(*ops)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


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


# (R, pages, MB, T, nh, dh, positions of rows 2.. or None)
EDGE_CASES = {
    "dh32": (8, 40, 8, 16, 4, 32, [15, 16, 127, 63, 64, 65]),
    "dh64": (8, 40, 8, 16, 4, 64, [15, 16, 127, 63, 64, 65]),
    "dh128": (8, 40, 8, 16, 4, 128, [15, 16, 127, 63, 64, 65]),
    # S 4 over 240 columns: splits end inside pages
    "T24": (6, 30, 10, 24, 4, 64, [23, 24, 239, 71]),
    # MB * T 48: one split a row
    "one_split": (6, 12, 3, 16, 4, 64, [15, 16, 47, 30]),
    # the phase-2 pool geometry with one row at its last column
    "R1_last_column": (1, 64, 64, 16, 12, 64, None),
    # positions at and past the table's width attend every column
    "past_the_table": (6, 20, 5, 16, 4, 64, [79, 80, 1000, 2 ** 30]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edges_relaunch_bit_identically(cuda_device, case):
    R, pages, MB, T, nh, dh, rest = EDGE_CASES[case]
    q, kp, vp, tables, positions = _operands(R, pages, MB, T, nh, dh,
                                             seed=len(case) + dh)
    if rest is None:
        tables[:] = np.arange(MB, dtype=np.int32)
        positions[:] = MB * T - 1
    else:
        positions[2:] = rest
    _twice_against_plain([torch.from_numpy(a).to(cuda_device)
                          for a in (q, kp, vp, tables, positions)])


@pytest.mark.cuda
def test_an_all_trash_batch(cuda_device):
    # every row inactive: each reads column 0 of the trash page alone
    R, pages, MB, T, nh, dh = 4, 10, 6, 16, 4, 64
    q, kp, vp, tables, positions = _operands(R, pages, MB, T, nh, dh, 5)
    tables[:] = pages
    positions[:] = 0
    ops = [torch.from_numpy(a).to(cuda_device)
           for a in (q, kp, vp, tables, positions)]
    _twice_against_plain(ops)
    got = tpa.paged_attention(*ops)
    want = ops[2][pages, 0][None].expand(R, nh, dh)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_library_split_count_is_the_mirror(cuda_device):
    for MB in (1, 2, 3, 4, 5, 6, 64, 100):
        for T in (1, 8, 13, 16, 24, 64):
            assert tpa.kernel_splits(MB, T) == tpa.splits(MB, T)


@pytest.mark.cuda
def test_kernel_refuses_a_misaligned_query(cuda_device):
    R, pages, MB, T, nh, dh = 2, 4, 2, 16, 2, 32
    ops = [torch.from_numpy(a).to(cuda_device)
           for a in _operands(R, pages, MB, T, nh, dh, 1)]
    flat = torch.empty(R * nh * dh + 1, device=cuda_device)
    q = flat[1:].view(R, nh, dh)
    q.copy_(ops[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        tpa.paged_attention(q, *ops[1:])


@pytest.mark.cuda
def test_kwide_face_launches_the_kernel_once_on_flattened_rows(cuda_device):
    # the verify step's shape at small widths: R rows of K1 lanes at
    # consecutive positions, the last row's lanes running past the table
    R, K1, pages, MB, T, nh, dh = 4, 5, 40, 8, 16, 4, 64
    rng = np.random.RandomState(33)
    q = rng.randn(R, K1, nh, dh).astype(np.float32)
    kp = rng.randn(pages + 1, T, nh, dh).astype(np.float32)
    vp = rng.randn(pages + 1, T, nh, dh).astype(np.float32)
    tables = rng.randint(0, pages, (R, MB)).astype(np.int32)
    start = np.array([0, T - 1, 37, MB * T - 3])
    positions = (start[:, None] + np.arange(K1)).astype(np.int32)
    ops = [torch.from_numpy(a).to(cuda_device)
           for a in (q, kp, vp, tables, positions)]
    before = tpa.launches
    got = tpa.paged_attention_kwide(*ops)
    again = tpa.paged_attention_kwide(*ops)
    torch.cuda.synchronize()
    assert tpa.launches == before + 2
    assert torch.equal(got, again)
    want = tpa.paged_attention_kwide_reference(*ops)
    assert got.shape == (R, K1, nh, dh) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL
    with pytest.raises(ValueError):           # int64 positions: refused
        tpa.paged_attention_kwide(*ops[:4], ops[4].long())
