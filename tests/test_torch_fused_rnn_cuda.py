"""The fused LSTM and GRU recurrences on the card: the CUDA kernels
against their plain versions, ragged and full lengths, at a small odd
shape and at the sequence slice's shape (T 100, N 64, D 512), and their
refusal of other dtypes. Both tensor-core kernels also at their edges,
ragged and full, each launched twice and the second launch
bit-identical. The GRU's: N 65 (at D 128 five row groups of 16 rows, the
last of one row); D 36 (a partial k8 tile and a partial last block of
units); T 400 (a long chain of 3xTF32 sums); D 1024 (W split at each
load, as its split fragments do not fit); two pieces of rows, each
through all T steps (N 64 at D 1024: 32 rows a piece; N 160 at D 512:
two row groups of 64 rows, then 32 rows); and more unit groups than
SMs, where a block owns two of them and reads W from global memory (D
1152 and 1536, each in two pieces). The LSTM's (pieces of at most 32
rows): N 65 at D 128, D 36 and T 400 likewise; D 1024 at N 16 (W split
at each load, one piece of 16 rows) and at N 64 (four pieces); N 160 at
D 512 (two row groups of 32 rows a piece, three pieces); two unit groups
a block with W from global memory at D 1152 and D 1280 (the widest
multiple of 128 the ``lstm`` lowering sends to the kernel), each in two
pieces, and at D 1320, the widest the CUDA-core kernel it replaced took.

JAX-free, so that it runs where the card is. Tolerance: 1e-4 of the
largest magnitude, float32 on both sides: the sum order of each D-term
product differs (~1e-7 relative a step) and compounds over T steps of
the recurrence; the largest error over the largest magnitude is ~4e-7
on an H100, while a recurrence with its products in TF32 errs by ~2e-4.

The LSTM's bfloat16 face (bfloat16 xs, h0, c0, hs and cs; float32 w and
mask) at the same shapes and edges: both it and the plain version carry
the state in float32 and round hs and cs once, so every element must lie
within one bfloat16 ulp of its own magnitude plus 2e-5 of the largest
(float32 noise may put a value near a rounding boundary on the other
side). A recurrence that carries h and c in bfloat16, rounded every
step, misses that. The float32 kernels' outputs are pinned bit for bit
by checksums recorded on an H100 (132 SMs) before the bfloat16 face
was added.
"""
import hashlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import fused_gru as tgru  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as tlstm  # noqa: E402

T, N, D = 6, 8, 128
CARD_TOL = 1e-4
CARD_SHAPES = [(7, 3, 128), (100, 64, 512)]
# (T, N, D) at the GRU kernel's edges
GRU_EDGE_SHAPES = [(9, 65, 128), (9, 5, 36), (400, 64, 512), (5, 16, 1024),
                   (5, 64, 1024), (3, 160, 512), (4, 40, 1152),
                   (3, 24, 1536)]
GRU_EDGE_IDS = ["n65", "d36", "t400", "d1024", "d1024_two_pieces",
                "n160_two_pieces", "d1152_two_groups", "d1536_two_groups"]
# (T, N, D) at the LSTM kernel's edges
LSTM_EDGE_SHAPES = [(9, 65, 128), (9, 5, 36), (400, 64, 512),
                    (5, 16, 1024), (5, 64, 1024), (3, 160, 512),
                    (4, 40, 1152), (3, 40, 1280), (3, 24, 1320)]
LSTM_EDGE_IDS = ["n65", "d36", "t400", "d1024", "d1024_four_pieces",
                 "n160_three_pieces", "d1152_two_groups", "d1280_two_groups",
                 "d1320_two_groups"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _inputs(gates, seed, t=T, n=N, d=D, ragged=True):
    rng = np.random.RandomState(seed)
    xs = (rng.randn(t, n, gates * d) * 0.4).astype(np.float32)
    w = (rng.randn(d, gates * d) * 0.1).astype(np.float32)
    h0 = (rng.randn(n, d) * 0.2).astype(np.float32)
    c0 = (rng.randn(n, d) * 0.2).astype(np.float32)
    lens = rng.randint(1, t + 1, n) if ragged else np.full(n, t)
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    return xs, w, h0, c0, mask


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


# the bfloat16 face's tolerance: one ulp of an element's own magnitude,
# plus SUM_TOL of the largest
SUM_TOL = 2e-5


def _bf16_own_ulp_ratio(got, want):
    """The largest error of an element of ``got`` over one bfloat16 ulp
    of ``want``'s own magnitude plus SUM_TOL of the largest (at most 1
    passes); both bfloat16."""
    assert got.dtype == want.dtype == torch.bfloat16
    g, w = got.double(), want.double()
    mag = w.abs()
    own = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
        torch.where(mag > 0, mag, torch.ones_like(mag)))) - 7),
        torch.zeros_like(mag))
    return float(((g - w).abs() / (own + SUM_TOL * float(mag.max()))).max())


def _bf16_args(a, dev):
    """The LSTM's operands for the bfloat16 face: xs, h0 and c0 rounded
    to bfloat16, w and mask float32."""
    xs, w, h0, c0, mask = (torch.tensor(x, device=dev) for x in a)
    return xs.bfloat16(), w, h0.bfloat16(), c0.bfloat16(), mask


def _bf16_state_lstm(xs, w, h0, c0, mask):
    """The LSTM with h and c carried in bfloat16 (rounded every step),
    its arithmetic in float32: must miss the face's tolerance."""
    D = w.shape[0]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xs.shape[0]):
        g = xs[t].float() + h.float() @ w
        cand, i, f, o = (torch.tanh(g[:, :D]), torch.sigmoid(g[:, D:2 * D]),
                         torch.sigmoid(g[:, 2 * D:3 * D]),
                         torch.sigmoid(g[:, 3 * D:]))
        c_new = f * c.float() + i * cand
        m = mask[t][:, None]
        h = (o * torch.tanh(c_new) * m + h.float() * (1.0 - m)).bfloat16()
        c = (c_new * m + c.float() * (1.0 - m)).bfloat16()
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_lstm_kernel_matches_plain_version_on_the_card(cuda_device, shape,
                                                       ragged):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.tensor(a, device=cuda_device)
            for a in _inputs(4, 6, *shape, ragged=ragged)]
    kernels.reset_launches()
    hs, cs = tlstm.fused_lstm(*args)
    torch.cuda.synchronize()
    hr, cr = tlstm.fused_lstm_reference(*args)
    assert kernels.launch_counts()["fused_lstm"] == 1
    assert _rel(hs, hr) <= CARD_TOL and _rel(cs, cr) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("shape", LSTM_EDGE_SHAPES, ids=LSTM_EDGE_IDS)
def test_lstm_kernel_matches_plain_version_at_its_edges(cuda_device, shape,
                                                        ragged):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.tensor(a, device=cuda_device)
            for a in _inputs(4, 13, *shape, ragged=ragged)]
    kernels.reset_launches()
    hs, cs = tlstm.fused_lstm(*args)
    hs2, cs2 = tlstm.fused_lstm(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_lstm"] == 2
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)
    hr, cr = tlstm.fused_lstm_reference(*args)
    assert _rel(hs, hr) <= CARD_TOL and _rel(cs, cr) <= CARD_TOL


@pytest.mark.cuda
def test_lstm_kernel_relaunch_is_bit_identical(cuda_device):
    args = [torch.tensor(a, device=cuda_device)
            for a in _inputs(4, 14, *CARD_SHAPES[1])]
    first = tlstm.fused_lstm(*args)
    second = tlstm.fused_lstm(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 1])
def test_lstm_kernel_at_as_many_unit_groups_as_sms_and_one_more(cuda_device,
                                                                extra):
    # one unit group (8 units) an SM, and one group more: the launch turns
    # to blocks of two groups instead of refusing the width
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    d = 8 * (sms + extra)
    args = [torch.tensor(a, device=cuda_device)
            for a in _inputs(4, 15, 2, 4, d)]
    assert tlstm.launch_plan(4, d)["units_per_block"] == 8 * (1 + extra)
    hs, cs = tlstm.fused_lstm(*args)
    torch.cuda.synchronize()
    hr, cr = tlstm.fused_lstm_reference(*args)
    assert _rel(hs, hr) <= CARD_TOL and _rel(cs, cr) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_gru_kernel_matches_plain_version_on_the_card(cuda_device, shape,
                                                      ragged):
    torch.backends.cuda.matmul.allow_tf32 = False
    xs, w, h0, _, mask = (torch.tensor(a, device=cuda_device)
                          for a in _inputs(3, 7, *shape, ragged=ragged))
    kernels.reset_launches()
    hs = tgru.fused_gru(xs, w, h0, mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_gru"] == 1
    assert _rel(hs, tgru.fused_gru_reference(xs, w, h0, mask)) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("shape", GRU_EDGE_SHAPES, ids=GRU_EDGE_IDS)
def test_gru_kernel_matches_plain_version_at_its_edges(cuda_device, shape,
                                                       ragged):
    torch.backends.cuda.matmul.allow_tf32 = False
    xs, w, h0, _, mask = (torch.tensor(a, device=cuda_device)
                          for a in _inputs(3, 10, *shape, ragged=ragged))
    kernels.reset_launches()
    hs = tgru.fused_gru(xs, w, h0, mask)
    again = tgru.fused_gru(xs, w, h0, mask)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fused_gru"] == 2
    assert torch.equal(hs, again)
    assert _rel(hs, tgru.fused_gru_reference(xs, w, h0, mask)) <= CARD_TOL


@pytest.mark.cuda
def test_gru_kernel_relaunch_is_bit_identical(cuda_device):
    xs, w, h0, _, mask = (torch.tensor(a, device=cuda_device)
                          for a in _inputs(3, 11, *CARD_SHAPES[1]))
    first = tgru.fused_gru(xs, w, h0, mask)
    second = tgru.fused_gru(xs, w, h0, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 1])
def test_gru_kernel_at_as_many_unit_groups_as_sms_and_one_more(cuda_device,
                                                               extra):
    # one unit group (8 units) an SM, and one group more: the launch turns
    # to blocks of two groups instead of refusing the width
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    d = 8 * (sms + extra)
    xs, w, h0, _, mask = (torch.tensor(a, device=cuda_device)
                          for a in _inputs(3, 12, 2, 4, d))
    assert tgru.launch_plan(4, d)["units_per_block"] == 8 * (1 + extra)
    hs = tgru.fused_gru(xs, w, h0, mask)
    torch.cuda.synchronize()
    assert _rel(hs, tgru.fused_gru_reference(xs, w, h0, mask)) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("shape", CARD_SHAPES + LSTM_EDGE_SHAPES,
                         ids=["odd", "slice"] + LSTM_EDGE_IDS)
def test_lstm_bf16_face_matches_plain_version(cuda_device, shape, ragged):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _bf16_args(_inputs(4, 23, *shape, ragged=ragged), cuda_device)
    kernels.reset_launches()
    hs, cs = tlstm.fused_lstm(*args)
    hs2, cs2 = tlstm.fused_lstm(*args)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["fused_lstm_bf16"] == 2 and counts["fused_lstm"] == 0
    assert hs.dtype == cs.dtype == torch.bfloat16
    assert torch.equal(hs, hs2) and torch.equal(cs, cs2)
    hr, cr = tlstm.fused_lstm_reference(*args)
    assert _bf16_own_ulp_ratio(hs, hr) <= 1
    assert _bf16_own_ulp_ratio(cs, cr) <= 1


@pytest.mark.cuda
def test_lstm_bf16_state_recurrence_misses_the_faces_tolerance(cuda_device):
    # h carried between steps in bfloat16 (what staging the rounded hs
    # would give) is another function than the face's
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _bf16_args(_inputs(4, 24, *CARD_SHAPES[1]), cuda_device)
    hr, cr = tlstm.fused_lstm_reference(*args)
    hb, cb = _bf16_state_lstm(*args)
    assert _bf16_own_ulp_ratio(hb, hr) > 1
    assert _bf16_own_ulp_ratio(cb, cr) > 1


# sha256 (first 16 hex digits) of the float32 kernels' outputs (hs, then
# the LSTM's cs) on _inputs(gates, 21, *shape) (ragged), recorded on an
# H100 (132 SMs) from the kernels before the LSTM's bfloat16 face: the
# slice's shape (W split once), D 1024 (W split at each load) and D 1152
# (two unit groups a block)
F32_SHAPES = [(100, 64, 512), (5, 16, 1024), (4, 40, 1152)]
F32_SHA256 = {
    ("lstm", (100, 64, 512)): "acf37f0a2ccffedc",
    ("lstm", (5, 16, 1024)): "ab296f76abd167f3",
    ("lstm", (4, 40, 1152)): "bf2b4f84d23ea5c6",
    ("gru", (100, 64, 512)): "8df3d898988d4c21",
    ("gru", (5, 16, 1024)): "2e24bb22c4aac341",
    ("gru", (4, 40, 1152)): "956a245316e3d105",
}


def f32_checksum(cell, shape, dev):
    """The checksum F32_SHA256 records for ``cell`` at ``shape``."""
    gates = 4 if cell == "lstm" else 3
    xs, w, h0, c0, mask = (torch.tensor(a, device=dev)
                           for a in _inputs(gates, 21, *shape))
    outs = (tlstm.fused_lstm(xs, w, h0, c0, mask) if cell == "lstm"
            else (tgru.fused_gru(xs, w, h0, mask),))
    digest = hashlib.sha256()
    for o in outs:
        digest.update(o.cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("shape", F32_SHAPES,
                         ids=["slice", "d1024", "d1152_two_groups"])
def test_float32_kernels_are_bit_identical_to_the_recorded_outputs(
        cuda_device, cell, shape):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if sms != 132:
        pytest.skip("the checksums were recorded on an H100 with 132 SMs; "
                    "this card has %d" % sms)
    assert f32_checksum(cell, shape, cuda_device) == \
        F32_SHA256[(cell, shape)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_lstm_faces_refuse_more_units_than_two_groups_an_sm(cuda_device,
                                                            bf16):
    # D = 16 units an SM + 8: one unit block more than the SMs
    limit = tlstm.max_units(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert limit == 16 * sms
    a = _inputs(4, 25, 2, 2, limit + 8)
    args = _bf16_args(a, cuda_device) if bf16 else \
        [torch.tensor(x, device=cuda_device) for x in a]
    with pytest.raises(ValueError, match="up to 16 units an SM, %d on this "
                       "card, got %d" % (limit, limit + 8)):
        tlstm.fused_lstm(*args)


@pytest.mark.cuda
def test_gru_refuses_more_units_than_two_groups_an_sm(cuda_device):
    # D = 16 units an SM + 8, refused before the launch (no cooperative
    # launch of more blocks than the card holds)
    limit = tlstm.max_units(cuda_device)
    a = _inputs(3, 26, 2, 2, limit + 8)
    xs, w, h0, mask = (torch.tensor(x, device=cuda_device)
                       for x in (a[0], a[1], a[2], a[4]))
    kernels.reset_launches()
    with pytest.raises(ValueError, match="up to 16 units an SM, %d on this "
                       "card, got %d" % (limit, limit + 8)):
        tgru.fused_gru(xs, w, h0, mask)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.cuda
def test_kernels_refuse_other_dtypes(cuda_device):
    xs, w, h0, c0, mask = (torch.tensor(a, device=cuda_device)
                           for a in _inputs(4, 8))
    with pytest.raises(ValueError, match="float32"):
        tlstm.fused_lstm(xs.double(), w.double(), h0.double(), c0.double(),
                         mask.double())
    bf = torch.bfloat16
    # the bfloat16 face takes float32 w and mask, and bfloat16 xs, h0 and
    # c0 together; float16 has no face
    refused = [
        (xs.to(bf), w.to(bf), h0.to(bf), c0.to(bf), mask),
        (xs.to(bf), w, h0.to(bf), c0.to(bf), mask.to(bf)),
        (xs.half(), w, h0.half(), c0.half(), mask),
        (xs.half(), w.half(), h0.half(), c0.half(), mask.half()),
        (xs.to(bf), w, h0, c0, mask),
        (xs.to(bf), w, h0.to(bf), c0, mask),
        (xs, w, h0.to(bf), c0.to(bf), mask),
    ]
    kernels.reset_launches()
    for args in refused:
        with pytest.raises(ValueError, match="bfloat16 xs, h0 and c0 with "
                           "float32 w and mask"):
            tlstm.fused_lstm(*args)
    assert set(kernels.launch_counts().values()) == {0}
    gx, gw, gh0, _, gmask = (torch.tensor(a, device=cuda_device)
                             for a in _inputs(3, 9))
    with pytest.raises(ValueError, match="float32"):
        tgru.fused_gru(gx.half(), gw.half(), gh0.half(), gmask.half())
