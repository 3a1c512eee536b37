"""The fused LSTM and GRU recurrences on the card: the CUDA kernels
against their plain versions, ragged and full lengths, at a small odd
shape and at the sequence slice's shape (T 100, N 64, D 512), and their
refusal of other dtypes.

JAX-free, so that it runs where the card is. Tolerance: 1e-4 of the
largest magnitude, float32 on both sides: the sum order of each D-term
product differs (~1e-7 relative a step) and compounds over T steps of
the recurrence; the largest error over the largest magnitude is ~4e-7
on an H100, while a recurrence with its products in TF32 errs by ~2e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import fused_gru as tgru  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as tlstm  # noqa: E402

T, N, D = 6, 8, 128
CARD_TOL = 1e-4
CARD_SHAPES = [(7, 3, 128), (100, 64, 512)]


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
def test_kernels_refuse_other_dtypes(cuda_device):
    xs, w, h0, c0, mask = (torch.tensor(a, device=cuda_device)
                           for a in _inputs(4, 8))
    with pytest.raises(ValueError, match="float32"):
        tlstm.fused_lstm(xs.double(), w.double(), h0.double(), c0.double(),
                         mask.double())
    gx, gw, gh0, _, gmask = (torch.tensor(a, device=cuda_device)
                             for a in _inputs(3, 9))
    with pytest.raises(ValueError, match="float32"):
        tgru.fused_gru(gx.half(), gw.half(), gh0.half(), gmask.half())
