"""The 3x3 / s1 / p1 convolution on the card: the CUDA kernel (forward,
and dx on the rotated filter) against its plain version, and its refusal
of other dtypes.

JAX-free, so that it runs where the card is. Tolerance: 1e-5 of the
largest magnitude of the plain output (or 1e-5 absolute below 1),
float32 on both sides; the kernel and the plain version's 9 tap matmuls
sum in other orders, which moves outputs of size ~1-30 by ~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import conv3x3 as tconv  # noqa: E402

TOL = 1e-5
SHAPES = [(2, 8, 8, 16, 32), (1, 7, 7, 64, 64), (2, 14, 14, 32, 16),
          (3, 7, 9, 24, 40)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _inputs(shape, seed):
    n, h, w, c, o = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)
    g = rng.randn(n, h, w, o).astype(np.float32)
    return x, wt, g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(2, 5, 6, 3, 7)])
def test_kernel_matches_plain_version_on_the_card(cuda_device, shape):
    x, w, g = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(shape, seed=7))
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.reset_launches()
    out = tconv.conv3x3_s1_nhwc(x, w)
    dx, dw = tconv.conv3x3_bwd(x, w, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv3x3_fwd"] == 1
    assert kernels.launch_counts()["conv3x3_dx"] == 1
    want = tconv.conv3x3_reference(x, w)
    want_dx, want_dw = tconv.conv3x3_bwd_reference(x, w, g)
    for got, ref in ((out, want), (dx, want_dx), (dw, want_dw)):
        assert float((got - ref).abs().max()) <= \
            TOL * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes(cuda_device):
    x, w, _ = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(SHAPES[0], seed=8))
    with pytest.raises(ValueError, match="float32"):
        tconv.conv3x3_s1_nhwc(x.double(), w.double())
