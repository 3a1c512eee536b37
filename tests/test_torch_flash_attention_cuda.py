"""Flash attention forward on the card: the CUDA kernel against its
plain version, causal and not, at ragged lengths.

JAX-free, so that it runs where the card is. Tolerance: 2e-5 absolute on
``o`` and ``lse``, float32 on both sides; the kernel's online softmax
and the plain version's dense one sum in other orders, which moves
results of size ~1 by ~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402

TOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _qkv(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, H, D).astype(np.float32) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 64, 300])
def test_kernel_matches_plain_version_on_the_card(cuda_device, S):
    for causal in (True, False):
        q, k, v = [torch.from_numpy(a).to(cuda_device)
                   for a in _qkv(2, S, 3, 64, seed=S)]
        before = tfa.launches
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert tfa.launches == before + 1
        o_r, lse_r = tfa.flash_attention_reference(q, k, v, causal=causal)
        assert float((o - o_r).abs().max()) <= TOL
        assert float((lse - lse_r).abs().max()) <= TOL
