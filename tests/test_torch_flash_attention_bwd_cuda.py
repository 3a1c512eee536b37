"""Flash attention backward on the card: the dK/dV and dQ kernels against
the plain backward, at every head dim's template (D 32 non-causal, D 64
and D 128 causal) and ragged lengths, with a second launch that must
equal the first bit for bit, and their refusal of misaligned operands.

JAX-free, so that it runs where the card is. Inputs and the cotangents
on both ``o`` and ``lse`` are made with numpy from a seed. Tolerance:
5e-5 absolute on dq, dk and dv (values of size ~1), float32 on both
sides; the kernels take their products in 3xTF32 on the tensor cores,
float32-exact but summed in other orders than the plain backward's,
which moves results by ~1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402

TOL = 5e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    return torch.device("cuda", 0)


def _inputs(B, S, H, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = [rng.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4)]
    dlse = rng.randn(B, H, S).astype(np.float32)
    return q, k, v, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 130, 300])
def test_kernels_match_plain_backward_on_the_card(cuda_device, S):
    torch.backends.cuda.matmul.allow_tf32 = False
    for D, causal in ((32, False), (64, True), (128, True)):
        q, k, v, do, dlse = [torch.from_numpy(a).to(cuda_device)
                             for a in _inputs(2, S, 3, D, seed=S + D)]
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        before = kernels.launch_counts()
        got = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                      causal=causal)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["flash_attention_bwd_dkv"] == \
            before["flash_attention_bwd_dkv"] + 1
        assert after["flash_attention_bwd_dq"] == \
            before["flash_attention_bwd_dq"] + 1
        want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                                 causal=causal)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= TOL
        # no atomics and a fixed order of sums: a second launch on the
        # same inputs gives the same bits
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                        causal=causal)
        for g, a in zip(got, again):
            assert torch.equal(g, a)


@pytest.mark.cuda
def test_kernels_refuse_misaligned_operands(cuda_device):
    q, k, v, do, _ = [torch.from_numpy(a).to(cuda_device)
                      for a in _inputs(1, 8, 1, 32, seed=5)]
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    # contiguous, but one float past a 16-byte boundary
    shifted = torch.empty(q.numel() + 1, device=cuda_device)[1:]
    q_off = shifted.view(q.shape).copy_(q)
    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.flash_attention_bwd(q_off, k, v, o, lse, do, causal=True)
    assert kernels.launch_counts() == before
