"""Flash attention forward on the card: the CUDA kernel against its
plain version, causal and not, at ragged lengths and at every head dim's
template (D 32 non-causal, D 64, D 128 causal), with a second launch that
must equal the first bit for bit, and its refusal of misaligned operands;
its bfloat16 face (pure AMP) at every head dim, causal and not, on the
path its rule takes (D 64 the TMA-fed wgmma kernel, at lengths on both
sides of its 128-row tiles; D 32 and 128 the mma.sync kernel, counted
apart), a batch beside NaN rows of the next one, the mma.sync kernel
forced at D 64, the templates free of spills, and the refusal of a
mixed set of dtypes.

JAX-free, so that it runs where the card is. Tolerance: 2e-5 absolute on
``o`` and ``lse``, float32 on both sides; the kernel takes its products
in 3xTF32 on the tensor cores, float32-exact, and its online softmax and
the plain version's dense one sum in other orders, which moves results
of size ~1 by ~1e-6.

The bfloat16 face computes in float32 and rounds o once, as its plain
version does (float32 on the card, TF32 off): o within one bfloat16 ulp
(:func:`bf16_errors`), lse within TOL. The CPU tests of the plain
versions against the JAX package import the tolerance from here, the
JAX-free module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402

TOL = 2e-5
# the float32 noise term of a bfloat16 output's tolerance, over the
# largest magnitude (the float32 backward kernels' tolerance)
SUM_TOL = 2e-5


def bf16_ulp(m):
    """One bfloat16 ulp at magnitude ``m`` (8 significant bits), elementwise
    on an array; 0 at 0."""
    m = np.abs(np.asarray(m, np.float64))
    e = np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7
    return np.where(m > 0, np.exp2(e), 0.0)


def bf16_errors(got, want):
    """How far a bfloat16 output is from its reference: (the largest error
    over one ulp of the largest magnitude, the largest error of an
    element over one ulp of its own magnitude plus SUM_TOL of the
    largest, the number of elements that differ). Both ratios are at
    most 1 for two computations in float32 rounded once."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    err = np.abs(g - w)
    m = float(np.abs(w).max())
    own = err / (bf16_ulp(w) + SUM_TOL * m)
    return (float(err.max() / bf16_ulp(m)), float(own.max()),
            int(np.count_nonzero(err)))


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


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 17, 130, 300])
def test_kernel_matches_plain_version_at_every_head_dim(cuda_device, S):
    for D, causal in ((32, False), (128, True)):
        q, k, v = [torch.from_numpy(a).to(cuda_device)
                   for a in _qkv(2, S, 3, D, seed=S + D)]
        before = tfa.launches
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert tfa.launches == before + 1
        o_r, lse_r = tfa.flash_attention_reference(q, k, v, causal=causal)
        assert float((o - o_r).abs().max()) <= TOL, (D, causal)
        assert float((lse - lse_r).abs().max()) <= TOL, (D, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("D,causal", [(32, False), (64, True),
                                      (128, True)])
def test_second_launch_is_bit_identical(cuda_device, D, causal):
    # no atomics and a fixed order of sums: the same inputs give the
    # same bits
    q, k, v = [torch.from_numpy(a).to(cuda_device)
               for a in _qkv(2, 257, 3, D, seed=D)]
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    o2, lse2 = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_kernel_refuses_misaligned_operands(cuda_device):
    q, k, v = [torch.from_numpy(a).to(cuda_device)
               for a in _qkv(1, 8, 1, 32, seed=5)]
    # contiguous, but one float past a 16-byte boundary
    shifted = torch.empty(q.numel() + 1, device=cuda_device)[1:]
    q_off = shifted.view(q.shape).copy_(q)
    before = tfa.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        tfa.flash_attention_with_lse(q_off, k, v, causal=True)
    assert tfa.launches == before


def _check_bf16(o, lse, o_r, lse_r, what):
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    max_ulps, own_ulps, _ = bf16_errors(o.float().cpu().numpy(),
                                        o_r.float().cpu().numpy())
    assert max_ulps <= 1 and own_ulps <= 1, (what, max_ulps, own_ulps)
    assert float((lse - lse_r).abs().max()) <= TOL, what


# lengths of the bfloat16 face's cases: at D 64 (the wgmma kernel) on
# both sides of its 128-row query and key tiles
BF16_LENGTHS = {32: (1, 17, 130, 300), 64: (1, 17, 127, 128, 129, 300, 1024),
                128: (1, 17, 130, 300)}


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_face_matches_plain_version(cuda_device, D, causal):
    # each case launched twice: the second must equal the first bit for
    # bit; each launch counted on the counter of the path the rule takes
    # (the library's own rule agrees with the mirror), the float32 face
    # not launched
    torch.backends.cuda.matmul.allow_tf32 = False
    path = tfa.fwd_bf16_path(D)
    assert tfa.kernel_fwd_bf16_path(D) == path
    assert tfa.kernel_fwd_smem_bytes(D, "bf16") == tfa.fwd_bf16_smem_bytes(D)
    assert tfa.kernel_fwd_smem_bytes(D, "bf16_mma") == \
        tfa.fwd_bf16_smem_bytes(D, "mma")
    counters = ("flash_attention_fwd", "flash_attention_fwd_bf16",
                "flash_attention_fwd_bf16_mma")
    want = [0, 2, 0] if path == "wgmma" else [0, 0, 2]
    for S in BF16_LENGTHS[D]:
        q, k, v = [torch.from_numpy(a).to(cuda_device).bfloat16()
                   for a in _qkv(2, S, 3, D, seed=S + D)]
        before = kernels.launch_counts()
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        o2, lse2 = tfa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert [after[c] - before[c] for c in counters] == want, S
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        o_r, lse_r = tfa.flash_attention_reference(q, k, v, causal=causal)
        _check_bf16(o, lse, o_r, lse_r, S)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [100, 129, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_face_reads_nothing_of_the_next_batch(cuda_device, S,
                                                        causal):
    # the wgmma kernel's tiles cross the end of S; the next batch's rows,
    # NaN, must not reach the first batch's o and lse: they equal those of
    # the first batch alone, bit for bit
    q, k, v = [torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in _qkv(2, S, 3, 64, seed=S)]
    for t in (q, k, v):
        t[1] = float("nan")
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    alone = tfa.flash_attention_with_lse(
        *(t[:1].contiguous() for t in (q, k, v)), causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o[:1], alone[0]) and torch.equal(lse[:1], alone[1])
    assert bool(torch.isfinite(o[:1].float()).all())
    o_r, lse_r = tfa.flash_attention_reference(
        *(t[:1] for t in (q, k, v)), causal=causal)
    _check_bf16(o[:1], lse[:1], o_r, lse_r, S)


@pytest.mark.cuda
def test_mma_kernel_forced_at_d64_matches_plain_version(cuda_device):
    # the face's design before its wgmma kernel, which chip_smoke times
    # beside it, on the same operands; counted nowhere
    q, k, v = [torch.from_numpy(a).to(cuda_device).bfloat16()
               for a in _qkv(2, 300, 3, 64, seed=9)]
    before = kernels.launch_counts()
    o, lse = tfa._launch_fwd(q, k, v, True, 64 ** -0.5, mma=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    o_r, lse_r = tfa.flash_attention_reference(q, k, v, causal=True)
    _check_bf16(o, lse, o_r, lse_r, "mma")


@pytest.mark.cuda
def test_bf16_templates_do_not_spill(cuda_device):
    # the wgmma kernel and the mma.sync kernel's three templates:
    # registers reported, no spill
    from paddle_tpu_torch.kernels import _build
    _build.load("flash_attention_fwd")
    entries, name = {}, None
    for ln in _build.build_log("flash_attention_fwd").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entries[name] = []
        elif name is not None and ("registers" in ln or "spill" in ln):
            entries[name].append(ln)
    bf16 = {k: v for k, v in entries.items()
            if "flash_fwd_bf16_wgmma_kernel" in k
            or "flash_fwd_bf16_mma_kernel" in k}
    assert len(bf16) == 4, list(entries)
    for k, lines in bf16.items():
        assert any("registers" in ln for ln in lines), k
        for ln in lines:
            for part in ln.split(","):
                if "spill" in part:
                    assert part.split()[0] == "0", (k, ln)


@pytest.mark.cuda
def test_kernel_refuses_a_mixed_set_of_dtypes(cuda_device):
    q, k, v = [torch.from_numpy(a).to(cuda_device)
               for a in _qkv(1, 8, 1, 32, seed=6)]
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="k torch.bfloat16") as e:
        tfa.flash_attention_with_lse(q, k.bfloat16(), v, causal=True)
    assert "q torch.float32" in str(e.value)
    with pytest.raises(ValueError, match="float16"):
        tfa.flash_attention_with_lse(q.half(), k.half(), v.half())
    assert kernels.launch_counts() == before
