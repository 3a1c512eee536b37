"""Flash attention backward on the card: the dK/dV and dQ kernels against
the plain backward, at every head dim's template (D 32 non-causal, D 64
and D 128 causal) and ragged lengths, with a second launch that must
equal the first bit for bit, and their refusal of misaligned operands;
their bfloat16 faces (pure AMP) at every head dim, causal and not, on
the path their rule takes (D 64 the TMA-fed wgmma kernels, at lengths on
both sides of their 32-, 64- and 128-row tiles and a walk of S 2048; D
32 and 128 the mma.sync kernels, counted apart), a batch beside NaN rows
of the next one, the mma.sync kernels forced at D 64, the templates free
of spills, and the refusal of a mixed set of dtypes.

JAX-free, so that it runs where the card is. Inputs and the cotangents
on both ``o`` and ``lse`` are made with numpy from a seed. Tolerance:
5e-5 absolute on dq, dk and dv (values of size ~1), float32 on both
sides; the kernels take their products in 3xTF32 on the tensor cores,
float32-exact but summed in other orders than the plain backward's,
which moves results by ~1e-6. The bfloat16 faces compute in float32 and
round dq, dk and dv once, as the plain backward does: each within one
bfloat16 ulp (``test_torch_flash_attention_cuda.bf16_errors``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tfa  # noqa: E402
from test_torch_flash_attention_cuda import bf16_errors  # noqa: E402

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


# lengths of the bfloat16 faces' cases: at D 64 (the wgmma kernels) on
# both sides of the dK/dV kernel's 32-query tiles and 128-key blocks and
# the dQ kernel's 64-key tiles and 128-query blocks
BF16_LENGTHS = {32: (1, 17, 130, 300),
                64: (1, 17, 63, 64, 65, 127, 128, 129, 300, 1024),
                128: (1, 17, 130, 300)}
BF16_COUNTERS = ("flash_attention_bwd_dkv_bf16", "flash_attention_bwd_dq_bf16",
                 "flash_attention_bwd_dkv_bf16_mma",
                 "flash_attention_bwd_dq_bf16_mma", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")


def _bf16_case(dev, B, S, H, D, causal, seed):
    q, k, v, do, dlse = [torch.from_numpy(a).to(dev)
                         for a in _inputs(B, S, H, D, seed=seed)]
    q, k, v, do = (t.bfloat16() for t in (q, k, v, do))
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, do, dlse, o, lse


def _check_bf16_grads(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, (what, name)
        max_ulps, own_ulps, _ = bf16_errors(g.float().cpu().numpy(),
                                            w.float().cpu().numpy())
        assert max_ulps <= 1 and own_ulps <= 1, (what, name, max_ulps,
                                                 own_ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_faces_match_plain_backward(cuda_device, D, causal):
    # each case launched twice: the second must equal the first bit for
    # bit; each launch counted on the counters of the path the rule takes
    # (the library's own rule and shared memory agree with the mirror),
    # the float32 kernels not launched
    torch.backends.cuda.matmul.allow_tf32 = False
    path = tfa.bwd_bf16_path(D)
    assert tfa.kernel_bwd_bf16_path(D) == path
    for which in ("dkv", "dq"):
        assert tfa.kernel_bwd_smem_bytes(D, which, "bf16") == \
            tfa.bwd_bf16_smem_bytes(D, which)
        assert tfa.kernel_bwd_smem_bytes(D, which, "bf16_mma") == \
            tfa.bwd_bf16_smem_bytes(D, which, "mma")
    want_counts = [2, 2, 0, 0, 0, 0] if path == "wgmma" \
        else [0, 0, 2, 2, 0, 0]
    for S in BF16_LENGTHS[D]:
        q, k, v, do, dlse, o, lse = _bf16_case(cuda_device, 2, S, 3, D,
                                               causal, seed=S + D)
        before = kernels.launch_counts()
        got = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                      causal=causal)
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                        causal=causal)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert [after[f] - before[f] for f in BF16_COUNTERS] == \
            want_counts, S
        for name, g, a in zip(("dq", "dk", "dv"), got, again):
            assert torch.equal(g, a), (S, name)
        want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                                 causal=causal)
        _check_bf16_grads(got, want, S)


@pytest.mark.cuda
def test_bfloat16_faces_hold_the_gate_on_a_long_walk(cuda_device):
    # S 2048: a dK/dV block's walk of 64 query tiles, each tile's sum
    # added in float32 to dk and dv; relaunched bit-identically
    q, k, v, do, dlse, o, lse = _bf16_case(cuda_device, 2, 2048, 4, 64, True,
                                           seed=11)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse, causal=True)
    again = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse, causal=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                             causal=True)
    _check_bf16_grads(got, want, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [100, 129, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_faces_read_nothing_of_the_next_batch(cuda_device, S,
                                                        causal):
    # the wgmma kernels' tiles cross the end of S; the next batch's rows,
    # NaN (and so its lse and delta, which the dK/dV kernel's boxes of
    # [B H S] reach past S), must not reach the first batch's gradients:
    # they equal those of the first batch alone, bit for bit
    q, k, v, do, dlse, _, _ = _bf16_case(cuda_device, 2, S, 3, 64, causal,
                                         seed=S)
    for t in (q, k, v, do):
        t[1] = float("nan")
    dlse[1] = float("nan")
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, dlse, causal=causal)
    first = [t[:1].contiguous() for t in (q, k, v, o, lse, do, dlse)]
    alone = tfa.flash_attention_bwd(*first, causal=causal)
    torch.cuda.synchronize()
    for name, g, a in zip(("dq", "dk", "dv"), got, alone):
        assert torch.equal(g[:1], a), name
        assert bool(torch.isfinite(g[:1].float()).all()), name
    want = tfa.flash_attention_bwd_reference(*first, causal=causal)
    _check_bf16_grads([g[:1] for g in got], want, S)


@pytest.mark.cuda
def test_mma_kernels_forced_at_d64_match_plain_backward(cuda_device):
    # the faces' design before their wgmma kernels, which chip_smoke times
    # beside them, on the same operands; counted nowhere
    q, k, v, do, _, o, lse = _bf16_case(cuda_device, 2, 300, 3, 64, True,
                                        seed=9)
    delta = tfa._delta(o, do, None).contiguous()
    scale = 64 ** -0.5
    before = kernels.launch_counts()
    dk, dv = tfa._bwd_dkv(q, k, v, do, lse, delta, True, scale, mma=True)
    dq = tfa._bwd_dq(q, k, v, do, lse, delta, True, scale, mma=True)
    again = tfa._bwd_dq(q, k, v, do, lse, delta, True, scale, mma=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before
    assert torch.equal(dq, again)
    want = tfa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=True)
    _check_bf16_grads((dq, dk, dv), want, "mma")


@pytest.mark.cuda
def test_bf16_templates_do_not_spill(cuda_device):
    # the two wgmma kernels and the mma.sync kernels' six templates:
    # registers reported, no spill
    from paddle_tpu_torch.kernels import _build
    _build.load("flash_attention_bwd")
    entries, name = {}, None
    for ln in _build.build_log("flash_attention_bwd").splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entries[name] = []
        elif name is not None and ("registers" in ln or "spill" in ln):
            entries[name].append(ln)
    bf16 = {k: v for k, v in entries.items()
            if "_bf16_wgmma_kernel" in k or "_bf16_mma_kernel" in k}
    assert len(bf16) == 8, list(entries)
    for k, lines in bf16.items():
        assert any("registers" in ln for ln in lines), k
        for ln in lines:
            for part in ln.split(","):
                if "spill" in part:
                    assert part.split()[0] == "0", (k, ln)


@pytest.mark.cuda
def test_kernels_refuse_a_mixed_set_of_dtypes(cuda_device):
    q, k, v, do, _ = [torch.from_numpy(a).to(cuda_device).bfloat16()
                      for a in _inputs(1, 8, 1, 32, seed=7)]
    o, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="do torch.float32") as e:
        tfa.flash_attention_bwd(q, k, v, o, lse, do.float(), causal=True)
    assert "q torch.bfloat16" in str(e.value)
    with pytest.raises(ValueError, match="lse must be float32"):
        tfa.flash_attention_bwd(q, k, v, o, lse.bfloat16(), do, causal=True)
    assert kernels.launch_counts() == before
