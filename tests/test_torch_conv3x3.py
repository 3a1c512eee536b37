"""The 3x3 / s1 / p1 convolution: the port's plain forward and its
``torch.autograd.Function`` wrapper against the JAX package's
``conv3x3_s1_nhwc`` (the Pallas kernel in interpret mode on the CPU) and
its custom vjp.

Inputs are made with numpy from a seed and handed to both packages, NHWC
activations and HWIO filters in both. Tolerance: 1e-5 relative and
absolute on the forward, float32 on both sides; the Pallas kernel sums
the 9 taps of an (H*W, C) @ (C, O) product and the plain version the
same taps through torch's matmul, in other orders, which moves outputs
of size ~1-10 by ~1e-6. The backward's sums run over N*H*W pixels (dw)
or 9*O products (dx) to values of size ~10-30, where an entry near 0
carries the same absolute noise; its tolerance is 1e-5 of the largest
magnitude of the JAX gradient.
"""
import math
import os
import re

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.conv3x3 import (  # noqa: E402
    conv3x3_s1_nhwc as jax_conv3x3, supports_conv3x3 as jax_supports)
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import conv3x3 as tconv  # noqa: E402

TOL = 1e-5
SHAPES = [(2, 8, 8, 16, 32), (1, 7, 7, 64, 64), (2, 14, 14, 32, 16),
          (3, 7, 9, 24, 40)]


def _inputs(shape, seed):
    n, h, w, c, o = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, o) * 0.1).astype(np.float32)
    g = rng.randn(n, h, w, o).astype(np.float32)
    return x, wt, g


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_jax_kernel(shape):
    x, w, _ = _inputs(shape, seed=sum(shape))
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(w)))
    got = tconv.conv3x3_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_wrapper_backward_matches_jax_vjp(shape):
    x, w, g = _inputs(shape, seed=sum(shape) + 1)
    out, vjp = jax.vjp(jax_conv3x3, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tconv.conv3x3_s1_nhwc(xt, wt, config={"block_n": 2})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=TOL, atol=TOL)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
    for a, b in ((dx, want_dx), (dw, want_dw)):
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= \
            TOL * float(np.abs(b).max())
    # the functional backward the conv2d grad op calls gives the same
    fdx, fdw = tconv.conv3x3_bwd(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(g))
    assert torch.equal(fdx, dx) and torch.equal(fdw, dw)
    only_dw = tconv.conv3x3_bwd(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(g), want_dx=False)
    assert only_dw[0] is None and torch.equal(only_dw[1], dw)


@pytest.mark.parametrize("args", [
    ((8, 4, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ((8, 4, 3, 3), (2, 2), (1, 1), (1, 1), 1),
    ((8, 4, 3, 3), (1, 1), (0, 0), (1, 1), 1),
    ((8, 4, 3, 3), (1, 1), (1, 1), (2, 2), 1),
    ((8, 2, 3, 3), (1, 1), (1, 1), (1, 1), 2),
    ((8, 4, 1, 1), (1, 1), (1, 1), (1, 1), 1),
    ((8, 4, 7, 7), (2, 2), (3, 3), (1, 1), 1),
])
def test_supports_the_same_population_as_jax(args):
    assert tconv.supports_conv3x3(*args) == jax_supports(*args)


def test_cpu_call_counts_no_launch():
    kernels.reset_launches()
    x, w, g = (torch.from_numpy(a) for a in _inputs(SHAPES[0], seed=3))
    leaves = [t.requires_grad_(True) for t in (x, w)]
    out = tconv.conv3x3_s1_nhwc(*leaves)
    torch.autograd.grad(out, leaves, g)
    counts = kernels.launch_counts()
    assert {"conv3x3_fwd", "conv3x3_dx"} <= set(counts)
    assert set(counts.values()) == {0}


# (N, H, W, C, O) and the tiling the kernel's rule takes on 132 SMs:
# ResNet-50's stage shapes at batch 32 (784, 392, 392 and 200 blocks),
# then the edge shapes of chip_smoke.py's phase 6 and one dx of them
# (C and O swapped)
RULE_PICKS = [
    ((32, 56, 56, 64, 64), (128, 64), 784),
    ((32, 28, 28, 128, 128), (128, 64), 392),
    ((32, 14, 14, 256, 256), (64, 64), 392),
    ((32, 7, 7, 512, 512), (64, 64), 200),
    ((3, 7, 9, 24, 40), (64, 64), 3),
    ((2, 5, 6, 3, 7), (64, 64), 1),
    ((2, 9, 11, 36, 64), (64, 64), 4),
    ((2, 7, 7, 512, 512), (64, 64), 16),
    ((4, 95, 97, 64, 40), (128, 64), 288),
    ((16, 33, 33, 32, 200), (128, 128), 274),
    ((16, 33, 33, 200, 32), (64, 64), 273),
]


@pytest.mark.parametrize("shape,want,blocks", RULE_PICKS)
def test_tiling_rule_picks(shape, want, blocks):
    N, H, W, C, O = shape
    bm, bn = tconv.tiling(*shape)
    assert (bm, bn) == want
    assert -(-N * H * W // bm) * -(-O // bn) == blocks
    # the largest tiling within the rule's limits: BN <= max(64, O) and
    # 2 blocks an SM, or 64 x 64 where none has the blocks
    larger = tconv.TILINGS[:tconv.TILINGS.index(want)]
    for lbm, lbn in larger:
        assert lbn > max(64, O) or \
            -(-N * H * W // lbm) * -(-O // lbn) < 2 * tconv.H100_SMS


def test_tiling_rule_follows_the_sm_count():
    # half the SMs: the second stage has the blocks for 128 x 128, the
    # first stays at BN 64 (O 64)
    assert tconv.tiling(32, 28, 28, 128, 128, sms=66) == (128, 128)
    assert tconv.tiling(32, 56, 56, 64, 64, sms=66) == (128, 64)
    assert tconv.tiling(32, 7, 7, 512, 512, sms=1000) == (64, 64)


def test_smem_bytes_is_three_stages_of_both_tiles():
    for bm, bn in tconv.TILINGS:
        assert tconv.smem_bytes(bm, bn) == \
            3 * (bm * (32 + 4) + 32 * (bn + 8)) * 4
    assert [tconv.smem_bytes(*t) for t in tconv.TILINGS] == \
        [107520, 82944, 55296]


def test_mirror_matches_the_source():
    """The tilings, the step depth, the ring and the paddings of
    csrc/conv3x3.cu are those the mirror computes with."""
    path = os.path.join(os.path.dirname(tconv.__file__), "csrc",
                        "conv3x3.cu")
    with open(path) as fh:
        src = fh.read()

    def ints(name):
        m = re.search(r"constexpr int %s(?:\[\w+\])? = \{?([\d, ]+)\}?;"
                      % name, src)
        return [int(v) for v in m.group(1).split(",")]

    assert list(zip(ints("TILING_BM"), ints("TILING_BN"))) == \
        list(tconv.TILINGS)
    assert ints("BK") == [32] and ints("STAGES") == [3]
    assert ints("X_PAD") == [4] and ints("W_PAD") == [8]
    assert "2LL * sm_count()" in src


# -- the bfloat16 face (AMP) --------------------------------------------------
#
# bfloat16 operands, float32 sums (each product exact), written in
# bfloat16 or float32. Tolerances: a bfloat16 output within one bfloat16
# ulp of the largest magnitude of the JAX output (both sum exactly in
# float32 in other orders and round once, so an output within float32
# noise of a rounding boundary may land one ulp apart); a float32 output
# within 1e-5 of the largest magnitude, the sum orders.

BF16 = np.dtype(ml_dtypes.bfloat16)


def _bf16_ulp(m):
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _close_any(got, want):
    """``got`` (a tensor) against ``want`` (a JAX or numpy array) at the
    tolerance of ``want``'s dtype."""
    want = np.asarray(want)
    if got.dtype == torch.bfloat16:
        assert want.dtype == BF16
        got = got.float()
    else:
        assert want.dtype == np.float32 and got.dtype == torch.float32
    w = want.astype(np.float64)
    err = float(np.abs(got.double().numpy() - w).max())
    m = float(np.abs(w).max())
    tol = _bf16_ulp(m) if want.dtype == BF16 else TOL * max(1.0, m)
    assert err <= tol, (err, tol)


def _bf16_inputs(shape, seed):
    x, w, g = _inputs(shape, seed)
    return [torch.from_numpy(a).bfloat16() for a in (x, w, g)]


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("out_dtype", [None, torch.float32],
                         ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("shape", SHAPES + [(2, 5, 6, 3, 7)])
def test_bf16_reference_matches_jax_kernel(shape, out_dtype):
    x, w, _ = _bf16_inputs(shape, seed=sum(shape) + 5)
    want = jax_conv3x3(_jnp(x), _jnp(w),
                       None if out_dtype is None else jnp.float32)
    got = tconv.conv3x3_reference(x, w, out_dtype)
    assert got.dtype == (out_dtype or torch.bfloat16)
    _close_any(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_wrapper_backward_matches_jax_vjp(shape):
    # dx is the kernel on the bfloat16 cotangent and the rotated filter,
    # written in bfloat16; dw the float32 tap sums rounded to bfloat16
    x, w, g = _bf16_inputs(shape, seed=sum(shape) + 6)
    out, vjp = jax.vjp(jax_conv3x3, _jnp(x), _jnp(w))
    want_dx, want_dw = vjp(_jnp(g))
    xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = tconv.conv3x3_s1_nhwc(xt, wt)
    _close_any(got.detach(), out)
    dx, dw = torch.autograd.grad(got, (xt, wt), g)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close_any(dx, want_dx)
    _close_any(dw, want_dw)
    fdx, fdw = tconv.conv3x3_bwd(x, w, g)
    assert torch.equal(fdx, dx) and torch.equal(fdw, dw)


def test_bf16_partial_sums_miss_the_tolerance():
    # a plain variant that rounds the running sum to bfloat16 after each
    # k step (a tap's 32 channels: what a kernel that accumulated in
    # bfloat16 would compute; 72 steps at C 256) is several ulps off: the
    # one-ulp tolerance tells it from the face
    shape = (2, 8, 8, 256, 32)
    x, w, _ = _bf16_inputs(shape, seed=9)
    want = np.asarray(jax_conv3x3(_jnp(x), _jnp(w)))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy, dx, patch in tconv._taps(xp, 8, 8):
        for c0 in range(0, 256, 32):
            t = torch.matmul(patch[:, c0:c0 + 32].float(),
                             w[dy, dx, c0:c0 + 32].float())
            acc = (t if acc is None else acc.float() + t).bfloat16()
    rounded = acc.reshape(2, 8, 8, 32)
    with pytest.raises(AssertionError):
        _close_any(rounded, want)
    _close_any(tconv.conv3x3_reference(x, w), want)


def test_bf16_smem_bytes_is_three_stages_of_both_tiles():
    for bm, bn in tconv.TILINGS:
        assert tconv.smem_bytes(bm, bn, torch.bfloat16) == \
            tconv.smem_bytes(bm, bn, "bfloat16") == \
            3 * (bm * (32 + 8) + 32 * (bn + 8)) * 2
    assert [tconv.smem_bytes(*t, "bfloat16") for t in tconv.TILINGS] == \
        [56832, 44544, 29184]


def test_bf16_cpu_call_counts_no_launch():
    kernels.reset_launches()
    x, w, g = _bf16_inputs(SHAPES[0], seed=3)
    leaves = [t.requires_grad_(True) for t in (x, w)]
    out = tconv.conv3x3_s1_nhwc(*leaves, torch.float32)
    assert out.dtype == torch.float32
    torch.autograd.grad(out, leaves, g.float())
    counts = kernels.launch_counts()
    assert {"conv3x3_fwd_bf16", "conv3x3_dx_bf16"} <= set(counts)
    assert set(counts.values()) == {0}


# -- the bfloat16 face's two paths --------------------------------------------
#
# (N, H, W, C, O), the path and tiling the face's forward takes on 132 SMs
# and its blocks: ResNet-50's stage shapes at batch 32 (the wgmma kernel,
# one block an SM, blocks for at least half the SMs), chip_smoke.py's
# edge shapes (C 3 and 36 take the ragged path at the float32 face's
# tiling), a dx of them (C and O swapped), and a shape whose rule reaches
# 64 x 128 (O 136: 128 x 64 would have 3 column blocks to 64 x 128's 2)
BF16_RULE_PICKS = [
    ((32, 56, 56, 64, 64), ("wgmma", (128, 64)), 784),
    ((32, 28, 28, 128, 128), ("wgmma", (128, 128)), 196),
    ((32, 14, 14, 256, 256), ("wgmma", (128, 128)), 98),
    ((32, 7, 7, 512, 512), ("wgmma", (128, 64)), 104),
    ((3, 7, 9, 24, 40), ("wgmma", (64, 64)), 3),
    ((2, 5, 6, 3, 7), ("ragged", (64, 64)), 1),
    ((2, 9, 11, 36, 64), ("ragged", (64, 64)), 4),
    ((2, 7, 7, 512, 512), ("wgmma", (64, 64)), 16),
    ((4, 95, 97, 64, 40), ("wgmma", (128, 64)), 288),
    ((16, 33, 33, 32, 200), ("wgmma", (128, 128)), 274),
    ((16, 33, 33, 200, 32), ("wgmma", (128, 64)), 137),
    ((2, 30, 40, 64, 136), ("wgmma", (64, 128)), 76),
]


@pytest.mark.parametrize("shape,want,blocks", BF16_RULE_PICKS)
def test_bf16_path_and_tiling_rule_picks(shape, want, blocks):
    N, H, W, C, O = shape
    path, (bm, bn) = tconv.tiling_bf16(*shape)
    assert (path, (bm, bn)) == want
    assert path == tconv.bf16_path(*shape)
    assert -(-N * H * W // bm) * -(-O // bn) == blocks
    if path == "ragged":
        assert (bm, bn) == tconv.tiling(*shape)
        return
    # the largest wgmma tiling within the rule's limits: BN <= max(64, O)
    # and blocks for half the SMs, or 64 x 64 where none has the blocks
    larger = tconv.TILINGS_BF16[:tconv.TILINGS_BF16.index((bm, bn))]
    for lbm, lbn in larger:
        assert lbn > max(64, O) or \
            -(-N * H * W // lbm) * -(-O // lbn) < tconv.H100_SMS // 2


@pytest.mark.parametrize("shape", [s for s, _, _ in BF16_RULE_PICKS])
def test_bf16_misaligned_operands_take_the_ragged_path(shape):
    assert tconv.tiling_bf16(*shape, aligned=False) == \
        ("ragged", tconv.tiling(*shape))


def test_bf16_tiling_rule_follows_the_sm_count():
    # twice the SMs: the deep stage has blocks for half of them only at
    # 64 x 64; half the SMs: it has them at 128 x 128
    assert tconv.tiling_bf16(32, 7, 7, 512, 512, sms=264) == \
        ("wgmma", (64, 64))
    assert tconv.tiling_bf16(32, 7, 7, 512, 512, sms=66) == \
        ("wgmma", (128, 128))
    assert tconv.tiling_bf16(32, 56, 56, 64, 64, sms=66) == \
        ("wgmma", (128, 64))


def test_bf16_wgmma_smem_bytes_is_four_stages_of_unpadded_boxes():
    for bm, bn in tconv.TILINGS_BF16:
        assert tconv.smem_bytes_wgmma(bm, bn) == \
            4 * (bm * 64 + 64 * bn) * 2 + 1024
    assert [tconv.smem_bytes_wgmma(*t) for t in tconv.TILINGS_BF16] == \
        [132096, 99328, 99328, 66560]
    # every tiling fits one block an SM (227 KB of shared memory)
    assert max(tconv.smem_bytes_wgmma(*t) for t in tconv.TILINGS_BF16) \
        <= 232448


def test_bf16_wgmma_mirror_matches_the_source():
    """The wgmma tilings, the stage depth, the ring, the shared memory and
    the rule (blocks for half the SMs) of csrc/conv3x3.cu are those the
    mirror computes with; the float32 face's are unchanged."""
    path = os.path.join(os.path.dirname(tconv.__file__), "csrc",
                        "conv3x3.cu")
    with open(path) as fh:
        src = fh.read()

    def ints(name):
        m = re.search(r"constexpr int %s(?:\[\w+\])? = \{?([\d, ]+)\}?;"
                      % name, src)
        return [int(v) for v in m.group(1).split(",")]

    assert list(zip(ints("TILING_W_BM"), ints("TILING_W_BN"))) == \
        list(tconv.TILINGS_BF16)
    assert ints("CK") == [64] and ints("RING_W") == [4]
    assert "SMEM_BYTES = RING_W * STAGE_BYTES + 1024" in src
    assert "STAGE_BYTES = (XS + WS) * (int)sizeof(bf16)" in src
    assert "XS = BM * CK" in src and "WS = CK * BN" in src
    rule = src[src.index("int pick_tiling_wgmma("):]
    rule = rule[:rule.index("\n}\n")]
    assert "want = (sm_count() + 1) / 2;" in rule
    assert "(O > 64 ? O : 64) && blocks >= want" in rule
    # the path rule, and the float32 face's rule and tilings as they were
    assert "C % 8 == 0 && O % 8 == 0 && aligned16(x) && aligned16(w) &&" \
        in src
    assert list(zip(ints("TILING_BM"), ints("TILING_BN"))) == \
        list(tconv.TILINGS) == [(128, 128), (128, 64), (64, 64)]
    assert "2LL * sm_count()" in src


def test_bf16_ragged_counters_are_kernel_counters():
    counts = kernels.launch_counts()
    for name, attr in (("conv3x3_fwd_bf16_ragged", "launches_bf16_ragged"),
                       ("conv3x3_dx_bf16_ragged",
                        "launches_dx_bf16_ragged")):
        assert kernels.KERNEL_COUNTERS[name] == (tconv, attr)
        assert name in counts
    setattr(tconv, "launches_bf16_ragged", 3)
    kernels.reset_launches()
    assert tconv.launches_bf16_ragged == 0


def test_float32_face_pins_unchanged():
    # the float32 face's tilings, rule and shared memory, as before the
    # bfloat16 face had its own
    assert tconv.TILINGS == ((128, 128), (128, 64), (64, 64))
    assert [tconv.smem_bytes(*t) for t in tconv.TILINGS] == \
        [107520, 82944, 55296]
    assert [tconv.tiling(*s) for s, _, _ in RULE_PICKS] == \
        [t for _, t, _ in RULE_PICKS]


@pytest.mark.parametrize("attr", ["pallas3x3", "conv"])
def test_a_convs_conv_impl_attr_routes_the_port_and_not_jax(attr, tmp_path,
                                                            monkeypatch):
    """ROADMAP Queue 3 #6 (deliberate): a conv2d op's own ``conv_impl``
    attr picks the port's lowering over ``FLAGS.conv_impl`` ("conv" in
    both packages here), so one program opts in without a process-wide
    flag; the JAX lowering reads the environment and the flag only. Both
    compute the same conv (1e-5)."""
    import paddle_tpu as jpt
    import paddle_tpu.kernels.conv3x3 as jconv
    from paddle_tpu import tune as jtune
    from paddle_tpu.core import unique_name as jun
    from paddle_tpu_torch import layers as tl
    from paddle_tpu_torch import tune as ttune
    from paddle_tpu_torch.core import ir as tir
    from paddle_tpu_torch.core import unique_name as tun
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.flags import FLAGS, flags_guard
    from paddle_tpu_torch.ops import nn_ops
    monkeypatch.delenv("PADDLE_TPU_CONV_IMPL", raising=False)
    calls = {"port": 0, "jax": 0}

    def spy(mod, key):
        real = getattr(mod, "conv3x3_s1_nhwc")

        def f(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, "conv3x3_s1_nhwc", f)

    spy(nn_ops.conv3x3, "port")
    spy(jconv, "jax")
    rng = np.random.RandomState(12)
    x = rng.rand(2, 4, 6, 6).astype(np.float32)
    outs = {}
    for pkg in ("jax", "port"):
        L = jpt.layers if pkg == "jax" else tl
        Program = jpt.Program if pkg == "jax" else tir.Program
        guard = jpt.program_guard if pkg == "jax" else tir.program_guard
        main, start = Program(), Program()
        with (jun if pkg == "jax" else tun).guard(), guard(main, start):
            img = L.data("img", shape=[4, 6, 6], dtype="float32")
            out = L.conv2d(img, num_filters=5, filter_size=3, padding=1)
        for op in main.global_block().ops:
            if op.type == "conv2d":
                op.attrs["conv_impl"] = attr
        if pkg == "jax":
            with jpt.flags_guard(tune_cache_dir=str(tmp_path / "j")), \
                    jpt.scope_guard(jpt.Scope()):
                jtune.clear_memory_cache()
                exe = jpt.Executor(jpt.CPUPlace())
                exe.run(start)
                w = {v.name: np.asarray(jpt.global_scope().find_var(v.name))
                     for v in main.all_parameters()}
                outs[pkg] = np.asarray(exe.run(main, feed={"img": x},
                                               fetch_list=[out])[0])
        else:
            with flags_guard(tune_cache_dir=str(tmp_path / "t")):
                ttune.clear_memory_cache()
                assert FLAGS.conv_impl == "conv"
                scope = Scope()
                for n, v in w.items():
                    scope.set_var(n, torch.from_numpy(v.copy()))
                outs[pkg] = Executor("cpu").run(
                    main, feed={"img": x}, fetch_list=[out], scope=scope)[0]
    assert calls == {"port": 1 if attr == "pallas3x3" else 0, "jax": 0}
    assert np.abs(outs["port"] - outs["jax"]).max() <= 1e-5
