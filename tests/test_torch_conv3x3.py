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
import os
import re

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
