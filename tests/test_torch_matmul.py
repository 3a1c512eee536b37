"""The blocked matmul: the port's plain version and its
``torch.autograd.Function`` wrapper against the JAX package's ``matmul``
(the Pallas kernel in interpret mode on the CPU) and its custom vjp, the
population gate and the tiling normaliser. The CUDA kernel is held
against its plain version on the card by ``test_torch_matmul_cuda.py``.

Operands are made with numpy from a seed and handed to both packages.
Tolerance: 1e-5 of the largest magnitude of the JAX output, float32 on
both sides; the Pallas kernel sums its k blocks of ``jnp.dot`` and the
plain version its k tiles of ``torch.matmul``, in other orders, which
moves outputs of size ~1-10 by ~1e-6 (K <= 384 here).
"""
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.matmul import (  # noqa: E402
    matmul as jax_matmul, supports_matmul as jax_supports)
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import matmul as tmm  # noqa: E402

TOL = 1e-5
# (M, K, N): inside the population (M % 8, K % 128, N % 128) and outside
SHAPES = [(64, 256, 128), (24, 384, 256), (8, 128, 384), (10, 100, 30),
          (33, 70, 129)]
# tilings of the JAX kernel (0 = full extent; a block that does not
# divide falls back to the full extent there)
JAX_TILINGS = [None, {"block_m": 8, "block_n": 128, "block_k": 128}]
# tilings of the port's kernel (the plain version's k-tile order)
PORT_TILINGS = [None, {"block_m": 64, "block_n": 128, "block_k": 32}]
# the same of the bfloat16 face, whose tilings sum 64-deep k tiles
JAX_TILINGS_BF16 = [None, {"block_m": 8, "block_n": 128, "block_k": 64}]
PORT_TILINGS_BF16 = [None, {"block_m": 64, "block_n": 192, "block_k": 64}]


def _inputs(shape, seed):
    M, K, N = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.1).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    return x, w, g


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tilings", list(zip(JAX_TILINGS, PORT_TILINGS)),
                         ids=["default", "blocked"])
def test_reference_matches_jax_kernel(shape, tilings):
    jax_cfg, port_cfg = tilings
    x, w, _ = _inputs(shape, seed=sum(shape))
    want = jax_matmul(jnp.asarray(x), jnp.asarray(w), None, jax_cfg)
    got = tmm.matmul_reference(torch.from_numpy(x), torch.from_numpy(w),
                               port_cfg)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_wrapper_backward_matches_jax_vjp(shape):
    x, w, g = _inputs(shape, seed=sum(shape) + 1)
    cfg = {"block_m": 8, "block_n": 128, "block_k": 128}
    out, vjp = jax.vjp(lambda a, b: jax_matmul(a, b, None, cfg),
                       jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tmm.matmul(xt, wt, config={"block_k": 16})
    _close(got, out)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
    _close(dx, want_dx)
    _close(dw, want_dw)


SUPPORT_GRID = [(m, k, n) for m in (8, 12, 64, 8192) for k in (64, 128, 768)
                for n in (100, 128, 3072, 50257)]


@pytest.mark.parametrize("shape", SUPPORT_GRID)
def test_supports_the_same_float32_population_as_jax(shape):
    m, k, n = shape
    assert tmm.supports_matmul((m, k), (k, n), torch.float32) == \
        jax_supports((m, k), (k, n), "float32")
    # the dtype may come as a torch dtype or as a name
    assert tmm.supports_matmul((m, k), (k, n), "float32") == \
        tmm.supports_matmul((m, k), (k, n), torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int32"])
def test_population_agrees_with_jax_on_every_dtype(dtype):
    # the bfloat16 face (AMP) closed the one difference: both packages
    # take float32 and bfloat16 gemms of the aligned shapes, and nothing
    # else
    grid = [((m, k), (k, n)) for m, k, n in SUPPORT_GRID]
    want = [jax_supports(a, b, dtype) for a, b in grid]
    assert [tmm.supports_matmul(a, b, dtype) for a, b in grid] == want
    if dtype in ("float32", "bfloat16"):
        assert [tmm.supports_matmul(a, b, getattr(torch, dtype))
                for a, b in grid] == want
        assert sum(want) == 12    # M % 8, K % 128, N % 128 of the grid
    else:
        assert not any(want)
    # rank and K agreement as in the JAX gate
    assert not tmm.supports_matmul((2, 64, 128), (256, 128), dtype)
    assert not tmm.supports_matmul((64, 128), (256, 128), dtype)


def test_normalize_config_maps_uncompiled_tilings_to_the_default():
    default = (tmm.DEFAULT_CONFIG["block_m"], tmm.DEFAULT_CONFIG["block_n"],
               tmm.DEFAULT_CONFIG["block_k"])
    assert default in tmm.TILINGS and len(tmm.TILINGS) == 12
    assert tmm.normalize_config() == default
    assert tmm.normalize_config(
        {"block_m": 64, "block_n": 128, "block_k": 32}) == (64, 128, 32)
    # a partial config takes the rest from the default
    assert tmm.normalize_config({"block_k": 16}) == default[:2] + (16,)
    # a JAX tiling (0 = full extent) or any other stale entry: the default
    for stale in ({"block_m": 0, "block_n": 0, "block_k": 0},
                  {"block_m": 256, "block_n": 128, "block_k": 8},
                  {"block_m": "x"}):
        assert tmm.normalize_config(stale) == default
    # the plain version of a stale tiling sums in the default's k order
    x, w, _ = _inputs((16, 256, 128), seed=2)
    a = tmm.matmul_reference(torch.from_numpy(x), torch.from_numpy(w),
                             {"block_k": 7})
    b = tmm.matmul_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(a, b)


def test_smem_bytes_of_every_tiling_fits_a_block():
    for t in tmm.TILINGS:
        assert 0 < tmm.smem_bytes(*t) <= 227 * 1024
    assert tmm.smem_bytes(128, 128, 8) == 3 * (128 * 12 + 8 * 136) * 4


def test_cpu_call_counts_no_launch():
    kernels.reset_launches()
    x, w, _ = (torch.from_numpy(a) for a in _inputs((16, 128, 128), 3))
    tmm.matmul(x, w, config={"block_m": 64, "block_n": 64, "block_k": 8})
    counts = kernels.launch_counts()
    assert "matmul" in counts and counts["matmul"] == 0


# -- the bfloat16 face (AMP) --------------------------------------------------
#
# bfloat16 operands, float32 sums (each product exact), written in
# bfloat16 (the kernel's ``x.dtype``) or float32. Tolerances: a bfloat16
# output within one bfloat16 ulp of the largest magnitude of the JAX
# output (both round an exact float32 sum, in other orders, once); a
# float32 output within 1e-5 of the largest magnitude, as above.

BF16 = np.dtype(ml_dtypes.bfloat16)


def _bf16_ulp(m):
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _close_bf16(got, want):
    want = np.asarray(want)
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    w = want.astype(np.float64)
    err = float(np.abs(got.double().numpy() - w).max())
    assert err <= _bf16_ulp(float(np.abs(w).max())), err


def _bf16_inputs(shape, seed):
    return [torch.from_numpy(a).bfloat16() for a in _inputs(shape, seed)]


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("out_dtype", [None, torch.float32],
                         ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("tilings",
                         list(zip(JAX_TILINGS_BF16, PORT_TILINGS_BF16)),
                         ids=["default", "blocked"])
def test_bf16_reference_matches_jax_kernel(shape, tilings, out_dtype):
    jax_cfg, port_cfg = tilings
    x, w, _ = _bf16_inputs(shape, seed=sum(shape) + 3)
    want = jax_matmul(_jnp(x), _jnp(w),
                      None if out_dtype is None else jnp.float32, jax_cfg)
    got = tmm.matmul_reference(x, w, port_cfg, out_dtype)
    assert got.dtype == (out_dtype or torch.bfloat16)
    if out_dtype is None:
        _close_bf16(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_bf16_wrapper_matches_jax_and_its_vjp(shape):
    # the forward is the face, written in bfloat16; the backward the two
    # float32 products of the JAX custom vjp, rounded to the operands'
    # dtype
    x, w, g = _bf16_inputs(shape, seed=sum(shape) + 4)
    cfg = {"block_m": 8, "block_n": 128, "block_k": 128}
    out, vjp = jax.vjp(lambda a, b: jax_matmul(a, b, None, cfg),
                       _jnp(x), _jnp(w))
    want_dx, want_dw = vjp(_jnp(g))
    xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = tmm.matmul(xt, wt, config={"block_m": 64})
    _close_bf16(got.detach(), out)
    dx, dw = torch.autograd.grad(got, (xt, wt), g)
    _close_bf16(dx, want_dx)
    _close_bf16(dw, want_dw)


def test_bf16_k_tile_partial_sums_miss_the_tolerance():
    # rounding the sum to bfloat16 after each 64-deep k tile (a kernel
    # whose scratch were bfloat16) is several ulps off at K 3072 (48
    # tiles)
    x, w, _ = _bf16_inputs((64, 3072, 128), seed=11)
    want = np.asarray(jax_matmul(_jnp(x), _jnp(w)))
    acc = None
    for k0 in range(0, 3072, 64):
        t = torch.matmul(x[:, k0:k0 + 64].float(), w[k0:k0 + 64].float())
        acc = (t if acc is None else acc.float() + t).bfloat16()
    with pytest.raises(AssertionError):
        _close_bf16(acc, want)
    _close_bf16(tmm.matmul_reference(x, w), want)


def test_bf16_smem_bytes_of_every_tiling_fits_a_block():
    # the wgmma kernel: a ring of four stages of the x box (bm x 64) and
    # the w boxes (64 x bn), and 1024 bytes to align it for the swizzle
    for t in tmm.TILINGS_BF16:
        assert 0 < tmm.smem_bytes(*t, torch.bfloat16) <= 227 * 1024
        assert tmm.smem_bytes(*t, "bfloat16") == \
            4 * (t[0] * t[2] + t[2] * t[1]) * 2 + 1024
    assert tmm.smem_bytes(128, 128, 64, "bfloat16") == 132096
    assert tmm.smem_bytes(64, 192, 64, "bfloat16") == 132096
    # the ragged path's one tiling keeps its three padded stages
    assert tmm.smem_bytes(*tmm.RAGGED_TILING, "bfloat16") == 56832


def test_bf16_tilings_are_the_wgmma_kernels_instantiations():
    # one or two consumer warpgroups of 64 rows, a wgmma width the
    # registers hold twice (the stage's sum and the running one), one
    # 128-byte swizzled row of bfloat16 a k step
    assert len(tmm.TILINGS_BF16) <= 12
    assert tmm.normalize_config(None, torch.bfloat16) == (128, 128, 64)
    for bm, bn, bk in tmm.TILINGS_BF16:
        assert bm in (64, 128) and bn in (64, 128, 192) and bk == 64
    # two accumulators of bn / 2 registers: 128 x 192 spills at the 168
    # registers its 384 threads compile with
    assert (128, 192, 64) not in tmm.TILINGS_BF16
    assert tmm.RAGGED_TILING not in tmm.TILINGS_BF16
    assert tmm.tilings("bfloat16") == tmm.TILINGS_BF16
    assert tmm.tilings(torch.float32) == tmm.TILINGS
    assert tmm.default_config(torch.bfloat16) == tmm.DEFAULT_CONFIG_BF16
    assert tmm.default_config("float32") == tmm.DEFAULT_CONFIG


@pytest.mark.parametrize("dtype", [torch.bfloat16, "bfloat16"])
def test_normalize_config_is_dtype_aware(dtype):
    default = (128, 128, 64)
    assert tmm.normalize_config(None, dtype) == default
    assert tmm.normalize_config(
        {"block_m": 64, "block_n": 192, "block_k": 64}, dtype) == \
        (64, 192, 64)
    # a partial config takes the rest from the bfloat16 default
    assert tmm.normalize_config({"block_n": 64}, dtype) == (128, 64, 64)
    # stale entries degrade to the bfloat16 default: a triple of the
    # face before its wgmma kernel (128 x 128 x 32, 64 x 64 x 8), a
    # float32 one, the ragged path's, a JAX tiling, garbage
    for stale in ({"block_m": 128, "block_n": 128, "block_k": 32},
                  {"block_m": 64, "block_n": 64, "block_k": 8},
                  dict(tmm.DEFAULT_CONFIG),
                  dict(zip(("block_m", "block_n", "block_k"),
                           tmm.RAGGED_TILING)),
                  {"block_m": 0, "block_n": 0, "block_k": 0},
                  {"block_k": "x"}):
        assert tmm.normalize_config(stale, dtype) == default
    # and a bfloat16 tiling is stale for the float32 face
    assert tmm.normalize_config({"block_m": 64, "block_n": 192,
                                 "block_k": 64}) == (128, 128, 8)
    # the plain version of a stale bfloat16 tiling sums in the default's
    # k order
    x, w, _ = _bf16_inputs((16, 256, 128), seed=5)
    assert torch.equal(tmm.matmul_reference(x, w, {"block_k": 32}),
                       tmm.matmul_reference(x, w))


def test_bf16_cpu_call_counts_no_launch():
    kernels.reset_launches()
    x, w, _ = _bf16_inputs((16, 128, 128), 3)
    assert tmm.matmul(x, w).dtype == torch.bfloat16
    assert tmm.matmul(x, w, torch.float32).dtype == torch.float32
    counts = kernels.launch_counts()
    assert counts["matmul"] == counts["matmul_bf16"] == 0
    assert counts["matmul_bf16_ragged"] == 0
    assert kernels.KERNEL_COUNTERS["matmul_bf16_ragged"] == (
        tmm, "launches_bf16_ragged")
