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


def test_population_differs_from_jax_only_on_bfloat16():
    shape_x, shape_y = (64, 256), (256, 128)
    assert jax_supports(shape_x, shape_y, "bfloat16")
    assert not tmm.supports_matmul(shape_x, shape_y, torch.bfloat16)
    for dt in ("float16", "int32"):
        assert not tmm.supports_matmul(shape_x, shape_y, dt)
        assert not jax_supports(shape_x, shape_y, dt)
    # rank and K agreement as in the JAX gate
    assert not tmm.supports_matmul((2, 64, 128), shape_y, torch.float32)
    assert not tmm.supports_matmul((64, 128), shape_y, torch.float32)


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
