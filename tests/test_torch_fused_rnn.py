"""The fused LSTM and GRU recurrences: the port's plain forwards and the
backward of its ``torch.autograd.Function`` wrappers against the JAX
package's ``fused_lstm`` / ``fused_gru`` (the Pallas kernels in
interpret mode on the CPU) and their custom vjps.

Inputs are made with numpy from a seed and handed to both packages, at
T 6, N 8, D 128 (the JAX kernels' lane width) with ragged masks.
Tolerances are those of the JAX package's own kernel tests
(``tests/test_fused_lstm.py``), float32 on both sides: 2e-5 on the
forward (sum orders of the D-term products differ, ~1e-7 a step, over 6
steps of a contracting recurrence), 2e-4 on the gradients (sums over
T * N rows into dW, and over 4D gate terms into each dh).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels.fused_gru import fused_gru as jax_fused_gru  # noqa: E402
from paddle_tpu.kernels.fused_lstm import fused_lstm as jax_fused_lstm  # noqa: E402
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import fused_gru as tgru  # noqa: E402
from paddle_tpu_torch.kernels import fused_lstm as tlstm  # noqa: E402

T, N, D = 6, 8, 128
FWD_TOL = 2e-5
GRAD_TOL = 2e-4


def _inputs(gates, seed, t=T, n=N, d=D, ragged=True):
    rng = np.random.RandomState(seed)
    xs = (rng.randn(t, n, gates * d) * 0.4).astype(np.float32)
    w = (rng.randn(d, gates * d) * 0.1).astype(np.float32)
    h0 = (rng.randn(n, d) * 0.2).astype(np.float32)
    c0 = (rng.randn(n, d) * 0.2).astype(np.float32)
    lens = rng.randint(1, t + 1, n) if ragged else np.full(n, t)
    mask = (np.arange(t)[:, None] < lens[None, :]).astype(np.float32)
    return xs, w, h0, c0, mask


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def test_lstm_reference_matches_jax_kernel():
    xs, w, h0, c0, mask = _inputs(4, 0)
    jh, jc = jax_fused_lstm(*(jnp.asarray(a) for a in (xs, w, h0, c0, mask)),
                            True)
    th, tc = tlstm.fused_lstm_reference(*_t(xs, w, h0, c0, mask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_lstm_wrapper_gradients_match_jax_vjp():
    xs, w, h0, c0, mask = _inputs(4, 1)
    rng = np.random.RandomState(11)
    th_w = rng.randn(T, N, D).astype(np.float32)
    tc_w = rng.randn(T, N, D).astype(np.float32)

    def jloss(*a):
        hs, cs = jax_fused_lstm(*a, jnp.asarray(mask), True)
        return jnp.sum(hs * th_w) + jnp.sum(cs * tc_w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (xs, w, h0, c0)))
    leaves = _t(xs, w, h0, c0, grad=True)
    hs, cs = tlstm.fused_lstm(*leaves, torch.tensor(mask))
    (torch.sum(hs * torch.tensor(th_w))
     + torch.sum(cs * torch.tensor(tc_w))).backward()
    for name, leaf, g in zip(("dxs", "dw", "dh0", "dc0"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_gru_reference_matches_jax_kernel():
    xs, w, h0, _, mask = _inputs(3, 2)
    want = jax_fused_gru(*(jnp.asarray(a) for a in (xs, w, h0, mask)), True)
    got = tgru.fused_gru_reference(*_t(xs, w, h0, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_gru_wrapper_gradients_match_jax_vjp():
    xs, w, h0, _, mask = _inputs(3, 3)
    tw = np.random.RandomState(12).randn(T, N, D).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(jax_fused_gru(*a, jnp.asarray(mask), True) * tw),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (xs, w, h0)))
    leaves = _t(xs, w, h0, grad=True)
    torch.sum(tgru.fused_gru(*leaves, torch.tensor(mask))
              * torch.tensor(tw)).backward()
    for name, leaf, g in zip(("dxs", "dw", "dh0"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_cpu_wrappers_take_the_plain_versions():
    xs, w, h0, c0, mask = _t(*_inputs(4, 4))
    kernels.reset_launches()
    hs, cs = tlstm.fused_lstm(xs, w, h0, c0, mask)
    hr, cr = tlstm.fused_lstm_reference(xs, w, h0, c0, mask)
    assert torch.equal(hs, hr) and torch.equal(cs, cr)
    gx, gw, gh0, _, gmask = _t(*_inputs(3, 5))
    assert torch.equal(tgru.fused_gru(gx, gw, gh0, gmask),
                       tgru.fused_gru_reference(gx, gw, gh0, gmask))
    counts = kernels.launch_counts()
    assert counts["fused_lstm"] == 0 and counts["fused_gru"] == 0
