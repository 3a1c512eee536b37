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

The LSTM also on bfloat16 xs, h0 and c0 with float32 w and mask (pure
AMP's bias-free LSTM): both packages compute in float32 and round each
bfloat16 output once, so a bfloat16 output must lie within one bfloat16
ulp of the JAX output's own magnitude (float32 noise may put a value
near a rounding boundary on the other side; an element the JAX side
gives as 0 must be 0), and dW, a float32 sum over T * N rows, within
1e-5 of max(1, its largest magnitude). Nothing on these paths rounds an
intermediate to bfloat16 (the operands widen exactly, and the outputs
are bfloat16 arrays), so XLA:CPU's excess precision cannot move the JAX
side and it runs in this process.
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


def _bf16(*arrays):
    """numpy float32 arrays as torch bfloat16 tensors (rounded to nearest
    even) and their exact values as JAX bfloat16 arrays."""
    ts = [torch.tensor(a).bfloat16() for a in arrays]
    return ts, [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                for t in ts]


def _assert_within_own_ulp(name, got, want):
    """``got`` (torch bfloat16) against ``want`` (JAX bfloat16): the same
    shape and dtype, each element within one bfloat16 ulp of want's own
    magnitude."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, \
        (name, got.dtype, want.dtype)
    g = got.double().numpy()
    w = np.asarray(want.astype(jnp.float32), np.float64)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    mag = np.abs(w)
    ulp = np.where(mag > 0, np.exp2(np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 0.0)
    err = np.abs(g - w)
    assert np.all(err <= ulp), (name, float((err - ulp).max()),
                                int((err > ulp).sum()))


def test_lstm_reference_on_bfloat16_matches_jax_kernel():
    xs, w, h0, c0, mask = _inputs(4, 16)
    (txs, th0, tc0), (jxs, jh0, jc0) = _bf16(xs, h0, c0)
    jh, jc = jax_fused_lstm(jxs, jnp.asarray(w), jh0, jc0, jnp.asarray(mask),
                            True)
    th, tc = tlstm.fused_lstm_reference(txs, torch.tensor(w), th0, tc0,
                                        torch.tensor(mask))
    _assert_within_own_ulp("hs", th, jh)
    _assert_within_own_ulp("cs", tc, jc)


def test_lstm_backward_on_bfloat16_matches_jax_vjp():
    xs, w, h0, c0, mask = _inputs(4, 17)
    rng = np.random.RandomState(18)
    dhs, dcs = (rng.randn(T, N, D).astype(np.float32) for _ in range(2))
    (txs, th0, tc0, tdhs, tdcs), (jxs, jh0, jc0, jdhs, jdcs) = _bf16(
        xs, h0, c0, dhs, dcs)
    jw, jmask = jnp.asarray(w), jnp.asarray(mask)
    (jh, jc), vjp = jax.vjp(
        lambda *a: jax_fused_lstm(*a, jmask, True), jxs, jw, jh0, jc0)
    want = vjp((jdhs, jdcs))
    # the backward at the JAX forward's saved (rounded) states
    saved = [torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()
             for a in (jh, jc)]
    got = tlstm.fused_lstm_bwd(txs, torch.tensor(w), th0, tc0,
                               torch.tensor(mask), *saved, tdhs, tdcs)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    assert [g.dtype for g in want] == [jnp.bfloat16, jnp.float32,
                                       jnp.bfloat16, jnp.bfloat16]
    for name, g, wnt in zip(("dxs", "dh0", "dc0"), (got[0], got[2], got[3]),
                            (want[0], want[2], want[3])):
        _assert_within_own_ulp(name, g, wnt)
    dw = np.asarray(want[1])
    np.testing.assert_allclose(got[1].numpy(), dw, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(dw).max())))
    # through the wrapper, each leaf's gradient takes its dtype
    leaves = [t.clone().requires_grad_(True) for t in
              (txs, torch.tensor(w), th0, tc0)]
    hs, cs = tlstm.fused_lstm(*leaves, torch.tensor(mask))
    assert hs.dtype == cs.dtype == torch.bfloat16
    torch.autograd.backward((hs, cs), (tdhs, tdcs))
    assert [leaf.grad.dtype for leaf in leaves] == [
        torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16]


def test_lstm_plain_versions_on_float32_are_unchanged():
    # the float32 plain forward and backward compute in float32 exactly
    # as before the bfloat16 face: no cast on the way
    xs, w, h0, c0, mask = _t(*_inputs(4, 19))
    hs, cs = tlstm.fused_lstm_reference(xs, w, h0, c0, mask)
    h, c, rows = h0, c0, []
    for t in range(T):
        g = xs[t] + h @ w
        cand, i, f, o = (torch.tanh(g[:, :D]), torch.sigmoid(g[:, D:2 * D]),
                         torch.sigmoid(g[:, 2 * D:3 * D]),
                         torch.sigmoid(g[:, 3 * D:]))
        c_new = f * c + i * cand
        m = mask[t][:, None]
        h = o * torch.tanh(c_new) * m + h * (1.0 - m)
        c = c_new * m + c * (1.0 - m)
        rows.append((h, c))
    assert torch.equal(hs, torch.stack([r[0] for r in rows]))
    assert torch.equal(cs, torch.stack([r[1] for r in rows]))
    grads = tlstm.fused_lstm_bwd(xs, w, h0, c0, mask, hs, cs,
                                 torch.ones_like(hs), torch.ones_like(cs))
    assert all(g.dtype == torch.float32 for g in grads)


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
    hb, cb = tlstm.fused_lstm(xs.bfloat16(), w, h0.bfloat16(), c0.bfloat16(),
                              mask)
    hr, cr = tlstm.fused_lstm_reference(xs.bfloat16(), w, h0.bfloat16(),
                                        c0.bfloat16(), mask)
    assert torch.equal(hb, hr) and torch.equal(cb, cr)
    counts = kernels.launch_counts()
    assert counts["fused_lstm"] == 0 and counts["fused_gru"] == 0
    assert counts["fused_lstm_bf16"] == 0
