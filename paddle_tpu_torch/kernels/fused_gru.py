"""The whole GRU recurrence of a ragged batch (counterpart of
``paddle_tpu/kernels/fused_gru.py``).

- :func:`fused_gru_reference` is the plain forward: the time loop of the
  JAX kernel's body, the state in float32.
- :func:`fused_gru_bwd` is the backward of the JAX package's custom vjp
  (``_bwd``, a plain reversed scan that recomputes the gates from the
  saved h), in plain PyTorch on both devices. The gates of all steps are
  recomputed in two products up front, the reversed loop carries dh, and
  dW is two products of the stacked gradients with the previous states
  and with ``r * h`` (see ``fused_lstm.py`` for why nothing ``[D, 3D]``
  is stacked).
- :func:`fused_gru` is the wrapper, a ``torch.autograd.Function``. A CPU
  tensor gets the plain forward. A CUDA tensor gets the hand-written
  kernel of ``csrc/fused_gru.cu`` or an exception, never the plain
  version; float32 only, D a multiple of 4 up to 16 units a block on
  every SM (2112 on an H100).
- ``launches`` counts the kernel's launches; :func:`launch_plan` reports
  the launch shape a batch gets.

The kernel replaces the JAX package's Pallas kernel
(``paddle_tpu/kernels/fused_gru.py``, ``_forward``). It is one persistent
cooperative launch for all T steps (``csrc/recurrence.cuh`` holds what it
shares with the LSTM's kernel); a block owns 8 units of a share of
the rows (at D 512, N 64: 64 unit groups times 2 row groups of 32 rows,
128 blocks), or 16 units, two groups read in turn with W from global
memory, where the groups of 8 outnumber the SMs. Its products run on the tensor cores in 3xTF32
(``csrc/tf32x3.cuh``), float32-exact, with W split into hi and lo once
and kept in shared memory; the K reduction is split across the block's
8 warps and summed in a fixed order, so a relaunch is bit-identical. The
bound at T 100, N 64, D 512 is 0.0610 ms of 3xTF32 operations, but the
serial chain sets the time: a step is two phases with a grid barrier (a
release add and an acquire spin) after each, 2T - 1 in all, and each
phase stages all D columns of the block's rows of h (or r * h) with
``cp.async`` (64 KB a block a phase at N 64).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_lstm import max_units, plan

__all__ = ["fused_gru", "fused_gru_bwd", "fused_gru_reference",
           "launch_plan", "launches"]

# kernel launches since the last reset
launches = 0

_NAME = "fused_gru"


def fused_gru_reference(xs, w, h0, mask):
    """Plain forward: the JAX kernel's step, T times."""
    D = w.shape[0]
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    h = h0
    hs = []
    for t in range(xs.shape[0]):
        x = xs[t]
        ur = torch.sigmoid(x[:, :2 * D] + h @ w_ur)
        u, r = ur[:, :D], ur[:, D:]
        cand = torch.tanh(x[:, 2 * D:] + (r * h) @ w_c)
        h_new = (1.0 - u) * h + u * cand
        m = mask[t].to(h.dtype)[:, None]
        h = h_new * m + h * (1.0 - m)
        hs.append(h)
    return torch.stack(hs)


def fused_gru_bwd(xs, w, h0, mask, hs, dhs):
    """``(dxs, dw, dh0)`` of the forward at its saved output, the JAX
    ``_bwd`` recurrence."""
    T, N, _ = xs.shape
    D = w.shape[0]
    w_ur, w_c = w[:, :2 * D], w[:, 2 * D:]
    hprev = torch.cat([h0[None], hs[:-1]], dim=0)
    # every step's gates, recomputed from the saved states in two products
    ur = torch.sigmoid(xs[..., :2 * D] + (hprev.reshape(T * N, D) @ w_ur)
                       .reshape(T, N, 2 * D))
    u, r = ur[..., :D], ur[..., D:]
    rh = r * hprev
    cand = torch.tanh(xs[..., 2 * D:] + (rh.reshape(T * N, D) @ w_c)
                      .reshape(T, N, D))
    m = mask.to(xs.dtype)[..., None]
    dxs = torch.empty_like(xs)
    dh = torch.zeros_like(h0)
    w_urt, w_ct = w_ur.t(), w_c.t()
    for t in range(T - 1, -1, -1):
        dh_t = dh + dhs[t]
        dh_new = dh_t * m[t]
        dx = dxs[t]
        dct = dh_new * u[t] * (1.0 - cand[t] * cand[t])
        dx[:, 2 * D:] = dct
        drh = dct @ w_ct
        dx[:, :D] = dh_new * (cand[t] - hprev[t]) * u[t] * (1.0 - u[t])
        dx[:, D:2 * D] = drh * hprev[t] * r[t] * (1.0 - r[t])
        dh = (dh_t * (1.0 - m[t]) + dh_new * (1.0 - u[t]) + drh * r[t]
              + dx[:, :2 * D] @ w_urt)
    dw = torch.cat([hprev.reshape(T * N, D).t()
                    @ dxs[..., :2 * D].reshape(T * N, 2 * D),
                    rh.reshape(T * N, D).t()
                    @ dxs[..., 2 * D:].reshape(T * N, D)], dim=1)
    return dxs, dw, dh


def _check(xs, w, h0, mask):
    if xs.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, xs.device))
    T, N, D3 = xs.shape
    D = w.shape[0]
    if (D3 != 3 * D or tuple(w.shape) != (D, 3 * D)
            or tuple(h0.shape) != (N, D) or tuple(mask.shape) != (T, N)):
        raise ValueError("%s: the kernel takes xs [T, N, 3D], w [D, 3D], "
                         "h0 [N, D] and mask [T, N], got %s"
                         % (_NAME, [tuple(t.shape)
                                    for t in (xs, w, h0, mask)]))
    if D % 4:
        raise ValueError("%s: the kernel takes D a multiple of 4, got %d"
                         % (_NAME, D))
    for name, t in (("xs", xs), ("w", w), ("h0", h0), ("mask", mask)):
        if t.dtype != torch.float32:
            raise ValueError("%s: the kernel takes float32 operands, %s is "
                             "%s" % (_NAME, name, t.dtype))
    _build.check_cuda_operands(_NAME, xs.device, xs=xs, w=w, h0=h0,
                               mask=mask)
    limit = max_units(xs.device)
    if D > limit:
        raise ValueError("%s: the kernel takes D up to 16 units an SM, %d "
                         "on this card, got %d" % (_NAME, limit, D))


def launch_plan(N, D):
    """The launch shape of this kernel for N rows of D units
    (``fused_lstm.PLAN_FIELDS``)."""
    return plan(_NAME, N, D)


def _launch(xs, w, h0, mask):
    """One launch of the kernel on checked operands; returns hs."""
    T, N, _ = xs.shape
    D = w.shape[0]
    hs = torch.empty((T, N, D), dtype=torch.float32, device=xs.device)
    rh = torch.empty((N, D), dtype=torch.float32, device=xs.device)
    barrier = torch.empty((1,), dtype=torch.int32, device=xs.device)
    lib = _build.load(_NAME)
    fn = lib.fused_gru_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(xs.data_ptr(), w.data_ptr(), h0.data_ptr(), mask.data_ptr(),
              hs.data_ptr(), rh.data_ptr(), barrier.data_ptr(), T, N, D,
              _build.stream_handle(xs.device))
    _build.check(lib, code, _NAME)
    return hs


def _forward(xs, w, h0, mask):
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    global launches
    if xs.device.type == "cpu":
        return fused_gru_reference(xs, w, h0, mask)
    xs, w, h0, mask = (t.contiguous() for t in (xs, w, h0, mask))
    _check(xs, w, h0, mask)
    if xs.shape[0] == 0 or xs.shape[1] == 0:
        return xs.new_zeros(xs.shape[:2] + (w.shape[0],))
    out = _launch(xs, w, h0, mask)
    launches += 1
    return out


class _FusedGRU(torch.autograd.Function):
    """The forward kernel with the backward of the JAX custom vjp."""

    @staticmethod
    def forward(ctx, xs, w, h0, mask):
        hs = _forward(xs, w, h0, mask)
        ctx.save_for_backward(xs, w, h0, mask, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        xs, w, h0, mask, hs = ctx.saved_tensors
        dxs, dw, dh0 = fused_gru_bwd(xs, w, h0, mask, hs, dhs)
        return dxs, dw, dh0, None


def fused_gru(xs, w, h0, mask):
    """hs of the GRU recurrence, differentiable in xs, w and h0. On CUDA:
    float32, shapes as in the module docstring, D a multiple of 4 up to
    :func:`fused_lstm.max_units` (two unit groups of 8 a block, one
    block an SM); anything else raises before the launch."""
    return _FusedGRU.apply(xs, w, h0, mask)
