"""The whole LSTM recurrence of a ragged batch (counterpart of
``paddle_tpu/kernels/fused_lstm.py``).

- :func:`fused_lstm_reference` is the plain forward: the time loop of
  the JAX kernel's body, one ``[N, D] @ [D, 4D]`` product and the gate
  arithmetic a step, the state in float32.
- :func:`fused_lstm_bwd` is the backward of the JAX package's custom vjp
  (``_bwd``, a plain reversed scan that recomputes the gates from the
  saved h/c), in plain PyTorch on both devices: the JAX backward is no
  Pallas kernel either. The gate pre-activations of all steps are
  recomputed in one product up front, the reversed loop carries dh and
  dc, and dW is one product of the previous states with the stacked gate
  gradients (which are the gradient of ``xs``), so no per-step ``[D, 4D]``
  term is ever stacked (the memory concern of ``fused_lstm.py:151-153``).
- :func:`fused_lstm` is the wrapper, a ``torch.autograd.Function``. A CPU
  tensor gets the plain forward. A CUDA tensor gets the hand-written
  kernel of ``csrc/fused_lstm.cu`` or an exception, never the plain
  version; float32 only, D a multiple of 4 up to 16 units a block on
  every SM (2112 on an H100).
- ``launches`` counts the kernel's launches; :func:`launch_plan` reports
  the launch shape (blocks, units a block, rows a piece, shared memory)
  a batch gets; :func:`plan` does so for either recurrence's kernel.

The kernel replaces the JAX package's Pallas kernel
(``paddle_tpu/kernels/fused_lstm.py``, ``_forward``). It is one
persistent cooperative launch for all T steps, with the GRU kernel's
design (``csrc/recurrence.cuh`` holds what the two share): a block owns
all four gates of 8 units of a share of the rows (at D 512, N 64: 64
unit groups times 2 row groups of 32 rows, 128 blocks), or 16 units, two
groups read in turn with W from global memory, where the groups of 8
outnumber the SMs; rows past a launch's row groups go in pieces of at
most 32 rows, each through all T steps. Its products run on the tensor
cores in 3xTF32 (``csrc/tf32x3.cuh``), float32-exact, with W split into
hi and lo once and kept in shared memory (kept as floats and split at
each load where the split form leaves too little room for the rows a
block needs, as at D 1024); the K reduction is split across the block's 8 warps and summed in
a fixed order, so a relaunch is bit-identical. The bound at T 100, N 64,
D 512 is 0.0813 ms of 3xTF32 operations, but the serial chain sets the
time: a step stages all D columns of the block's rows of h with
``cp.async`` (64 KB a block at N 64), multiplies them by the block's 32
columns of W, and ends at a grid barrier (a release add and an acquire
spin), T - 1 in all; h and c stay in registers between steps.

Layout: xs ``[T, N, 4D]`` pre-projected gate input (bias folded in), gate
slabs (c~, i, f, o); w ``[D, 4D]``; h0, c0 ``[N, D]``; mask ``[T, N]``
(1 inside the sequence). Returns ``(hs, cs)``, each ``[T, N, D]``; a
masked step carries the previous state through.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["PLAN_FIELDS", "fused_lstm", "fused_lstm_bwd",
           "fused_lstm_reference", "launch_plan", "launches", "plan"]

# kernel launches since the last reset
launches = 0
# what launch_plan reports about a launch shape
PLAN_FIELDS = ("blocks", "units_per_block", "rows_per_piece",
               "shared_bytes", "threads", "blocks_per_sm", "sms")

_NAME = "fused_lstm"


def _gates(g, D):
    """(c~, i, f, o) activations of the pre-activations ``g [.., 4D]``."""
    return (torch.tanh(g[..., :D]), torch.sigmoid(g[..., D:2 * D]),
            torch.sigmoid(g[..., 2 * D:3 * D]), torch.sigmoid(g[..., 3 * D:]))


def fused_lstm_reference(xs, w, h0, c0, mask):
    """Plain forward: the JAX kernel's step, T times."""
    D = w.shape[0]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(xs.shape[0]):
        cand, i, f, o = _gates(xs[t] + h @ w, D)
        c_new = f * c + i * cand
        h_new = o * torch.tanh(c_new)
        m = mask[t].to(h.dtype)[:, None]
        h = h_new * m + h * (1.0 - m)
        c = c_new * m + c * (1.0 - m)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs), torch.stack(cs)


def fused_lstm_bwd(xs, w, h0, c0, mask, hs, cs, dhs, dcs):
    """``(dxs, dw, dh0, dc0)`` of the forward at its saved outputs, the
    JAX ``_bwd`` recurrence."""
    T, N, _ = xs.shape
    D = w.shape[0]
    hprev = torch.cat([h0[None], hs[:-1]], dim=0)
    cprev = torch.cat([c0[None], cs[:-1]], dim=0)
    # every step's gates, recomputed from the saved states in one product
    cand, i, f, o = _gates(xs + (hprev.reshape(T * N, D) @ w)
                           .reshape(T, N, 4 * D), D)
    tanh_c = torch.tanh(f * cprev + i * cand)
    m = mask.to(xs.dtype)[..., None]
    dgs = torch.empty_like(xs)
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    wt = w.t()
    for t in range(T - 1, -1, -1):
        dh_t = dh + dhs[t]
        dc_t = dc + dcs[t]
        dh_new = dh_t * m[t]
        dc_new = dc_t * m[t] + dh_new * o[t] * (1.0 - tanh_c[t] * tanh_c[t])
        dg = dgs[t]
        dg[:, :D] = dc_new * i[t] * (1.0 - cand[t] * cand[t])
        dg[:, D:2 * D] = dc_new * cand[t] * i[t] * (1.0 - i[t])
        dg[:, 2 * D:3 * D] = dc_new * cprev[t] * f[t] * (1.0 - f[t])
        dg[:, 3 * D:] = dh_new * tanh_c[t] * o[t] * (1.0 - o[t])
        dh = dh_t * (1.0 - m[t]) + dg @ wt
        dc = dc_new * f[t] + dc_t * (1.0 - m[t])
    dw = hprev.reshape(T * N, D).t() @ dgs.reshape(T * N, 4 * D)
    return dgs, dw, dh, dc


def _check(xs, w, h0, c0, mask):
    if xs.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, xs.device))
    T, N, D4 = xs.shape
    D = w.shape[0]
    if (D4 != 4 * D or tuple(w.shape) != (D, 4 * D)
            or tuple(h0.shape) != (N, D) or tuple(c0.shape) != (N, D)
            or tuple(mask.shape) != (T, N)):
        raise ValueError("%s: the kernel takes xs [T, N, 4D], w [D, 4D], "
                         "h0/c0 [N, D] and mask [T, N], got %s"
                         % (_NAME, [tuple(t.shape)
                                    for t in (xs, w, h0, c0, mask)]))
    if D % 4:
        raise ValueError("%s: the kernel takes D a multiple of 4, got %d"
                         % (_NAME, D))
    for name, t in (("xs", xs), ("w", w), ("h0", h0), ("c0", c0),
                    ("mask", mask)):
        if t.dtype != torch.float32:
            raise ValueError("%s: the kernel takes float32 operands, %s is "
                             "%s" % (_NAME, name, t.dtype))
    _build.check_cuda_operands(_NAME, xs.device, xs=xs, w=w, h0=h0, c0=c0,
                               mask=mask)


def plan(name, N, D):
    """{PLAN_FIELDS: int} of the ``csrc/<name>.cu`` kernel's launch for N
    rows of D units on the current CUDA device (the kernel is not
    launched); raises where the shape cannot run."""
    lib = _build.load(name)
    fn = getattr(lib, name + "_plan")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * len(PLAN_FIELDS))()
    _build.check(lib, fn(N, D, info), name)
    return dict(zip(PLAN_FIELDS, info))


def launch_plan(N, D):
    """The launch shape of this kernel for N rows of D units."""
    return plan(_NAME, N, D)


def _launch(xs, w, h0, c0, mask):
    """One launch of the kernel on checked operands; returns (hs, cs)."""
    T, N, _ = xs.shape
    D = w.shape[0]
    hs = torch.empty((T, N, D), dtype=torch.float32, device=xs.device)
    cs = torch.empty_like(hs)
    barrier = torch.empty((1,), dtype=torch.int32, device=xs.device)
    lib = _build.load(_NAME)
    fn = lib.fused_lstm_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(xs.data_ptr(), w.data_ptr(), h0.data_ptr(), c0.data_ptr(),
              mask.data_ptr(), hs.data_ptr(), cs.data_ptr(),
              barrier.data_ptr(), T, N, D, _build.stream_handle(xs.device))
    _build.check(lib, code, _NAME)
    return hs, cs


def _forward(xs, w, h0, c0, mask):
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    global launches
    if xs.device.type == "cpu":
        return fused_lstm_reference(xs, w, h0, c0, mask)
    xs, w, h0, c0, mask = (t.contiguous() for t in (xs, w, h0, c0, mask))
    _check(xs, w, h0, c0, mask)
    if xs.shape[0] == 0 or xs.shape[1] == 0:
        empty = xs.new_zeros(xs.shape[:2] + (w.shape[0],))
        return empty, empty.clone()
    out = _launch(xs, w, h0, c0, mask)
    launches += 1
    return out


class _FusedLSTM(torch.autograd.Function):
    """The forward kernel with the backward of the JAX custom vjp."""

    @staticmethod
    def forward(ctx, xs, w, h0, c0, mask):
        hs, cs = _forward(xs, w, h0, c0, mask)
        ctx.save_for_backward(xs, w, h0, c0, mask, hs, cs)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        xs, w, h0, c0, mask, hs, cs = ctx.saved_tensors
        dxs, dw, dh0, dc0 = fused_lstm_bwd(xs, w, h0, c0, mask, hs, cs,
                                           dhs, dcs)
        return dxs, dw, dh0, dc0, None


def fused_lstm(xs, w, h0, c0, mask):
    """``(hs, cs)`` of the LSTM recurrence, differentiable in xs, w, h0
    and c0. On CUDA: float32, shapes as in the module docstring, D a
    multiple of 4; anything else raises."""
    return _FusedLSTM.apply(xs, w, h0, c0, mask)
