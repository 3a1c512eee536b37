"""The whole LSTM recurrence of a ragged batch (counterpart of
``paddle_tpu/kernels/fused_lstm.py``).

- :func:`fused_lstm_reference` is the plain forward: the time loop of
  the JAX kernel's body, one ``[N, D] @ [D, 4D]`` product and the gate
  arithmetic a step, the state in float32 (bfloat16 operands widened,
  hs and cs rounded once to their dtype, as the JAX kernel's float32
  scratch and ``xs.dtype`` outputs do).
- :func:`fused_lstm_bwd` is the backward of the JAX package's custom vjp
  (``_bwd``, a plain reversed scan that recomputes the gates from the
  saved h/c), in plain PyTorch on both devices: the JAX backward is no
  Pallas kernel either. The gate pre-activations of all steps are
  recomputed in one product up front, the reversed loop carries dh and
  dc, and dW is one product of the previous states with the stacked gate
  gradients (which are the gradient of ``xs``), so no per-step ``[D, 4D]``
  term is ever stacked (the memory concern of ``fused_lstm.py:151-153``).
  On bfloat16 it recomputes from the saved (rounded) states, widened,
  runs in float32 and returns each gradient in its operand's dtype.
- :func:`fused_lstm` is the wrapper, a ``torch.autograd.Function``. A CPU
  tensor gets the plain forward. A CUDA tensor gets the hand-written
  kernel of ``csrc/fused_lstm.cu`` or an exception, never the plain
  version: its float32 face on float32 operands, its bfloat16 face on
  bfloat16 xs, h0 and c0 with float32 w and mask (pure AMP's bias-free
  LSTM); D a multiple of 4 up to 16 units a block on every SM (2112 on
  an H100).
- ``launches`` and ``launches_bf16`` count each face's launches;
  :func:`launch_plan` reports the launch shape (blocks, units a block,
  rows a piece, shared memory) a batch gets; :func:`plan` does so for
  either recurrence's kernel.

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
spin), T - 1 in all; h and c stay in registers between steps. The
bfloat16 face widens h0 and c0 as it loads them and x where the gate
math takes it, rounds hs and cs as it stores them, and passes each
step's float32 h between blocks through a two-slot exchange ``[2, N,
D]`` that the wrapper allocates, so that W multiplies the float32 h the
JAX kernel carries, not the rounded hs.

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
           "fused_lstm_reference", "launch_plan", "launches",
           "launches_bf16", "max_units", "plan"]

# launches of each face since the last reset: float32, bfloat16
launches = 0
launches_bf16 = 0
# what launch_plan reports about a launch shape
PLAN_FIELDS = ("blocks", "units_per_block", "rows_per_piece",
               "shared_bytes", "threads", "blocks_per_sm", "sms")

_NAME = "fused_lstm"


def _gates(g, D):
    """(c~, i, f, o) activations of the pre-activations ``g [.., 4D]``."""
    return (torch.tanh(g[..., :D]), torch.sigmoid(g[..., D:2 * D]),
            torch.sigmoid(g[..., 2 * D:3 * D]), torch.sigmoid(g[..., 3 * D:]))


def _acc(dtype):
    """The dtype the recurrence computes in: float32 for bfloat16 (the
    JAX kernel's scratch), the operands' own otherwise."""
    return torch.promote_types(dtype, torch.float32)


def fused_lstm_reference(xs, w, h0, c0, mask):
    """Plain forward: the JAX kernel's step, T times, in float32 on
    bfloat16 operands; hs and cs in ``xs.dtype``."""
    D = w.shape[0]
    acc = _acc(xs.dtype)
    w = w.to(acc)
    h, c = h0.to(acc), c0.to(acc)
    hs, cs = [], []
    for t in range(xs.shape[0]):
        cand, i, f, o = _gates(xs[t].to(acc) + h @ w, D)
        c_new = f * c + i * cand
        h_new = o * torch.tanh(c_new)
        m = mask[t].to(h.dtype)[:, None]
        h = h_new * m + h * (1.0 - m)
        c = c_new * m + c * (1.0 - m)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs).to(xs.dtype), torch.stack(cs).to(xs.dtype)


def fused_lstm_bwd(xs, w, h0, c0, mask, hs, cs, dhs, dcs):
    """``(dxs, dw, dh0, dc0)`` of the forward at its saved outputs, the
    JAX ``_bwd`` recurrence: the gates recomputed from the saved states
    (h0 and c0 taken in the outputs' dtype, as the saved steps are), all
    of it in float32 on bfloat16 operands, each gradient returned in its
    operand's dtype."""
    T, N, _ = xs.shape
    D = w.shape[0]
    acc = _acc(xs.dtype)
    hprev = torch.cat([h0[None].to(hs.dtype), hs[:-1]], dim=0).to(acc)
    cprev = torch.cat([c0[None].to(cs.dtype), cs[:-1]], dim=0).to(acc)
    wf = w.to(acc)
    dhs, dcs = dhs.to(acc), dcs.to(acc)
    # every step's gates, recomputed from the saved states in one product
    cand, i, f, o = _gates(xs.to(acc) + (hprev.reshape(T * N, D) @ wf)
                           .reshape(T, N, 4 * D), D)
    tanh_c = torch.tanh(f * cprev + i * cand)
    m = mask.to(acc)[..., None]
    dgs = torch.empty(xs.shape, dtype=acc, device=xs.device)
    dh = torch.zeros(h0.shape, dtype=acc, device=h0.device)
    dc = torch.zeros(c0.shape, dtype=acc, device=c0.device)
    wt = wf.t()
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
    return (dgs.to(xs.dtype), dw.to(w.dtype), dh.to(h0.dtype),
            dc.to(c0.dtype))


def max_units(device):
    """The widest D the kernel takes on ``device``: two unit groups of 8
    a block, one block an SM (``recurrence.cuh:plan``)."""
    return 16 * torch.cuda.get_device_properties(
        device).multi_processor_count


def _check(xs, w, h0, c0, mask):
    """Raises ValueError unless the kernel takes these operands; returns
    whether they are the bfloat16 face's."""
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
    # the dtypes of (xs, w, h0, c0, mask) of the two faces
    f32, bf16 = torch.float32, torch.bfloat16
    dtypes = (xs.dtype, w.dtype, h0.dtype, c0.dtype, mask.dtype)
    if dtypes not in ((f32,) * 5, (bf16, f32, bf16, bf16, f32)):
        raise ValueError(
            "%s: the kernel takes float32 operands, or bfloat16 xs, h0 and "
            "c0 with float32 w and mask; got xs, w, h0, c0, mask %s"
            % (_NAME, ", ".join(str(d).replace("torch.", "")
                                for d in dtypes)))
    _build.check_cuda_operands(_NAME, xs.device, xs=xs, w=w, h0=h0, c0=c0,
                               mask=mask)
    limit = max_units(xs.device)
    if D > limit:
        raise ValueError("%s: the kernel takes D up to 16 units an SM, %d "
                         "on this card, got %d" % (_NAME, limit, D))
    return xs.dtype == bf16


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
    """One launch of the kernel's face for xs's dtype on checked
    operands; returns (hs, cs) in that dtype."""
    T, N, _ = xs.shape
    D = w.shape[0]
    hs = torch.empty((T, N, D), dtype=xs.dtype, device=xs.device)
    cs = torch.empty_like(hs)
    barrier = torch.empty((1,), dtype=torch.int32, device=xs.device)
    # the bfloat16 face's float32 exchange of h between blocks
    hx = (torch.empty((2, N, D), dtype=torch.float32, device=xs.device)
          if xs.dtype == torch.bfloat16 else None)
    lib = _build.load(_NAME)
    fn = lib.fused_lstm_bf16 if hx is not None else lib.fused_lstm_f32
    fn.argtypes = [ctypes.c_void_p] * (8 if hx is None else 9) + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (xs, w, h0, c0, mask, hs, cs)]
    if hx is not None:
        ptrs.append(hx.data_ptr())
    code = fn(*ptrs, barrier.data_ptr(), T, N, D,
              _build.stream_handle(xs.device))
    _build.check(lib, code, _NAME)
    return hs, cs


def _forward(xs, w, h0, c0, mask):
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    global launches, launches_bf16
    if xs.device.type == "cpu":
        return fused_lstm_reference(xs, w, h0, c0, mask)
    xs, w, h0, c0, mask = (t.contiguous() for t in (xs, w, h0, c0, mask))
    bf16 = _check(xs, w, h0, c0, mask)
    if xs.shape[0] == 0 or xs.shape[1] == 0:
        empty = xs.new_zeros(xs.shape[:2] + (w.shape[0],))
        return empty, empty.clone()
    out = _launch(xs, w, h0, c0, mask)
    if bf16:
        launches_bf16 += 1
    else:
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
    """``(hs, cs)`` of the LSTM recurrence in xs's dtype, differentiable
    in xs, w, h0 and c0. On CUDA: float32 operands, or bfloat16 xs, h0
    and c0 with float32 w and mask; shapes as in the module docstring, D
    a multiple of 4 up to :func:`max_units`; anything else raises."""
    return _FusedLSTM.apply(xs, w, h0, c0, mask)
