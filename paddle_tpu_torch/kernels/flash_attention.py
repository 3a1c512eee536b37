"""Flash attention, forward only (counterpart of the forward of
``paddle_tpu/kernels/flash_attention.py``).

``q``, ``k``, ``v`` are ``[B, S, H, D]`` (the JAX package's public
layout); the result is ``(o [B, S, H, D], lse [B, H, S])`` with
``lse = m + log(den)``, the semantics of ``flash_attention_with_lse``.

- :func:`flash_attention_reference` is the plain PyTorch version: dense
  scores, a -inf causal mask and a softmax, taken over blocks of query
  rows so that the score matrix never needs more than
  ``block * S`` entries a head. The CPU tests hold it against the JAX
  kernel, and on the card ``chip_smoke.py`` holds the kernel against it.
- :func:`flash_attention_with_lse` is the wrapper. A CPU tensor gets the
  plain version; a CUDA tensor gets the hand-written kernel of
  ``csrc/flash_attention_fwd.cu`` or an exception, never the plain
  version.
- ``launches`` counts the wrapper's kernel launches.

There is no backward yet (the training slice brings it), so a wrapper
call on a tensor that requires grad raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_with_lse", "launches"]

# kernel launches made by flash_attention_with_lse since the last reset
launches = 0

_NAME = "flash_attention_fwd"
_HEAD_DIMS = (32, 64, 128)


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              block=256):
    """Plain version: ``(o [B, S, H, D], lse [B, H, S])`` from dense
    softmax attention over blocks of ``block`` query rows."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if causal and S != Sk:
        raise ValueError("causal flash attention needs q/k aligned lengths")
    scale = scale if scale is not None else D ** -0.5
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, D]
    outs, lses = [], []
    cols = torch.arange(Sk, device=q.device)
    for r0 in range(0, S, block):
        s = torch.einsum("bhqd,bhkd->bhqk", qh[:, :, r0:r0 + block],
                         kh) * scale
        if causal:
            rows = torch.arange(r0, min(r0 + block, S), device=q.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        lses.append(torch.logsumexp(s, dim=-1))
        outs.append(torch.einsum("bhqk,bhkd->bhqd",
                                 torch.softmax(s, dim=-1), vh))
    o = torch.cat(outs, dim=2).permute(0, 2, 1, 3)
    return o, torch.cat(lses, dim=2)


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """``(o, lse)`` as :func:`flash_attention_reference` returns them. On
    CUDA: float32, contiguous ``[B, S, H, D]`` q/k/v of one shape on one
    device, ``D`` in (32, 64, 128); anything else raises."""
    global launches
    _build.refuse_grad(_NAME, q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, q.device))
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("%s: the kernel takes q, k, v of one shape, got "
                         "%s/%s/%s" % (_NAME, tuple(q.shape),
                                       tuple(k.shape), tuple(v.shape)))
    if D not in _HEAD_DIMS:
        raise ValueError("%s: head_dim %d has no kernel (supported: %s)"
                         % (_NAME, D, _HEAD_DIMS))
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError("%s: the kernel takes float32 q/k/v" % _NAME)
    _build.check_cuda_operands(_NAME, q.device, q=q, k=k, v=v)
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load(_NAME)
    fn = lib.flash_attention_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), B, S, H, D, int(bool(causal)), float(scale),
              _build.stream_handle(q.device))
    _build.check(lib, code, _NAME)
    launches += 1
    return o, lse


def flash_attention(q, k, v, causal=False, scale=None):
    """``[B, S, H, D]`` attention output only."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)[0]
