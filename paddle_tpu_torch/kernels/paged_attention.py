"""Paged attention for the decode step (counterpart of
``paddle_tpu/kernels/paged_attention.py``).

One query per running row attends over the row's cached K/V, read
through its block table from one layer's page pool
``[num_pages + 1, T, nh, dh]`` (the last page is the trash page). Column
``c`` attends iff ``c <= positions[row]``.

- :func:`paged_attention_reference` is the plain PyTorch version: the
  gather-then-mask math of the JAX package's reference, verbatim. The
  CPU tests hold it against the JAX functions, and on the card
  ``chip_smoke.py`` holds the kernel against it.
- :func:`paged_attention` is the wrapper. A CPU tensor gets the plain
  version; a CUDA tensor gets the hand-written kernel of
  ``csrc/paged_attention.cu`` or an exception, never the plain version.
- ``launches`` counts the wrapper's calls on CUDA: each call launches
  the split kernel and then the merge kernel, and counts one.
- :func:`splits` mirrors the kernel's rule for the number of splits of a
  row (``SPLIT`` columns each), which sizes the workspace the wrapper
  allocates; :func:`kernel_splits` asks the built library.
- :func:`paged_attention_kwide` is the speculative verify step's face:
  K1 query lanes a row, each with its own position. It opens no kernel
  of its own: on CUDA the lanes are flattened onto R * K1 rows, each
  row's table repeated, and the rows go through :func:`paged_attention`
  (one launch); on the CPU it runs
  :func:`paged_attention_kwide_reference`, the JAX package's gather
  path, one gather a row shared by its lanes.

The JAX package's tune configs and their degrade-to-reference validator
(``resolve_block_config``) do not carry over: the kernel takes every
pool geometry the engine builds and picks its own launch shape.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["SPLIT", "kernel_splits", "launches", "paged_attention",
           "paged_attention_kwide", "paged_attention_kwide_reference",
           "paged_attention_reference", "splits"]

# calls of paged_attention that launched the kernels since the last reset
launches = 0

_NAME = "paged_attention"
_HEAD_DIMS = (32, 64, 128)
# columns a split of the kernel takes (``constexpr int SPLIT`` in the
# source)
SPLIT = 64


def splits(MB, T):
    """How many splits the kernel cuts a row of ``MB`` pages of ``T``
    columns into: ``ceil(MB * T / SPLIT)``, whatever the positions."""
    return -(-MB * T // SPLIT)


def kernel_splits(MB, T):
    """:func:`splits` as the built library computes it (needs the card's
    toolchain)."""
    fn = _build.load(_NAME).paged_attention_splits
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(MB, T)


def paged_attention_reference(q, k_pages, v_pages, block_tables, positions):
    """Plain version: gather ``[R, max_blocks * T, nh, dh]`` through the
    tables, mask columns past each row's position to -inf, dense
    softmax. ``q`` [R, nh, dh]; pools [P + 1, T, nh, dh]; ``block_tables``
    [R, max_blocks] int; ``positions`` [R] int -> [R, nh, dh]."""
    R, nh, dh = q.shape
    T = k_pages.shape[1]
    C = block_tables.shape[1] * T
    tables = block_tables.long()
    kc = k_pages[tables].reshape(R, C, nh, dh)
    vc = v_pages[tables].reshape(R, C, nh, dh)
    s = torch.einsum("rhd,rchd->rhc", q, kc) * dh ** -0.5
    cols = torch.arange(C, device=q.device)
    colmask = cols[None, :] <= positions.long()[:, None]
    s = s.masked_fill(~colmask[:, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rhc,rchd->rhd", p, vc)


def paged_attention(q, k_pages, v_pages, block_tables, positions):
    """Decode attention for the whole running batch; the arguments and
    result of :func:`paged_attention_reference`. On CUDA: float32 q and
    pools, int32 tables and positions, all contiguous on q's device, q
    and the pools 16-byte aligned (the kernel loads 16 bytes a lane), and
    ``dh`` in (32, 64, 128); anything else raises."""
    global launches
    _build.refuse_grad(_NAME, q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         positions)
    if q.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (_NAME, q.device))
    R, nh, dh = q.shape
    P1, T, nh_k, dh_k = k_pages.shape
    MB = block_tables.shape[1]
    if (nh_k, dh_k) != (nh, dh) or v_pages.shape != k_pages.shape:
        raise ValueError("%s: pools %s/%s do not hold q's heads %s"
                         % (_NAME, tuple(k_pages.shape),
                            tuple(v_pages.shape), (nh, dh)))
    if tuple(block_tables.shape) != (R, MB) or \
            tuple(positions.shape) != (R,):
        raise ValueError("%s: tables %s / positions %s do not match %d rows"
                         % (_NAME, tuple(block_tables.shape),
                            tuple(positions.shape), R))
    if dh not in _HEAD_DIMS:
        raise ValueError("%s: head_dim %d has no kernel (supported: %s)"
                         % (_NAME, dh, _HEAD_DIMS))
    if q.dtype != torch.float32 or k_pages.dtype != torch.float32 or \
            v_pages.dtype != torch.float32:
        raise ValueError("%s: the kernel takes float32 q and pools" % _NAME)
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise ValueError("%s: block_tables and positions must be int32"
                         % _NAME)
    _build.check_cuda_operands(_NAME, q.device, q=q, k_pages=k_pages,
                               v_pages=v_pages, block_tables=block_tables,
                               positions=positions)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError("%s: %s must be 16-byte aligned"
                             % (_NAME, name))
    S = splits(MB, T)
    out = torch.empty_like(q)
    # each (row, head, split)'s partial: acc [dh], then m and den
    work = torch.empty((R, nh, S, dh + 2), dtype=torch.float32,
                       device=q.device)
    lib = _build.load(_NAME)
    fn = lib.paged_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
              block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
              work.data_ptr(), R, nh, dh, T, MB, S, dh ** -0.5,
              _build.stream_handle(q.device))
    _build.check(lib, code, _NAME)
    launches += 1
    return out


def paged_attention_kwide_reference(q, k_pages, v_pages, block_tables,
                                    positions):
    """Plain version of the k-wide face: ``q`` [R, K1, nh, dh] (lane i
    is the token fed at ``positions[r, i]``), pools [P + 1, T, nh, dh],
    ``block_tables`` [R, max_blocks], ``positions`` [R, K1]. The pool is
    gathered once a row and the row's K1 lanes attend against it, each
    masking the columns past its own position -> [R, K1, nh, dh]."""
    R, K1, nh, dh = q.shape
    T = k_pages.shape[1]
    C = block_tables.shape[1] * T
    tables = block_tables.long()
    kc = k_pages[tables].reshape(R, C, nh, dh)
    vc = v_pages[tables].reshape(R, C, nh, dh)
    s = torch.einsum("rlhd,rchd->rlhc", q, kc) * dh ** -0.5
    cols = torch.arange(C, device=q.device)
    colmask = cols[None, None, :] <= positions.long()[:, :, None]
    s = s.masked_fill(~colmask[:, :, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rlhc,rchd->rlhd", p, vc)


def paged_attention_kwide(q, k_pages, v_pages, block_tables, positions):
    """The speculative verify step's attention; the arguments and result
    of :func:`paged_attention_kwide_reference`. On CUDA the lanes are
    flattened onto R * K1 rows (q and positions reshaped, each row's
    table repeated K1 times, int32 and contiguous) and the row-1 kernel
    runs once through :func:`paged_attention`, under its conditions; a
    lane's result is then what a decode step at that position computes.
    It never runs the gather on the card."""
    _build.refuse_grad(_NAME, q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_attention_kwide_reference(q, k_pages, v_pages,
                                               block_tables, positions)
    R, K1, nh, dh = q.shape
    if tuple(positions.shape) != (R, K1) or block_tables.dim() != 2 or \
            block_tables.shape[0] != R:
        raise ValueError("%s: positions %s / tables %s do not match q's "
                         "%d rows of %d lanes"
                         % (_NAME, tuple(positions.shape),
                            tuple(block_tables.shape), R, K1))
    tables = block_tables.repeat_interleave(K1, dim=0).contiguous()
    out = paged_attention(q.reshape(R * K1, nh, dh).contiguous(), k_pages,
                          v_pages, tables,
                          positions.reshape(R * K1).contiguous())
    return out.reshape(R, K1, nh, dh)
