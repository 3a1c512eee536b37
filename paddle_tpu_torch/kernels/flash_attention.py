"""Flash attention, forward and backward (counterpart of
``paddle_tpu/kernels/flash_attention.py``).

``q``, ``k``, ``v`` are ``[B, S, H, D]`` (the JAX package's public
layout); the result is ``(o [B, S, H, D], lse [B, H, S])`` with
``lse = m + log(den)``, the semantics of ``flash_attention_with_lse``.

- :func:`flash_attention_reference` is the plain forward: dense scores,
  a -inf causal mask and a softmax, over blocks of query rows so that the
  score matrix never needs more than ``block * S`` entries a head.
- :func:`flash_attention_bwd_reference` is the plain backward: the
  recompute formulas of the kernels (``p = exp(s - lse)``,
  ``ds = p * (dO v^T - delta) * scale``) over the same blocks, with
  cotangents on both ``o`` and ``lse``.
- :func:`flash_attention_with_lse` is the wrapper, a
  ``torch.autograd.Function``: its forward keeps ``q, k, v, o, lse``, its
  backward folds the ``lse`` cotangent into delta, as the JAX custom vjp
  does. A CPU tensor gets the plain versions; a CUDA tensor gets the
  hand-written kernels of ``csrc/flash_attention_fwd.cu`` and
  ``csrc/flash_attention_bwd.cu`` or an exception, never the plain
  versions.
- Two faces, as the JAX kernels are dtype-generic: float32 q, k, v (and
  dO), and bfloat16 ones (pure AMP), whose kernels compute in float32
  and write o, dq, dk and dv once in bfloat16; ``lse`` and ``delta`` are
  float32 on both. A mixed set of dtypes is refused.
- ``launches``, ``launches_bwd_dkv`` and ``launches_bwd_dq`` count the
  kernel launches of the float32 forward, dK/dV and dQ kernels;
  ``launches_bf16``, ``launches_bwd_dkv_bf16`` and
  ``launches_bwd_dq_bf16`` those of the bfloat16 faces.
- The bfloat16 forward takes one of two kernels by head dim
  (:func:`fwd_bf16_path`, the source's rule): at D 64 the TMA-fed,
  warp-specialised ``wgmma`` kernel (counted on ``launches_bf16``), at
  D 32 and 128 the ``mma.sync`` kernel (``launches_bf16_mma``). The
  bfloat16 backward does the same (:func:`bwd_bf16_path`): its dK/dV and
  dQ kernels at D 64 on ``launches_bwd_dkv_bf16`` and
  ``launches_bwd_dq_bf16``, the ``mma.sync`` ones at D 32 and 128 on
  ``launches_bwd_dkv_bf16_mma`` and ``launches_bwd_dq_bf16_mma``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["bwd_bf16_path", "bwd_bf16_smem_bytes", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_reference", "flash_attention_with_lse",
           "fwd_bf16_path", "fwd_bf16_smem_bytes", "kernel_bwd_bf16_path",
           "kernel_bwd_smem_bytes", "kernel_fwd_bf16_path",
           "kernel_fwd_smem_bytes", "launches", "launches_bf16",
           "launches_bf16_mma", "launches_bwd_dkv", "launches_bwd_dkv_bf16",
           "launches_bwd_dkv_bf16_mma", "launches_bwd_dq",
           "launches_bwd_dq_bf16", "launches_bwd_dq_bf16_mma"]

# kernel launches since the last reset: forward, dK/dV and dQ, of the
# float32 and the bfloat16 faces; the bfloat16 faces' mma.sync path (D 32
# and 128) apart
launches = 0
launches_bwd_dkv = 0
launches_bwd_dq = 0
launches_bf16 = 0
launches_bf16_mma = 0
launches_bwd_dkv_bf16 = 0
launches_bwd_dq_bf16 = 0
launches_bwd_dkv_bf16_mma = 0
launches_bwd_dq_bf16_mma = 0

_NAME = "flash_attention_fwd"
_BWD_NAME = "flash_attention_bwd"
_HEAD_DIMS = (32, 64, 128)
# the entry points' suffix by operand dtype
_FACES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the bfloat16 forward's wgmma kernel (``BM_W``, ``BN_W``, ``RING_W`` and
# ``DW`` of the source): query rows a block, keys a tile, K / V stages of
# its ring, and the one head dim it takes
_BM_W, _BN_W, _RING_W, _DW = 128, 128, 4, 64
# the mma.sync kernel's keys a tile (``BN``)
_BN_MMA = 32
# the bfloat16 backward's wgmma kernels (``BK_W``, ``BQ_W``, ``BM_W``,
# ``BN_W`` and ``RING_W`` of csrc/flash_attention_bwd.cu): keys a dK/dV
# block, queries a dK/dV tile, queries a dQ block, keys a dQ tile, and
# the stages of either ring
_BK_BWD_W, _BQ_BWD_W, _BM_BWD_W, _BN_BWD_W, _RING_BWD_W = 128, 32, 128, 64, 4
# the mma.sync kernels' rows a block (``BR``) and rows a tile (``BN``)
_BR_BWD_MMA, _BN_BWD_MMA = 64, 32


def fwd_bf16_path(D):
    """The kernel the bfloat16 forward takes at head dim ``D``:
    ``"wgmma"`` at D 64, ``"mma"`` at D 32 and 128 (``wgmma_path`` of the
    source, picked before the launch)."""
    if D not in _HEAD_DIMS:
        raise ValueError("%s: head_dim %d has no kernel (supported: %s)"
                         % (_NAME, D, _HEAD_DIMS))
    return "wgmma" if D == _DW else "mma"


def fwd_bf16_smem_bytes(D, path=None):
    """Dynamic shared memory of one block of the bfloat16 forward at head
    dim ``D`` on ``path`` (default :func:`fwd_bf16_path`): the wgmma
    kernel's q box, ``RING_W`` stages of a K and a V box and 1024 bytes
    of alignment (``SMEM_BYTES_W``), or the mma.sync kernel's two
    buffers of K and V tiles of ``[32][D + 8]``
    (``fwd_bf16_mma_smem_bytes``)."""
    path = path or fwd_bf16_path(D)
    if path == "wgmma":
        if D != _DW:
            raise ValueError("%s: the wgmma kernel takes D %d only, not %d"
                             % (_NAME, _DW, D))
        return (_BM_W * _DW + _RING_W * 2 * _BN_W * _DW) * 2 + 1024
    return 4 * _BN_MMA * (D + 8) * 2


def bwd_bf16_path(D):
    """The kernels the bfloat16 backward takes at head dim ``D``:
    ``"wgmma"`` at D 64, ``"mma"`` at D 32 and 128 (``wgmma_path`` of
    ``csrc/flash_attention_bwd.cu``, picked before the launch)."""
    if D not in _HEAD_DIMS:
        raise ValueError("%s: head_dim %d has no kernel (supported: %s)"
                         % (_BWD_NAME, D, _HEAD_DIMS))
    return "wgmma" if D == _DW else "mma"


def bwd_bf16_smem_bytes(D, which, path=None):
    """Dynamic shared memory of one block of the bfloat16 dK/dV
    (``which`` "dkv") or dQ (``"dq"``) kernel at head dim ``D`` on
    ``path`` (default :func:`bwd_bf16_path`). The wgmma kernels: the
    block's two 128-row boxes (K and V, or q and dO), ``RING_W`` stages
    (dK/dV: a q and a dO tile of ``BQ_W`` rows and their lse and delta,
    each in ``BQ_W + 32`` floats;
    dQ: a K and a V tile of ``BN_W`` rows) and 1024 bytes of alignment.
    The mma.sync kernels: two 64-row tiles and two buffers of a pair of
    32-row tiles of ``[rows][D + 8]`` bfloat16, and for dK/dV two
    buffers of 32 lse and delta."""
    if which not in ("dkv", "dq"):
        raise ValueError("which is 'dkv' or 'dq', not %r" % (which,))
    path = path or bwd_bf16_path(D)
    if path == "wgmma":
        if D != _DW:
            raise ValueError("%s: the wgmma kernels take D %d only, not %d"
                             % (_BWD_NAME, _DW, D))
        if which == "dkv":
            # lse and delta: BQ_W + 4 values a stage loads, kept in
            # 128-byte aligned rows of BQ_W + 32 floats
            stage = 2 * _BQ_BWD_W * _DW * 2 + 2 * (_BQ_BWD_W + 32) * 4
            return 2 * _BK_BWD_W * _DW * 2 + _RING_BWD_W * stage + 1024
        stage = 2 * _BN_BWD_W * _DW * 2
        return 2 * _BM_BWD_W * _DW * 2 + _RING_BWD_W * stage + 1024
    tiles = (2 * _BR_BWD_MMA + 4 * _BN_BWD_MMA) * (D + 8) * 2
    return tiles + (4 * _BN_BWD_MMA * 4 if which == "dkv" else 0)


def kernel_bwd_bf16_path(D):
    """The path the built library's bfloat16 backward takes at head dim
    ``D`` (``flash_attention_bwd_bf16_path``; needs the card's
    toolchain)."""
    lib = _build.load(_BWD_NAME)
    fn = lib.flash_attention_bwd_bf16_path
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return {1: "wgmma", 0: "mma"}.get(fn(D))


def kernel_bwd_smem_bytes(D, which, face):
    """The built library's shared memory of a backward block at head dim
    ``D``: ``which`` "dkv" or "dq", ``face`` "f32", "bf16" (the path of
    D) or "bf16_mma"."""
    lib = _build.load(_BWD_NAME)
    fn = lib.flash_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(D, {"dkv": 0, "dq": 1}[which],
              {"f32": 0, "bf16": 1, "bf16_mma": 2}[face])


def kernel_fwd_bf16_path(D):
    """The path the built library's bfloat16 forward takes at head dim
    ``D`` (``flash_attention_fwd_bf16_path``; needs the card's
    toolchain)."""
    lib = _build.load(_NAME)
    fn = lib.flash_attention_fwd_bf16_path
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return {1: "wgmma", 0: "mma"}.get(fn(D))


def kernel_fwd_smem_bytes(D, face):
    """The built library's shared memory of a forward block at head dim
    ``D``: ``face`` "f32", "bf16" (the path of D) or "bf16_mma"."""
    lib = _build.load(_NAME)
    fn = lib.flash_attention_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return fn(D, {"f32": 0, "bf16": 1, "bf16_mma": 2}[face])


def _acc_dtype(dtype):
    """The dtype the plain versions compute in: float32 for bfloat16 (the
    kernels cast their tiles to float32), the operands' own otherwise."""
    return torch.promote_types(dtype, torch.float32)


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              block=256):
    """Plain version: ``(o [B, S, H, D], lse [B, H, S])`` from dense
    softmax attention over blocks of ``block`` query rows. Scores,
    softmax and ``p v`` are computed in float32 on bfloat16 operands (in
    float64 on float64 ones), ``o`` is rounded once to q's dtype and
    ``lse`` stays in the computing dtype, as ``_fa_kernel`` writes
    them."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if causal and S != Sk:
        raise ValueError("causal flash attention needs q/k aligned lengths")
    scale = scale if scale is not None else D ** -0.5
    acc = _acc_dtype(q.dtype)
    qh, kh, vh = (t.permute(0, 2, 1, 3).to(acc)
                  for t in (q, k, v))  # [B, H, S, D]
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
    o = torch.cat(outs, dim=2).permute(0, 2, 1, 3).to(q.dtype)
    return o, torch.cat(lses, dim=2)


def _delta(o, do, dlse):
    """delta [B, H, S] = rowsum(dO * o) - dlse, float32."""
    delta = torch.einsum("bshd,bshd->bhs", do.float(), o.float())
    return delta if dlse is None else delta - dlse


def flash_attention_bwd_reference(q, k, v, o, lse, do, dlse=None,
                                  causal=False, scale=None, block=256):
    """Plain backward: ``(dq, dk, dv)``, each ``[B, S, H, D]``, from the
    recompute formulas over blocks of ``block`` query rows. ``dlse``
    ([B, H, S] or None) is the cotangent of ``lse``. On bfloat16
    operands every product and sum is taken in float32 and dq, dk and dv
    are rounded once to q's, k's and v's dtypes, as the JAX kernels
    write them."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    acc = _acc_dtype(q.dtype)
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3).to(acc) for t in (q, k, v, do))
    delta = _delta(o, do, dlse).to(acc)
    lse = lse.to(acc)
    dq = torch.empty_like(qh)
    dk = torch.zeros_like(kh)
    dv = torch.zeros_like(vh)
    cols = torch.arange(Sk, device=q.device)
    for r0 in range(0, S, block):
        r1 = min(r0 + block, S)
        s = torch.einsum("bhqd,bhkd->bhqk", qh[:, :, r0:r1], kh) * scale
        if causal:
            rows = torch.arange(r0, r1, device=q.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        p = torch.exp(s - lse[:, :, r0:r1, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doh[:, :, r0:r1])
        dp = torch.einsum("bhqd,bhkd->bhqk", doh[:, :, r0:r1], vh)
        ds = p * (dp - delta[:, :, r0:r1, None]) * scale
        dq[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", ds, kh)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qh[:, :, r0:r1])
    return tuple(g.permute(0, 2, 1, 3).to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


def _check_kernel_operands(what, D, floats=(), **named):
    """The ``named`` operands must be all float32 or all bfloat16, and
    ``floats`` (lse, delta) float32; returns the face's suffix."""
    dtypes = {t.dtype for t in named.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _FACES:
        raise ValueError(
            "%s: the kernels take q, k, v (and dO) all float32 or all "
            "bfloat16, got %s" % (what, ", ".join(
                "%s %s" % (n, t.dtype) for n, t in named.items())))
    for name, t in floats:
        if t.dtype != torch.float32:
            raise ValueError("%s: %s must be float32, it is %s"
                             % (what, name, t.dtype))
    if D not in _HEAD_DIMS:
        raise ValueError("%s: head_dim %d has no kernel (supported: %s)"
                         % (what, D, _HEAD_DIMS))
    return _FACES[next(iter(dtypes))]


def _launch_fwd(q, k, v, causal, scale, mma=False):
    """One launch of the forward of the operands' face on checked
    operands, counted nowhere; ``mma`` forces the bfloat16 face's
    mma.sync kernel at any head dim. Returns (o, lse)."""
    B, S, H, D = q.shape
    face = _FACES[q.dtype]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load(_NAME)
    fn = getattr(lib, "flash_attention_fwd_" + face + "_mma" * mma)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), B, S, H, D, int(bool(causal)), float(scale),
              _build.stream_handle(q.device))
    _build.check(lib, code, _NAME)
    return o, lse


def _forward(q, k, v, causal, scale):
    """(o, lse): the plain version on the CPU, the kernel of the operands'
    face on CUDA, counted on its path's counter."""
    global launches, launches_bf16, launches_bf16_mma
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
    face = _check_kernel_operands(_NAME, D, q=q, k=k, v=v)
    _build.check_cuda_operands(_NAME, q.device, q=q, k=k, v=v)
    scale = scale if scale is not None else D ** -0.5
    o, lse = _launch_fwd(q, k, v, causal, scale)
    if face == "f32":
        launches += 1
    elif fwd_bf16_path(D) == "wgmma":
        launches_bf16 += 1
    else:
        launches_bf16_mma += 1
    return o, lse


def _bwd_fn(lib, name, n_out):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (6 + n_out) + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_dkv(q, k, v, do, lse, delta, causal, scale, mma=False):
    """Launch the dK/dV kernel of the operands' face on checked operands,
    counted on its path's counter; ``mma`` forces the bfloat16 face's
    mma.sync kernel at any head dim, counted nowhere. Returns (dk, dv)."""
    global launches_bwd_dkv, launches_bwd_dkv_bf16, launches_bwd_dkv_bf16_mma
    B, S, H, D = q.shape
    face = _FACES[q.dtype]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load(_BWD_NAME)
    name = "flash_attention_bwd_dkv_" + face + "_mma" * mma
    code = _bwd_fn(lib, name, 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, S, H, D, int(bool(causal)), float(scale),
        _build.stream_handle(q.device))
    _build.check(lib, code, "flash_attention_bwd_dkv")
    if mma:
        pass
    elif face == "f32":
        launches_bwd_dkv += 1
    elif bwd_bf16_path(D) == "wgmma":
        launches_bwd_dkv_bf16 += 1
    else:
        launches_bwd_dkv_bf16_mma += 1
    return dk, dv


def _bwd_dq(q, k, v, do, lse, delta, causal, scale, mma=False):
    """Launch the dQ kernel of the operands' face on checked operands, as
    :func:`_bwd_dkv` does; returns dq."""
    global launches_bwd_dq, launches_bwd_dq_bf16, launches_bwd_dq_bf16_mma
    B, S, H, D = q.shape
    face = _FACES[q.dtype]
    dq = torch.empty_like(q)
    lib = _build.load(_BWD_NAME)
    name = "flash_attention_bwd_dq_" + face + "_mma" * mma
    code = _bwd_fn(lib, name, 1)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, S, H, D, int(bool(causal)), float(scale),
        _build.stream_handle(q.device))
    _build.check(lib, code, "flash_attention_bwd_dq")
    if mma:
        pass
    elif face == "f32":
        launches_bwd_dq += 1
    elif bwd_bf16_path(D) == "wgmma":
        launches_bwd_dq_bf16 += 1
    else:
        launches_bwd_dq_bf16_mma += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, dlse=None, causal=False,
                        scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_bwd_reference`. On CUDA:
    the dK/dV and dQ kernels of the operands' face, after the float32
    ``delta`` is formed with two torch elementwise ops; ``[B, S, H, D]``
    q, k, v, o and dO of one shape, q, k, v and dO all float32 or all
    bfloat16, ``lse`` float32, ``D`` in (32, 64, 128); anything else
    raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, dlse,
                                             causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s"
                         % (_BWD_NAME, q.device))
    D = q.shape[-1]
    if any(t.shape != q.shape for t in (k, v, o, do)):
        raise ValueError("%s: the kernels take q, k, v, o, dO of one "
                         "shape" % _BWD_NAME)
    do = do.contiguous()
    delta = _delta(o, do, dlse).contiguous()
    lse = lse.contiguous()
    _check_kernel_operands(_BWD_NAME, D, (("lse", lse), ("delta", delta)),
                           q=q, k=k, v=v, do=do)
    _build.check_cuda_operands(_BWD_NAME, q.device, q=q, k=k, v=v, do=do,
                               lse=lse, delta=delta)
    scale = scale if scale is not None else D ** -0.5
    dk, dv = _bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    dq = _bwd_dq(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with the flash backward: ``_flash_fwd``/``_flash_bwd`` of
    the JAX package's custom vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dlse,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """``(o, lse)`` as :func:`flash_attention_reference` returns them,
    differentiable in q, k and v through the flash backward. On CUDA:
    contiguous, 16-byte aligned ``[B, S, H, D]`` q/k/v of one shape on
    one device, all float32 or all bfloat16 (o in their dtype, lse
    float32), ``D`` in (32, 64, 128); anything else raises."""
    return _FlashAttention.apply(q, k, v, causal, scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """``[B, S, H, D]`` attention output only."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)[0]
