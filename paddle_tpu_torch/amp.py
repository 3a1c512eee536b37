"""Automatic mixed precision: bfloat16 operands, float32 sums
(counterpart of ``paddle_tpu/amp.py``).

Enabling AMP on a program makes the ``mul`` and ``conv2d`` lowerings and
their grads cast their float operands to bfloat16 and sum in float32;
parameters, optimizer state, batch-norm statistics and the loss math
stay float32. ``pure=True`` also keeps the gemm and conv OUTPUTS (and
the elementwise ops fed by them) in bfloat16, so the activation stream
is half-width; plain AMP writes them back in their declared dtype.

Where the JAX package probes for a TPU, AMP here applies on any device
that is not the CPU (``ctx.device``): on the CPU it is a no-op unless
:func:`force` pins it on, as the JAX package's is off its TPU.
"""
from __future__ import annotations

import contextlib

import torch

from .core import ir

__all__ = ["active", "amp_guard", "cast_inputs", "disable", "enable",
           "force", "keep_bf16", "matmul_f32"]

_FORCE = None  # tri-state: None = by device, True/False = pinned


def enable(program=None, pure=False):
    """Mark ``program`` (default: the main program) for AMP; ``pure``
    keeps the matmul / conv outputs in bfloat16."""
    program = program or ir.default_main_program()
    program._amp = True
    program._amp_pure = bool(pure)
    return program


def disable(program=None):
    program = program or ir.default_main_program()
    program._amp = False
    return program


@contextlib.contextmanager
def amp_guard(program=None):
    program = program or ir.default_main_program()
    old = getattr(program, "_amp", False)
    program._amp = True
    try:
        yield
    finally:
        program._amp = old


def force(mode):
    """Pin the cast decision: ``force(True)`` casts even on the CPU
    (numerics tests), ``force(False)`` never casts, ``force(None)``
    decides by device again. Returns the previous pin."""
    global _FORCE
    prev = _FORCE
    _FORCE = mode
    return prev


def active(ctx):
    """Whether AMP casting applies to this op: its program is marked and
    it runs off the CPU (or a pin says so)."""
    if not getattr(ctx.block.program, "_amp", False):
        return False
    if _FORCE is not None:
        return bool(_FORCE)
    return ctx.device.type != "cpu"


def keep_bf16(ctx, out_dtype=None):
    """True when a matmul / conv output stays bfloat16 (pure AMP)
    instead of being cast back to ``out_dtype``, the op's declared
    activation dtype; only float32 and bfloat16 activations narrow."""
    if out_dtype is not None and out_dtype not in (torch.float32,
                                                   torch.bfloat16):
        return False
    return getattr(ctx.block.program, "_amp_pure", False) and active(ctx)


def cast_inputs(ctx, *tensors):
    """The float operands cast to bfloat16 when the op runs under AMP."""
    if not active(ctx):
        return tensors
    return tuple(
        t.to(torch.bfloat16)
        if isinstance(t, torch.Tensor) and t.is_floating_point()
        and t.dtype != torch.bfloat16 else t
        for t in tensors)


def matmul_f32(a, b):
    """``a @ b`` summed and written in float32 (float64 operands stay
    float64): ``jnp.matmul(..., preferred_element_type=float32)``. A
    bfloat16 product is exact in float32, so only the order of the sums
    differs from the JAX result. bfloat16 operands on a card take one
    cuBLAS call with a float32 output (``torch.mm(..., out_dtype=)``);
    other narrower operands are widened first. Not a kernel of the
    port: the JAX package leaves these gemms to XLA."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                              torch.float32)
    if a.dtype == b.dtype == acc:
        return torch.matmul(a, b)
    if (a.device.type == "cuda" and a.dtype == b.dtype == torch.bfloat16
            and a.ndim == b.ndim == 2):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.to(acc), b.to(acc))
