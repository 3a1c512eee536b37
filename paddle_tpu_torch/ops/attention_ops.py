"""The ``flash_attention`` op (counterpart of
``paddle_tpu/ops/attention_ops.py:31 flash_attention_op``).

Q/K/V are ``[batch, seq, heads, dim]``. The op calls the port's flash
wrapper, a ``torch.autograd.Function``: on a CUDA tensor its forward is
the kernel of ``csrc/flash_attention_fwd.cu`` and its backward those of
``csrc/flash_attention_bwd.cu``, on a CPU tensor the plain versions. The
JAX op's tune lookup is not ported (the port's ``tune/`` has no
flash-attention space): on a cache miss it returns ``{}`` and the op
runs the flash kernel, which is what the port always does.
"""
from __future__ import annotations

from ..core.registry import register_op
from ..kernels.flash_attention import flash_attention

__all__ = []


@register_op("flash_attention")
def flash_attention_op(ctx):
    ctx.set_output("Out", flash_attention(
        ctx.input("Q"), ctx.input("K"), ctx.input("V"),
        causal=bool(ctx.attr("causal", False))))
