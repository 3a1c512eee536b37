"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart of ``paddle_tpu/kernels``).

Every kernel has a launch count on its wrapper module that the wrapper
raises by one per launch, and nowhere else; :func:`launch_counts` and
:func:`reset_launches` read and clear all of them, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

from . import (conv3x3, flash_attention, fused_gru, fused_lstm, matmul,
               paged_attention)

__all__ = ["KERNEL_COUNTERS", "launch_counts", "reset_launches"]

# kernel name -> (wrapper module, name of its count there)
KERNEL_COUNTERS = {
    # the flash forward, dK/dV and dQ kernels, each with a float32 and a
    # bfloat16 (pure AMP) face; the bfloat16 faces' mma.sync path (D 32
    # and 128) counted apart from their wgmma kernels (D 64)
    "flash_attention_fwd": (flash_attention, "launches"),
    "flash_attention_bwd_dkv": (flash_attention, "launches_bwd_dkv"),
    "flash_attention_bwd_dq": (flash_attention, "launches_bwd_dq"),
    "flash_attention_fwd_bf16": (flash_attention, "launches_bf16"),
    "flash_attention_fwd_bf16_mma": (flash_attention, "launches_bf16_mma"),
    "flash_attention_bwd_dkv_bf16": (flash_attention,
                                     "launches_bwd_dkv_bf16"),
    "flash_attention_bwd_dq_bf16": (flash_attention, "launches_bwd_dq_bf16"),
    "flash_attention_bwd_dkv_bf16_mma": (flash_attention,
                                         "launches_bwd_dkv_bf16_mma"),
    "flash_attention_bwd_dq_bf16_mma": (flash_attention,
                                        "launches_bwd_dq_bf16_mma"),
    "paged_attention": (paged_attention, "launches"),
    # one kernel in two roles: the conv's forward and its backward's dx,
    # each with a float32 and a bfloat16 (AMP) face; the bfloat16 face's
    # ragged path (operands TMA cannot take) counted apart
    "conv3x3_fwd": (conv3x3, "launches"),
    "conv3x3_dx": (conv3x3, "launches_dx"),
    "conv3x3_fwd_bf16": (conv3x3, "launches_bf16"),
    "conv3x3_dx_bf16": (conv3x3, "launches_dx_bf16"),
    "conv3x3_fwd_bf16_ragged": (conv3x3, "launches_bf16_ragged"),
    "conv3x3_dx_bf16_ragged": (conv3x3, "launches_dx_bf16_ragged"),
    # the whole recurrence of an lstm / gru op, one launch a call; the
    # LSTM with a float32 and a bfloat16 (pure AMP, no bias) face
    "fused_lstm": (fused_lstm, "launches"),
    "fused_lstm_bf16": (fused_lstm, "launches_bf16"),
    "fused_gru": (fused_gru, "launches"),
    # the blocked gemm of a mul under a cached tune winner, float32 and
    # bfloat16 (AMP) faces; the bfloat16 face's ragged path (operands TMA
    # cannot take) counted apart
    "matmul": (matmul, "launches"),
    "matmul_bf16": (matmul, "launches_bf16"),
    "matmul_bf16_ragged": (matmul, "launches_bf16_ragged"),
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launches():
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
