"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart of ``paddle_tpu/kernels``).

Every kernel has a launch count on its wrapper module that the wrapper
raises by one per launch, and nowhere else; :func:`launch_counts` and
:func:`reset_launches` read and clear all of them, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

from . import conv3x3, flash_attention, fused_gru, fused_lstm, paged_attention

__all__ = ["KERNEL_COUNTERS", "launch_counts", "reset_launches"]

# kernel name -> (wrapper module, name of its count there)
KERNEL_COUNTERS = {
    "flash_attention_fwd": (flash_attention, "launches"),
    "flash_attention_bwd_dkv": (flash_attention, "launches_bwd_dkv"),
    "flash_attention_bwd_dq": (flash_attention, "launches_bwd_dq"),
    "paged_attention": (paged_attention, "launches"),
    # one kernel in two roles: the conv's forward and its backward's dx
    "conv3x3_fwd": (conv3x3, "launches"),
    "conv3x3_dx": (conv3x3, "launches_dx"),
    # the whole recurrence of an lstm / gru op, one launch a call
    "fused_lstm": (fused_lstm, "launches"),
    "fused_gru": (fused_gru, "launches"),
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launches():
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
