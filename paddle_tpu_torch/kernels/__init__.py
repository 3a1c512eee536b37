"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart of ``paddle_tpu/kernels``).

Every kernel module keeps a ``launches`` count that its wrapper raises by
one per kernel launch, and nowhere else; :func:`launch_counts` and
:func:`reset_launches` read and clear all of them, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

from . import flash_attention, paged_attention

__all__ = ["KERNEL_MODULES", "launch_counts", "reset_launches"]

# kernel name (its csrc/<name>.cu) -> the module whose wrapper launches it
KERNEL_MODULES = {
    "flash_attention_fwd": flash_attention,
    "paged_attention": paged_attention,
}


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launches():
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
