"""Input layers (copy of ``paddle_tpu/layers/io.py``)."""
from __future__ import annotations

from ..core import ir
from ..core.types import VarType

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    """Declare a feed variable; ``append_batch_size`` prepends -1."""
    block = ir.default_main_program().current_block()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, type=type,
                            stop_gradient=stop_gradient)
