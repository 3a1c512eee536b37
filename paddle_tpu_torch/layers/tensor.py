"""Tensor layers of the transformer LM (the matching part of
``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

from ..core.types import convert_dtype
from .layer_helper import LayerHelper

__all__ = ["cast", "fill_constant", "fill_constant_batch_size_like"]


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    out.shape = x.shape
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": str(x.dtype),
                            "out_dtype": str(convert_dtype(dtype))})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": str(convert_dtype(dtype)),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """``shape`` with dim ``output_dim_idx`` taken from ``input``'s dim
    ``input_dim_idx`` at run time, filled with ``value``."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": str(convert_dtype(dtype)),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out
