"""Unary op layers (the matching part of ``paddle_tpu/layers/ops.py``):
``cumsum``."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["cumsum"]


def cumsum(x, **attrs):
    """Cumulative sum; attrs ``axis``, ``exclusive``, ``reverse``."""
    helper = LayerHelper("cumsum")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="cumsum", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out
