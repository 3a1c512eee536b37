"""Generated thin layers over registered unary ops, and ``gather``
(counterpart of ``paddle_tpu/layers/ops.py:13-46``): one layer per op of
the unary table, each appending its op on X with the attrs it is
given."""
from __future__ import annotations

import sys

from .layer_helper import LayerHelper

_UNARY = [
    "sigmoid", "logsigmoid", "tanh", "relu", "relu6", "exp", "abs", "ceil",
    "floor", "round", "log", "square", "sqrt", "reciprocal", "softplus",
    "softsign", "sin", "cos", "tanh_shrink", "softshrink", "hard_shrink",
    "sign", "brelu", "leaky_relu", "soft_relu", "elu", "swish", "stanh",
    "hard_sigmoid", "thresholded_relu", "pow", "logical_not", "cumsum",
]

__all__ = list(_UNARY) + ["gather"]


def _make_unary(op_type):
    def layer(x, **attrs):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s of X (a generated layer)." % op_type
    return layer


_mod = sys.modules[__name__]
for _op in _UNARY:
    setattr(_mod, _op, _make_unary(_op))


def gather(input, index):
    """Rows of ``input`` at ``index``."""
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out
