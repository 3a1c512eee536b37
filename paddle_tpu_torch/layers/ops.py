"""Generated thin layers over registered unary ops, ``gather``,
``scatter``, ``uniform_random`` and ``gaussian_random`` (counterpart of
``paddle_tpu/layers/ops.py``: the table :13-46, ``scatter`` :55,
``uniform_random`` :66, ``gaussian_random`` :76): one layer per op of the
unary table, each appending its op on X with the attrs it is given."""
from __future__ import annotations

import sys

from .layer_helper import LayerHelper

_UNARY = [
    "sigmoid", "logsigmoid", "tanh", "relu", "relu6", "exp", "abs", "ceil",
    "floor", "round", "log", "square", "sqrt", "reciprocal", "softplus",
    "softsign", "sin", "cos", "tanh_shrink", "softshrink", "hard_shrink",
    "sign", "brelu", "leaky_relu", "soft_relu", "elu", "swish", "stanh",
    "hard_sigmoid", "thresholded_relu", "pow", "logical_not", "isfinite",
    "cumsum",
]

__all__ = list(_UNARY) + ["gather", "scatter", "uniform_random",
                          "gaussian_random"]


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


def scatter(input, index, updates, overwrite=True):
    """``input`` with the rows at ``index`` replaced by ``updates``."""
    helper = LayerHelper("scatter")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "min": min, "max": max, "seed": seed})
    out.shape = tuple(shape)
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "mean": mean, "std": std, "seed": seed})
    out.shape = tuple(shape)
    return out
