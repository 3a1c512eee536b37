"""Operator sugar on Variables (copy of
``paddle_tpu/layers/math_op_patch.py``): ``a + b``, ``1.0 - a``,
``a / b``, ``a <= b`` append ops. A Python scalar becomes a ``scale``
where one can express the op, a ``fill_constant`` of X's shape
otherwise; comparisons give ``bool`` and go through the comparison
layers of ``control_flow.py``."""
from __future__ import annotations

from ..core import ir

__all__ = ["binary"]

_COMPARISONS = ("less_than", "less_equal", "greater_than", "greater_equal",
                "equal", "not_equal")


def binary(x, other, op, reverse=False):
    """``x <op> other`` (``other <op> x`` with ``reverse``), appended to
    x's program."""
    prog = x.block.program
    if prog is not ir.default_main_program():
        # ops on vars of a non-default program land in that program
        old = ir.switch_main_program(prog)
        try:
            return _binary(x, other, op, reverse)
        finally:
            ir.switch_main_program(old)
    return _binary(x, other, op, reverse)


def _binary(x, other, op, reverse=False):
    from .layer_helper import LayerHelper
    helper = LayerHelper(op)
    if isinstance(other, (int, float)):
        if op == "elementwise_add":
            return _scale(helper, x, 1.0, float(other))
        if op == "elementwise_sub":
            if reverse:
                return _scale(helper, x, -1.0, float(other))
            return _scale(helper, x, 1.0, -float(other))
        if op == "elementwise_mul":
            return _scale(helper, x, float(other), 0.0)
        if op == "elementwise_div" and not reverse:
            return _scale(helper, x, 1.0 / float(other), 0.0)
        const = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type="fill_constant", outputs={"Out": [const]},
                         attrs={"shape": list(x.shape or (1,)),
                                "value": float(other),
                                "dtype": str(x.dtype)})
        other = const
    a, b = (other, x) if reverse else (x, other)
    if op in _COMPARISONS:
        # through the comparison layers of control_flow.py
        from .control_flow import _cmp
        out = _cmp(op, a, b, cond=helper.create_variable_for_type_inference(
            dtype="bool"), helper=helper, attrs={"axis": -1})
        out.shape = x.shape
        return out
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type=op, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def _scale(helper, x, scale, bias):
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": True})
    return out
