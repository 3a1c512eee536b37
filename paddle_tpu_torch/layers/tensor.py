"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``create_tensor`` :22,
``create_parameter`` :28, ``create_global_var`` :37, ``cast``,
``concat`` :58, ``sums``, ``assign`` (of a Variable, or of a Python or
numpy value through ``assign_value``), ``fill_constant``,
``fill_constant_batch_size_like``, ``ones`` :120, ``zeros`` :124,
``argmax`` :128, ``argmin`` :136, ``reverse`` :144,
``autoincreased_step_counter`` and ``increment``."""
from __future__ import annotations

import numpy as np

from ..core import ir
from ..core.types import convert_dtype
from .layer_helper import LayerHelper

__all__ = ["argmax", "argmin", "assign", "autoincreased_step_counter",
           "cast", "concat", "create_global_var", "create_parameter",
           "create_tensor", "fill_constant", "fill_constant_batch_size_like",
           "increment", "ones", "reverse", "sums", "zeros"]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A parameter of ``shape`` in both programs, initialized in the
    startup program by ``default_initializer`` (else the default weight
    or bias initializer)."""
    from ..param_attr import ParamAttr
    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr.to_attr(attr) if attr else ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A global variable filled with ``value`` by the startup program."""
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(dtype=dtype, shape=shape,
                                        persistable=persistable,
                                        name=name)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype())
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=helper.input_dtype())
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    """A copy of a Variable (``assign``), or a Python or numpy value as a
    constant of its own dtype (``assign_value``)."""
    helper = LayerHelper("assign")
    if isinstance(input, ir.Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    else:
        value = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                dtype=str(value.dtype))
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(value.shape), "values": value,
                                "dtype": str(value.dtype)})
    return output


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis if isinstance(axis, (list, tuple))
                            else [axis]})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable int64 counter, incremented by ``step`` once a run;
    the first value a run reads is ``begin``. The default name is the
    fixed ``@STEP_COUNTER@``, and a counter that exists is returned as it
    is, with no second ``increment``: every caller shares one step."""
    from ..initializer import ConstantInitializer
    name = counter_name or "@STEP_COUNTER@"
    block = ir.default_main_program().global_block()
    if block.has_var(name):
        return block.var(name)
    helper = LayerHelper("global_step_counter")
    counter = helper.create_global_variable(
        name=name, shape=(1,), dtype="int64", persistable=True)
    helper.set_variable_initializer(
        counter, ConstantInitializer(begin - step))
    increment(counter, value=step, in_place=True)
    counter.stop_gradient = True
    return counter


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out
