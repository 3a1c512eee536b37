"""LayerHelper: shared parameter and variable creation for the layers
DSL (copy of ``paddle_tpu/layers/layer_helper.py``). A parameter is
created in both the startup program (with its init op) and the main
program; ops go to the main program's current block."""
from __future__ import annotations

import copy

from ..core import ir, unique_name
from ..initializer import default_bias_initializer, default_weight_initializer
from ..param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        if self.kwargs.get("name") is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return ir.default_main_program()

    @property
    def startup_program(self):
        return ir.default_startup_program()

    @property
    def main_block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.main_block.append_op(*args, **kwargs)

    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, ir.Variable):
            return [inputs]
        return list(inputs)

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [copy.deepcopy(attr) for _ in range(length)]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        for i, a in zip(inputs, attrs):
            yield i, a

    def input_dtype(self, input_param_name="input"):
        dtype = None
        for v in self.multiple_input(input_param_name):
            if dtype is None:
                dtype = v.dtype
            elif dtype != v.dtype:
                raise ValueError("mixed input dtypes in %s"
                                 % self.layer_type)
        return dtype

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        assert isinstance(attr, ParamAttr)
        attr = copy.deepcopy(attr)
        if attr.name is None:
            attr.name = unique_name.generate(
                ".".join([self.name, "w" if not is_bias else "b"]))
        init = attr.initializer or default_initializer
        if init is None:
            init = (default_bias_initializer() if is_bias
                    else default_weight_initializer())
        startup_block = self.startup_program.global_block()
        sp = startup_block.create_parameter(shape=shape, dtype=dtype,
                                            **attr.to_kwargs())
        init(sp, startup_block)
        return self.main_block.create_parameter(shape=shape, dtype=dtype,
                                                **attr.to_kwargs())

    def get_parameter(self, name):
        """The main program's variable ``name`` (a parameter another
        layer created, as ``crf_decoding`` shares ``linear_chain_crf``'s
        transition)."""
        v = self.main_program.global_block()._find_var_recursive(name)
        if v is None:
            raise ValueError("parameter %r not found" % name)
        return v

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_block.create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs)

    def set_variable_initializer(self, var, initializer):
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        initializer(sv, sb)
        return sv

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.lod_level = getattr(input_var, "lod_level", 0)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = copy.deepcopy(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.lod_level = getattr(input_var, "lod_level", 0)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
