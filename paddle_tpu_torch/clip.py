"""Gradient clipping and error clipping (copy of ``paddle_tpu/clip.py``).

A parameter's ``gradient_clip_attr`` (``ParamAttr(gradient_clip=...)``
or :func:`set_gradient_clip`) rewrites its gradient in
:func:`append_gradient_clip_ops`, which ``Optimizer.minimize`` calls
before the regularization and the update:

- ``GradientClipByValue``: ``clip`` to [min, max];
- ``GradientClipByNorm``: ``clip_by_norm`` of each gradient alone;
- ``GradientClipByGlobalNorm``: every gradient of a group scaled by
  ``clip / max(clip, global_norm)``, the global norm the square root of
  the sum of the group's ``squared_l2_norm``s. The scale is computed
  on the device, with no host branch, so a captured step clips by each
  step's own norm. Each group's scale var is kept in the module dict
  ``_GLOBAL_NORM_SCALES`` under the group's name, as in the JAX
  package.
"""
from __future__ import annotations

from .core import ir, unique_name

__all__ = ["ErrorClipByValue", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue",
           "append_gradient_clip_ops", "set_gradient_clip"]


class BaseErrorClipAttr(object):
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = max, min

    def append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


class BaseGradientClipAttr(object):
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = float(max), float(min)

    def create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=unique_name.generate(grad.name + "_clip"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op(type="clip", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"min": self.min, "max": self.max})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=unique_name.generate(grad.name + "_clip"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op(type="clip_by_norm", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"max_norm": self.clip_norm})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale a group's gradients by clip / max(clip, their global norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        block = grad.block
        sq = block.create_var(name=unique_name.generate(grad.name + "_sq"),
                              shape=(1,), dtype=param.dtype)
        block.append_op(type="squared_l2_norm", inputs={"X": [grad]},
                        outputs={"Out": [sq]})
        context[self.group_name].append(sq)

    def create_operators(self, param, grad):
        # the group's scale, made once by append_gradient_clip_ops
        block = grad.block
        scale_var = _GLOBAL_NORM_SCALES[self.group_name]
        out = block.create_var(name=unique_name.generate(grad.name + "_clip"),
                               shape=param.shape, dtype=param.dtype)
        block.append_op(type="elementwise_mul",
                        inputs={"X": [grad], "Y": [scale_var]},
                        outputs={"Out": [out]}, attrs={"axis": -1})
        return param, out


_GLOBAL_NORM_SCALES = {}


def set_gradient_clip(clip, param_list=None, program=None):
    """Set ``clip`` on ``param_list`` (Parameters or names; default every
    parameter of ``program``)."""
    program = program or ir.default_main_program()
    param_list = param_list or program.all_parameters()
    for p in param_list:
        if isinstance(p, str):
            p = program.global_block().var(p)
        p.gradient_clip_attr = clip


def error_clip_callback(block, op_desc):
    pass


def append_gradient_clip_ops(param_grad):
    """Rewrite each (param, grad) by its parameter's clip attr; the
    global-norm groups get their norm and scale ops first."""
    context = {}
    todo = []
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None)
        if clip_attr is None:
            clip_attr = NullGradientClipAttr()
        clip_attr.process_context(context=context, param=p, grad=g)
        todo.append((p, g, clip_attr))

    # each global-norm group: scale = clip / max(clip, sqrt(sum of sq))
    for group_name, sq_list in list(context.items()):
        if group_name.endswith("_clip_value"):
            continue
        clip_value = context[group_name + "_clip_value"]
        block = sq_list[0].block
        gsum = block.create_var(name=unique_name.generate("gnorm_sum"),
                                shape=(1,), dtype="float32")
        block.append_op(type="sum", inputs={"X": sq_list},
                        outputs={"Out": [gsum]})
        gnorm = block.create_var(name=unique_name.generate("gnorm"),
                                 shape=(1,), dtype="float32")
        block.append_op(type="sqrt", inputs={"X": [gsum]},
                        outputs={"Out": [gnorm]})
        clipv = block.create_var(name=unique_name.generate("clipv"),
                                 shape=(1,), dtype="float32")
        block.append_op(type="fill_constant", outputs={"Out": [clipv]},
                        attrs={"shape": [1], "value": clip_value,
                               "dtype": "float32"})
        maxv = block.create_var(name=unique_name.generate("gnorm_max"),
                                shape=(1,), dtype="float32")
        block.append_op(type="elementwise_max",
                        inputs={"X": [gnorm], "Y": [clipv]},
                        outputs={"Out": [maxv]}, attrs={"axis": -1})
        scalev = block.create_var(name=unique_name.generate("gnorm_scale"),
                                  shape=(1,), dtype="float32")
        block.append_op(type="elementwise_div",
                        inputs={"X": [clipv], "Y": [maxv]},
                        outputs={"Out": [scalev]}, attrs={"axis": -1})
        _GLOBAL_NORM_SCALES[group_name] = scalev

    res = []
    for p, g, clip_attr in todo:
        if g is None:
            res.append((p, g))
        else:
            res.append(clip_attr.create_operators(param=p, grad=g))
    return res
