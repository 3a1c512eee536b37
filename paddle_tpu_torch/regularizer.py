"""Weight decay appended as ops on the gradients (copy of
``paddle_tpu/regularizer.py``): L2 adds ``coeff * p`` to a parameter's
gradient, L1 adds ``coeff * sign(p)``. A parameter's own regularizer
(``ParamAttr(regularizer=...)``) wins over the optimizer's
``regularization``."""
from __future__ import annotations

from .core import unique_name

__all__ = ["L1Decay", "L1DecayRegularizer", "L2Decay", "L2DecayRegularizer",
           "WeightDecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=unique_name.generate(param.name + "_l2decay"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=unique_name.generate(param.name + "_sign"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = block.create_var(
            name=unique_name.generate(param.name + "_l1decay"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff})
        return decay


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Each (param, grad) whose parameter has a regularizer, or when
    ``regularization`` is given, becomes (param, grad + decay term) by a
    ``sum`` op; the others pass through unchanged."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        term = reg(param, grad, block)
        new_grad = block.create_var(
            name=unique_name.generate(grad.name + "_reg"),
            shape=param.shape, dtype=param.dtype)
        block.append_op(type="sum", inputs={"X": [grad, term]},
                        outputs={"Out": [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads
