"""Initializers emitted as ops into the startup program (counterpart of
``paddle_tpu/initializer.py``): Constant, Uniform, Normal, Xavier and
the defaults ``create_parameter`` uses (Xavier for weights, zeros for
biases)."""
from __future__ import annotations

import math

__all__ = ["Constant", "ConstantInitializer", "Initializer", "Normal",
           "NormalInitializer", "Uniform", "UniformInitializer", "Xavier",
           "XavierInitializer", "default_bias_initializer",
           "default_weight_initializer"]


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(type="fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "value": self.value,
                               "dtype": str(var.dtype)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(type="uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "min": self.low,
                               "max": self.high, "seed": self.seed,
                               "dtype": str(var.dtype)})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(type="gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "mean": self.loc,
                               "std": self.scale, "seed": self.seed,
                               "dtype": str(var.dtype)})


def _fans(var):
    shape = var.shape
    if len(shape) <= 1:
        n = shape[0] if shape else 1
        return n, n
    if len(shape) == 2:
        return shape[0], shape[1]
    recept = 1
    for d in shape[2:]:
        recept *= d
    return shape[1] * recept, shape[0] * recept


class XavierInitializer(Initializer):
    """Glorot: uniform in ±sqrt(6 / (fan_in + fan_out)), or normal with
    std sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer


def default_weight_initializer():
    return XavierInitializer()


def default_bias_initializer():
    return ConstantInitializer(0.0)
