"""Learning-rate schedules as ops on one step counter (copy of
``paddle_tpu/learning_rate_decay.py``): ``exponential_decay``,
``natural_exp_decay``, ``inverse_time_decay``, ``polynomial_decay`` and
``piecewise_decay``.

Each appends a few elementwise ops computing the decayed LR from the
program's ``@LR_DECAY_COUNTER@`` (an int64 persistable that one
``increment`` advances once a step, read as float32) and returns the LR
Variable, which an optimizer takes as its ``learning_rate``. Every
schedule of a program reads the same counter. The ops run on the device
with no host branch (``b^x`` is ``exp(x ln b)``, ``piecewise_decay`` a
gather at the count of crossed boundaries), so a captured step computes
each step's LR, and the counter is a persistable that checkpoints carry.
"""
from __future__ import annotations

import math

from . import layers
from .layers.layer_helper import LayerHelper

__all__ = ["exponential_decay", "inverse_time_decay", "natural_exp_decay",
           "piecewise_decay", "polynomial_decay"]


def _decay_step_counter(begin=0):
    """The float32 view of the shared step counter: the first run reads
    ``begin``."""
    counter = layers.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return layers.cast(counter, "float32")


def _binary(op_type, x, y):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (step / decay_steps); ``staircase`` floors the
    exponent."""
    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = layers.floor(div)
    powed = layers.exp(layers.scale(div, scale=math.log(float(decay_rate))))
    return layers.scale(powed, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = layers.floor(div)
    return layers.scale(
        layers.exp(layers.scale(div, scale=-float(decay_rate))),
        scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    step = _decay_step_counter()
    div = layers.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = layers.floor(div)
    denom = layers.scale(div, scale=float(decay_rate), bias=1.0)
    return layers.scale(layers.reciprocal(denom), scale=float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - step / decay_steps) ^ power + end; with ``cycle``
    decay_steps grows to the next multiple past the step, without it the
    step stops at decay_steps. ``power`` other than 1 is
    ``exp(power * log(frac))``, frac clipped to [1e-12, 1]."""
    step = _decay_step_counter()
    if cycle:
        ratio = layers.scale(step, scale=1.0 / float(decay_steps))
        mult = layers.ceil(ratio)
        ones = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
        mult = _binary("elementwise_max", mult, ones)  # step 0: mult 1
        decay_var = layers.scale(mult, scale=float(decay_steps))
    else:
        decay_var = layers.fill_constant(shape=[1], dtype="float32",
                                         value=float(decay_steps))
        step = _binary("elementwise_min", step, decay_var)
    frac = 1.0 - step / decay_var
    if float(power) == 1.0:
        poly = frac
    else:
        safe = layers.clip(frac, min=1e-12, max=1.0)
        poly = layers.exp(layers.scale(layers.log(safe), scale=float(power)))
    return layers.scale(poly,
                        scale=float(learning_rate) - float(end_learning_rate),
                        bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """values[i] where boundaries[i-1] <= step < boundaries[i]: the count
    of boundaries crossed (``less_equal``, cast to float32 and summed)
    indexes the value table, one ``gather``."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _decay_step_counter()
    bounds = layers.assign([float(b) for b in boundaries])
    table = layers.assign([float(v) for v in values])
    crossed = layers.cast(_binary("less_equal", bounds, step), "float32")
    idx = layers.cast(layers.reduce_sum(crossed), "int32")
    idx = layers.reshape(idx, shape=[1])
    return layers.gather(table, idx)
