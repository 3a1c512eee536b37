"""Sequence layers of the stacked-RNN text classifier (the matching part
of ``paddle_tpu/layers/sequence.py``: ``dynamic_lstm`` :28,
``dynamic_gru`` :106, ``sequence_pool`` :201, ``sequence_first_step``
:227 and ``sequence_last_step`` :231). Signatures, parameter shapes and
generated names are the JAX package's.

Not ported yet (later slices): ``dynamic_lstmp``, ``lstm_unit``,
``gru_unit``, ``sequence_conv``, the other ``sequence_*`` layers,
``row_conv``, CRF, CTC, NCE and ``chunk_eval``.
"""
from __future__ import annotations

from ..param_attr import ParamAttr
from .layer_helper import LayerHelper

__all__ = ["dynamic_gru", "dynamic_lstm", "sequence_first_step",
           "sequence_last_step", "sequence_pool"]


def dynamic_lstm(input, size, param_attr=None, bias_attr=None,
                 use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 h_0=None, c_0=None):
    """Whole-sequence LSTM over a ragged (LoD) batch. ``input`` is the
    ``[T, 4*hidden]`` projection (apply fc first); ``size`` is
    ``4*hidden``. Returns (hidden, cell), each ``[T, hidden]``."""
    helper = LayerHelper("lstm", **locals())
    hidden = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[hidden, 4 * hidden], dtype=dtype)
    h = helper.create_variable_for_type_inference(dtype)
    c = helper.create_variable_for_type_inference(dtype)
    h.lod_level = c.lod_level = input.lod_level
    h.shape = c.shape = tuple(input.shape[:-1]) + (hidden,)
    inputs = {"Input": [input], "Weight": [weight]}
    if bias_attr is not False:
        bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr or ParamAttr(), shape=bias_size, dtype=dtype,
            is_bias=True)]
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="lstm", inputs=inputs,
                     outputs={"Hidden": [h], "Cell": [c]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return h, c


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32",
                name=None):
    """Whole-sequence GRU. ``input`` is the ``[T, 3*size]`` projection;
    returns hidden ``[T, size]``."""
    helper = LayerHelper("gru", **locals())
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    h = helper.create_variable_for_type_inference(dtype)
    h.lod_level = input.lod_level
    h.shape = tuple(input.shape[:-1]) + (size,)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(type="gru", inputs=inputs, outputs={"Hidden": [h]},
                     attrs={"is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "activation": candidate_activation})
    return h


def sequence_pool(input, pool_type, stride=-1):
    """Pool each sequence to one row (``pool_type``: sum, average or avg,
    sqrt, max, last, first). ``stride`` > 0 (stride windows) is not
    ported and raises."""
    if stride != -1:
        raise NotImplementedError(
            "sequence_pool stride windows are not ported to "
            "paddle_tpu_torch yet (stride=%r)" % (stride,))
    helper = LayerHelper("sequence_pool", **locals())
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    max_index = helper.create_variable_for_type_inference(dtype="int32",
                                                          stop_gradient=True)
    if input.shape is not None:
        out.shape = tuple(input.shape)
    out.lod_level = max(input.lod_level - 1, 0)
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, stride=-1):
    return sequence_pool(input, "first", stride=stride)


def sequence_last_step(input, stride=-1):
    return sequence_pool(input, "last", stride=stride)
