"""Sequence layers: RNNs, sequence ops, CRF, CTC, NCE (counterpart of
``paddle_tpu/layers/sequence.py``: ``dynamic_lstm`` :28,
``dynamic_lstmp`` :65, ``dynamic_gru`` :106, ``lstm_unit`` :131,
``gru_unit`` :153, ``sequence_conv`` :180, ``sequence_pool`` :201,
``sequence_first_step`` :227, ``sequence_last_step`` :231,
``sequence_softmax`` :235, ``sequence_expand`` :244, ``sequence_concat``
:253, ``sequence_reshape`` :263, ``sequence_reverse`` :273,
``sequence_slice`` :285, ``sequence_erase`` :301, ``lod_reset`` :310,
``row_conv`` :328, ``linear_chain_crf`` :343, ``crf_decoding`` :368,
``warpctc`` :382, ``ctc_greedy_decoder`` :394, ``chunk_eval`` :410,
``nce`` :433, ``kmax_seq_score`` :487 and ``sub_nested_seq`` :499).
Signatures, defaults, attrs, parameter shapes and generated names are
the JAX package's, so a program built in both under
``unique_name.guard()`` has the same ops and variables.
"""
from __future__ import annotations

from ..param_attr import ParamAttr
from .layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "lstm_unit", "gru_unit",
    "sequence_conv",
    "sequence_pool", "sequence_softmax", "sequence_expand", "sequence_concat",
    "sequence_reshape", "sequence_reverse", "sequence_slice",
    "sequence_erase",
    "sequence_first_step", "sequence_last_step", "lod_reset", "row_conv",
    "linear_chain_crf", "crf_decoding", "warpctc", "ctc_greedy_decoder",
    "chunk_eval", "nce", "kmax_seq_score", "sub_nested_seq",
]


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


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with a recurrent projection. ``size`` is ``4*hidden``,
    ``proj_size`` the projection width P. Returns (projection
    ``[T, P]``, cell ``[T, hidden]``)."""
    helper = LayerHelper("lstmp", **locals())
    hidden = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[proj_size, 4 * hidden],
                                     dtype=dtype)
    proj_weight = helper.create_parameter(
        ParamAttr(name=(name + ".w_proj") if name else None),
        shape=[hidden, proj_size], dtype=dtype)
    proj = helper.create_variable_for_type_inference(dtype)
    c = helper.create_variable_for_type_inference(dtype)
    proj.lod_level = c.lod_level = input.lod_level
    proj.shape = tuple(input.shape[:-1]) + (proj_size,)
    c.shape = tuple(input.shape[:-1]) + (hidden,)
    inputs = {"Input": [input], "Weight": [weight],
              "ProjWeight": [proj_weight]}
    if bias_attr is not False:
        bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr or ParamAttr(), shape=bias_size, dtype=dtype,
            is_bias=True)]
    helper.append_op(type="lstmp",
                     inputs=inputs,
                     outputs={"Projection": [proj], "Cell": [c]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation,
                            "proj_activation": proj_activation})
    return proj, c


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


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step on dense tensors: fc([x, h_prev]) to the 4D gates,
    then the cell update. Returns (hidden, cell)."""
    from . import nn as _nn
    from . import tensor as _tensor
    helper = LayerHelper("lstm_unit", **locals())
    size = cell_t_prev.shape[-1]
    concat_in = _tensor.concat([x_t, hidden_t_prev], axis=1)
    fc_out = _nn.fc(concat_in, size=4 * size, param_attr=param_attr,
                    bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c.shape = h.shape = cell_t_prev.shape
    helper.append_op(type="lstm_unit",
                     inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step; ``size`` is ``3*hidden``. Returns (hidden, reset
    hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", **locals())
    dtype = helper.input_dtype()
    hidden_dim = size // 3
    weight = helper.create_parameter(helper.param_attr,
                                     shape=[hidden_dim, 3 * hidden_dim],
                                     dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                   shape=[1, 3 * hidden_dim], dtype=dtype,
                                   is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_h = helper.create_variable_for_type_inference(dtype)
    updated = helper.create_variable_for_type_inference(dtype)
    updated.shape = hidden.shape
    helper.append_op(type="gru_unit",
                     inputs={"Input": [input], "HiddenPrev": [hidden],
                             "Weight": [weight], "Bias": [bias]},
                     outputs={"Gate": [gate], "ResetHiddenPrev": [reset_h],
                              "Hidden": [updated]},
                     attrs={"activation": activation,
                            "gate_activation": gate_activation})
    return updated, reset_h, gate


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    """The context window of ``filter_size`` rows (from -filter_size // 2)
    times a ``[filter_size * D, num_filters]`` filter, then the bias and
    ``act``."""
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    pre_bias.lod_level = input.lod_level
    pre_bias.shape = tuple(input.shape[:-1]) + (num_filters,)
    helper.append_op(type="sequence_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [pre_bias]},
                     attrs={"contextStride": filter_stride,
                            "contextStart": -int(filter_size // 2),
                            "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type, stride=-1):
    """Pool each sequence to one row (``pool_type``: sum, average or avg,
    sqrt, max, last, first). ``stride`` > 0 pools stride-sized windows
    within each sequence to a shorter sequence (the v1 SequencePoolLayer's
    stride), a host op."""
    if stride != -1 and stride <= 0:
        raise ValueError(
            "sequence_pool stride must be -1 (whole sequence) or > 0, "
            "got %r" % (stride,))
    helper = LayerHelper("sequence_pool", **locals())
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    max_index = helper.create_variable_for_type_inference(dtype="int32",
                                                          stop_gradient=True)
    if input.shape is not None:
        out.shape = tuple(input.shape)
    out.lod_level = (input.lod_level if stride > 0
                     else max(input.lod_level - 1, 0))
    attrs = {"pooltype": pool_type.upper()}
    if stride > 0:  # the default -1 is not written, as in the JAX layer
        attrs["stride"] = int(stride)
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs=attrs)
    return out


def sequence_first_step(input, stride=-1):
    return sequence_pool(input, "first", stride=stride)


def sequence_last_step(input, stride=-1):
    return sequence_pool(input, "last", stride=stride)


def sequence_softmax(input, name=None):
    helper = LayerHelper("sequence_softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape, out.lod_level = input.shape, input.lod_level
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape, out.lod_level = x.shape, max(y.lod_level, 1)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", **locals())
    inputs = input if isinstance(input, (list, tuple)) else [input]
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    out.lod_level = max(v.lod_level for v in inputs)
    helper.append_op(type="sequence_concat", inputs={"X": list(inputs)},
                     outputs={"Out": [out]})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.lod_level = input.lod_level
    out.shape = (input.shape[0], new_dim)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def sequence_reverse(x, name=None):
    """Reverse each sequence's rows in place."""
    helper = LayerHelper("sequence_reverse", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.lod_level = x.lod_level
    out.shape = x.shape
    helper.append_op(type="sequence_reverse", inputs={"X": [x]},
                     outputs={"Y": [out]})
    return out


def sequence_slice(input, offset, length, name=None):
    """``offset=None`` slices from each sequence's begin; ``length=None``
    slices to its end (v1 seq_slice_layer's open-ended sides)."""
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.lod_level = input.lod_level
    inputs = {"X": [input]}
    if offset is not None:
        inputs["Offset"] = [offset]
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="sequence_slice", inputs=inputs,
                     outputs={"Out": [out]})
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.lod_level = input.lod_level
    helper.append_op(type="sequence_erase", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"tokens": list(tokens)})
    return out


def lod_reset(x, y=None, target_lod=None):
    """X with Y's LoD, Y's values as offsets, or ``target_lod``."""
    helper = LayerHelper("lod_reset", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    out.lod_level = 1 if y is None else max(y.lod_level, 1)
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = list(target_lod)
    else:
        raise ValueError("lod_reset needs y or target_lod")
    helper.append_op(type="lod_reset", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution over ``future_context_size`` later
    rows, then ``act``."""
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape, out.lod_level = input.shape, input.lod_level
    helper.append_op(type="row_conv",
                     inputs={"X": [input], "Filter": [filter_param]},
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def linear_chain_crf(input, label, param_attr=None):
    """-log p(label | input) of a linear-chain CRF, one row a sequence;
    creates the ``[K + 2, K]`` transition (start, end, tag to tag)."""
    helper = LayerHelper("linear_chain_crf", **locals())
    size = input.shape[-1]
    transition = helper.create_parameter(helper.param_attr,
                                         shape=[size + 2, size],
                                         dtype=helper.input_dtype())
    alpha = helper.create_variable_for_type_inference(helper.input_dtype())
    emission_exps = helper.create_variable_for_type_inference(
        helper.input_dtype())
    transition_exps = helper.create_variable_for_type_inference(
        helper.input_dtype())
    log_likelihood = helper.create_variable_for_type_inference(
        helper.input_dtype())
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label]},
                     outputs={"Alpha": [alpha],
                              "EmissionExps": [emission_exps],
                              "TransitionExps": [transition_exps],
                              "LogLikelihood": [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """The Viterbi path under the transition named by ``param_attr``
    (``linear_chain_crf``'s, shared by name)."""
    helper = LayerHelper("crf_decoding", **locals())
    transition = helper.get_parameter(param_attr.name)
    viterbi_path = helper.create_variable_for_type_inference(dtype="int64")
    viterbi_path.lod_level = input.lod_level
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [viterbi_path]})
    return viterbi_path


def warpctc(input, label, blank=0, norm_by_times=False):
    """The CTC loss of each sequence of logits against its labels."""
    helper = LayerHelper("warpctc", **locals())
    loss_out = helper.create_variable_for_type_inference(input.dtype)
    grad_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="warpctc",
                     inputs={"Logits": [input], "Label": [label]},
                     outputs={"WarpCTCGrad": [grad_out], "Loss": [loss_out]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss_out


def ctc_greedy_decoder(input, blank, name=None):
    """argmax over the classes, then ``ctc_align`` (merge repeats, drop
    blanks)."""
    from . import tensor as _tensor
    helper = LayerHelper("ctc_greedy_decoder", **locals())
    top1 = _tensor.argmax(input, axis=-1)
    # the argmax indices keep the input's lod
    ids = lod_reset(top1, y=input)
    out = helper.create_variable_for_type_inference(dtype="int64")
    out.lod_level = 1
    helper.append_op(type="ctc_align", inputs={"Input": [ids]},
                     outputs={"Output": [out]},
                     attrs={"blank": blank, "merge_repeated": True})
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunk precision, recall, F1 and the three chunk counts."""
    helper = LayerHelper("chunk_eval", **locals())
    precision = helper.create_variable_for_type_inference(dtype="float32")
    recall = helper.create_variable_for_type_inference(dtype="float32")
    f1_score = helper.create_variable_for_type_inference(dtype="float32")
    num_infer = helper.create_variable_for_type_inference(dtype="int64")
    num_label = helper.create_variable_for_type_inference(dtype="int64")
    num_correct = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="chunk_eval",
                     inputs={"Inference": [input], "Label": [label]},
                     outputs={"Precision": [precision], "Recall": [recall],
                              "F1-Score": [f1_score],
                              "NumInferChunks": [num_infer],
                              "NumLabelChunks": [num_label],
                              "NumCorrectChunks": [num_correct]},
                     attrs={"num_chunk_types": num_chunk_types,
                            "chunk_scheme": chunk_scheme,
                            "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1_score, num_infer, num_label, num_correct


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, sampler="uniform",
        custom_dist=None):
    """Noise-contrastive estimation loss: the negative samples are drawn
    by an int sampler op of their own (uniform, ``log_uniform`` or
    ``custom_dist``) and fed to a deterministic ``nce_core``, so that its
    generic grad replays with no randomness."""
    helper = LayerHelper("nce", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[-1]
    num_neg = num_neg_samples or 10
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_total_classes, dim], dtype=dtype)
    b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                shape=[num_total_classes, 1], dtype=dtype,
                                is_bias=True)
    samples = helper.create_variable_for_type_inference(dtype="int64",
                                                        stop_gradient=True)
    if sampler == "log_uniform":
        helper.append_op(type="log_uniform_random_int",
                         outputs={"Out": [samples]},
                         attrs={"shape": [num_neg],
                                "range": num_total_classes})
    elif sampler == "custom_dist":
        if custom_dist is None:
            raise ValueError(
                "nce(sampler='custom_dist') requires custom_dist (a "
                "[num_total_classes] probability variable)")
        helper.append_op(type="custom_dist_random_int",
                         inputs={"Probs": [custom_dist]},
                         outputs={"Out": [samples]},
                         attrs={"shape": [num_neg]})
    else:
        helper.append_op(type="uniform_random_int",
                         outputs={"Out": [samples]},
                         attrs={"shape": [num_neg], "low": 0,
                                "high": num_total_classes})
    cost = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w],
              "Bias": [b], "Samples": [samples]}
    if sampler == "custom_dist":
        inputs["CustomDistProbs"] = [custom_dist]
    helper.append_op(type="nce_core",
                     inputs=inputs,
                     outputs={"Cost": [cost]},
                     attrs={"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg,
                            "sampler": sampler})
    cost.shape = (input.shape[0], 1)
    return cost


def kmax_seq_score(input, beam_size=1, name=None):
    """The ``beam_size`` best positions within each sequence of a
    ``[total, 1]`` score: ``[n_seqs, beam_size]`` int64, -1 padded."""
    helper = LayerHelper("kmax_seq_score", **locals())
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="kmax_seq_score", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"beam_size": beam_size})
    return out


def sub_nested_seq(input, selected_indices, name=None):
    """The sub-sequences of a nested sequence picked by per-outer-sequence
    indices (``[n_outer, k]``, -1 padded), as a 1-level sequence."""
    helper = LayerHelper("sub_nested_seq", **locals())
    out = helper.create_variable_for_type_inference(
        helper.input_dtype())
    helper.append_op(type="sub_nested_seq",
                     inputs={"X": [input],
                             "SelectedIndices": [selected_indices]},
                     outputs={"Out": [out]})
    return out
