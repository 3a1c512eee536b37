"""NN layers of the transformer LM, of ResNet and their losses and
metrics, the math layers of the optimization surface (``log``,
``reduce_*``, ``clip``, ``clip_by_norm``, ``elementwise_*``), and the
dense tensor and loss layers (``smooth_l1`` :294,
``sigmoid_cross_entropy_with_logits`` :425, ``matmul`` :488, ``mul``
:498, ``dot`` :508, ``slice`` :605, ``cos_sim`` :616, ``one_hot`` :629,
``pad`` :668, ``label_smooth`` :676, ``transpose`` :693, ``split`` :701,
``concat_nn`` :721, ``expand`` :725, ``squeeze`` :729, ``unsqueeze``
:733), the rest of the conv-net path's layers (``dropout`` :86 to
``edit_distance`` :755, listed where they are defined), and
``im2sequence`` :737 and ``hsigmoid`` :775 of the sequence layers; the
matching part of
``paddle_tpu/layers/nn.py``: each appends ops to the current block.
Names are generated in the JAX package's order, so a program built in
both packages under ``unique_name.guard()`` has the same variables."""
from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..param_attr import ParamAttr
from .layer_helper import LayerHelper

__all__ = ["accuracy", "auc", "batch_norm", "clip", "clip_by_norm",
           "concat_nn", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "cos_sim", "cross_entropy", "dot", "dropout",
           "edit_distance", "elementwise_add", "elementwise_div",
           "elementwise_mul", "elementwise_sub", "embedding", "expand", "fc",
           "hsigmoid", "im2sequence", "l2_normalize", "label_smooth", "layer_norm", "log", "lrn",
           "matmul", "maxout", "mean", "mul", "one_hot", "pad", "pool2d",
           "pool3d", "prelu", "reduce_max", "reduce_mean", "reduce_min",
           "reduce_sum", "relu", "reshape", "scale",
           "sigmoid_cross_entropy_with_logits", "slice", "smooth_l1",
           "softmax", "softmax_with_cross_entropy", "split",
           "square_error_cost", "squeeze", "topk", "transpose", "unsqueeze"]


def _pair(v):
    return [v, v] if isinstance(v, int) else v


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected: a mul per input (flattened by
    ``num_flatten_dims``), a sum when there are several, bias, act."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr_ in helper.iter_inputs_and_params():
        param_shape = [int(np.prod(input_var.shape[num_flatten_dims:]))] \
            + [size]
        w = helper.create_parameter(param_attr_, shape=param_shape,
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        # the mul keeps its input's sequences (the reference's mul shares
        # X's LoD); the JAX package drops the level here (ROADMAP.md
        # Queue 3 #23)
        tmp.lod_level = input_var.lod_level
        helper.append_op(type="mul", inputs={"X": [input_var], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        pre_bias.lod_level = mul_results[0].lod_level
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """A ``lookup_table`` op over a [size[0], size[1]] parameter."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(helper.param_attr, shape=size, dtype=dtype,
                                is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    in_shape = input.shape or (-1, 1)
    tmp.shape = tuple(in_shape[:-1] if in_shape[-1] == 1 else in_shape) \
        + (size[1],)
    tmp.lod_level = input.lod_level
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table", inputs={"Ids": [input], "W": [w]},
                     outputs={"Out": [tmp]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": padding_idx})
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """A ``conv2d`` op, NCHW input and OIHW filter initialized
    ``Normal(0, sqrt(2 / fan_in))``, then bias and act."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    filter_size, stride, padding, dilation = (
        _pair(v) for v in (filter_size, stride, padding, dilation))
    filter_shape = [num_filters, input.shape[1] // groups] + list(filter_size)
    fan_in = filter_shape[1] * filter_shape[2] * filter_shape[3]
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv2d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "use_cudnn": use_cudnn})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool2d", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode,
                            "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None):
    """A ``batch_norm`` op. The running Mean and Variance are persistable
    parameters that the op reads and writes (MeanOut/VarianceOut), so
    they update in the program."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    param_shape = [channels]
    scale = helper.create_parameter(
        helper.param_attr, shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        helper.bias_attr if helper.bias_attr else ParamAttr(),
        shape=param_shape, dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False),
        shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False),
        shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = input if in_place else \
        helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout})
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            helper.param_attr, shape=param_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr if helper.bias_attr else ParamAttr(),
            shape=param_shape, dtype=dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = input.shape
    mean_out = helper.create_variable_for_type_inference(dtype, True)
    var_out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean_out],
                              "Variance": [var_out]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False):
    """Per-row cross entropy [N, 1] of probabilities ``input``."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]}, attrs={"soft_label": soft_label})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy: a ``top_k`` op and an ``accuracy`` op."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32")
    if total is None:
        total = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def _simple(op_type, x, attrs=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs=attrs or {})
    return out


def square_error_cost(input, label):
    """(input - label) ** 2 elementwise (``paddle_tpu/layers/nn.py:434``)."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def mean(x, name=None):
    return _simple("mean", x)


def relu(x, name=None):
    return _simple("relu", x)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": scale, "bias": bias,
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def log(x, name=None):
    return _simple("log", x)


def _reduce(op_type, input, dim, keep_dim, name):
    """``dim`` None reduces every dim (``reduce_all``)."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def clip(x, min, max, name=None):
    return _simple("clip", x, {"min": min, "max": max})


def clip_by_norm(x, max_norm, name=None):
    return _simple("clip_by_norm", x, {"max_norm": max_norm})


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out) if act else out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out) if act else out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0):
    """Per-row smooth-L1 loss [N, 1], built of elementwise ops as the
    JAX layer builds it: with a = |(x - y) * inside_weight| and t =
    1 / sigma^2, 0.5 sigma^2 min(a, t)^2 + (a - min(a, t)), times
    outside_weight, summed over dim 1."""
    from .. import layers as _F
    diff = _F.elementwise_sub(x, y)
    if inside_weight is not None:
        diff = _F.elementwise_mul(diff, inside_weight)
    s2 = float(sigma) * float(sigma)
    t = 1.0 / s2
    a = _F.abs(diff)
    amin = _F.clip(a, 0.0, t)
    quad = _F.scale(_F.elementwise_mul(amin, amin), scale=0.5 * s2)
    per_elem = _F.elementwise_add(quad, _F.elementwise_sub(a, amin))
    if outside_weight is not None:
        per_elem = _F.elementwise_mul(per_elem, outside_weight)
    return _F.reduce_sum(per_elem, dim=1, keep_dim=True)


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    helper = LayerHelper("mul")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def dot(x, y, name=None):
    """sum(x * y) over the last dim, kept as a dim of 1."""
    helper = LayerHelper("dot", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reduce_sum", inputs={"X": [x * y]},
                     outputs={"Out": [out]},
                     attrs={"dim": [-1], "keep_dim": True})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity [N, 1] of X and Y."""
    helper = LayerHelper("cos_sim", **locals())
    out = helper.create_variable_for_type_inference(dtype=X.dtype)
    xnorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    ynorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    out.shape = (X.shape[0], 1) if X.shape else None
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    return _simple("pad", x, {"paddings": paddings, "pad_value": pad_value})


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    """(1 - epsilon) label + epsilon prior, the prior uniform when
    ``prior_dist`` is None: ``scale`` and ``elementwise_add`` ops, as the
    JAX layer appends (not the ``label_smooth`` op)."""
    if prior_dist is None:
        return scale(label, 1.0 - epsilon, epsilon / label.shape[-1])
    prior_term = scale(prior_dist, epsilon)
    return elementwise_add(scale(label, 1.0 - epsilon), prior_term)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """``input`` cut along ``dim`` into ``num_or_sections`` equal pieces
    (an int) or pieces of the listed sizes: the list of outputs."""
    helper = LayerHelper("split", **locals())
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    n_out = num if num else len(sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n_out)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "num": num, "sections": sections})
    return outs


def concat_nn(input, axis=0, name=None):
    from .tensor import concat as _concat
    return _concat(input, axis, name)


def expand(x, expand_times, name=None):
    return _simple("expand", x, {"expand_times": list(expand_times)})


def squeeze(input, axes, name=None):
    return _simple("squeeze", input, {"axes": list(axes)})


def unsqueeze(input, axes, name=None):
    return _simple("unsqueeze", input, {"axes": list(axes)})


# -- the rest of the conv-net path (``paddle_tpu/layers/nn.py``: dropout
# :86, conv2d_transpose :136, conv3d_transpose :176, conv3d :239, pool3d
# :273, auc :461, l2_normalize :601, lrn :645, prelu :655, maxout :672,
# edit_distance :755)

def _triple(v):
    return [v] * 3 if isinstance(v, int) else v


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    """A ``dropout`` op: Out, and the Mask its grad reads."""
    helper = LayerHelper("dropout", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    mask = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed if seed is not None else 0})
    return out


def _check_groups(layer, num_filters, num_channels, groups):
    if num_filters % groups or num_channels % groups:
        raise ValueError(
            "%s: num_filters (%d) and input channels (%d) must both be "
            "divisible by groups (%d)"
            % (layer, num_filters, num_channels, groups))


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, use_cudnn=True, act=None, name=None,
                     groups=None):
    """A ``conv2d_transpose`` op with an IOHW filter [C, F / G, kh, kw]
    (its size from ``output_size`` when ``filter_size`` is None), then
    bias and act."""
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    _check_groups("conv2d_transpose", num_filters, num_channels, groups)
    stride, padding, dilation = (_pair(v) for v in (stride, padding,
                                                    dilation))
    if filter_size is None:
        h, w = input.shape[2], input.shape[3]
        oh, ow = output_size if isinstance(output_size, (list, tuple)) \
            else (output_size, output_size)
        filter_size = [oh - (h - 1) * stride[0] + 2 * padding[0],
                       ow - (w - 1) * stride[1] + 2 * padding[1]]
    else:
        filter_size = _pair(filter_size)
    w = helper.create_parameter(
        helper.param_attr, dtype=dtype,
        shape=[num_channels, num_filters // groups] + list(filter_size))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, param_attr=None,
                     bias_attr=None, act=None, name=None, groups=None):
    """conv2d_transpose one dim up: NCDHW, filter IODHW."""
    helper = LayerHelper("conv3d_transpose", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    stride, padding, dilation = (_triple(v) for v in (stride, padding,
                                                      dilation))
    if filter_size is None:
        dims = input.shape[2:5]
        osz = output_size if isinstance(output_size, (list, tuple)) \
            else [output_size] * 3
        filter_size = [osz[i] - (dims[i] - 1) * stride[i] + 2 * padding[i]
                       for i in range(3)]
    else:
        filter_size = _triple(filter_size)
    groups = groups or 1
    _check_groups("conv3d_transpose", num_filters, num_channels, groups)
    w = helper.create_parameter(
        helper.param_attr, dtype=dtype,
        shape=[num_channels, num_filters // groups] + list(filter_size))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv3d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None,
           name=None):
    """A ``conv3d`` op, NCDHW input and OIDHW filter initialized
    ``Normal(0, sqrt(2 / fan_in))``, then bias and act."""
    helper = LayerHelper("conv3d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    filter_size, stride, padding, dilation = (
        _triple(v) for v in (filter_size, stride, padding, dilation))
    filter_shape = [num_filters, input.shape[1] // groups] + list(filter_size)
    fan_in = int(np.prod(filter_shape[1:]))
    w = helper.create_parameter(
        helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="conv3d",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [pre_bias]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           name=None):
    helper = LayerHelper("pool3d", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(type="pool3d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _triple(pool_size),
                            "strides": _triple(pool_stride),
                            "paddings": _triple(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode})
    return out


def auc(input, label, curve="ROC", num_thresholds=200, topk=1):
    """An ``auc`` op over the (N, 2) softmax or (N, 1) sigmoid
    probability: a scalar."""
    helper = LayerHelper("auc")
    auc_out = helper.create_variable_for_type_inference("float32")
    auc_out.shape = ()
    auc_out.stop_gradient = True
    helper.append_op(type="auc", inputs={"Out": [input], "Label": [label]},
                     outputs={"AUC": [auc_out]},
                     attrs={"curve": curve,
                            "num_thresholds": num_thresholds})
    return auc_out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    return _simple("l2_normalize", x, {"axis": axis, "epsilon": epsilon})


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    """An ``lrn`` op (the layer's k defaults to 1.0, the op's to 2.0)."""
    helper = LayerHelper("lrn", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """A ``prelu`` op with its Alpha parameter (0.25): one slope
    (``all``), one a channel (``channel``), or X's shape past the batch
    dim (``element``)."""
    helper = LayerHelper("prelu", **locals())
    alpha_shape = [1] if mode == "all" else \
        ([x.shape[1]] if mode == "channel" else list(x.shape[1:]))
    alpha = helper.create_parameter(
        helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None):
    return _simple("maxout", x, {"groups": groups})


def edit_distance(input, label, normalized=False, ignored_tokens=None,
                  name=None):
    """The Levenshtein distance of each dense hypothesis row to its
    reference: ([N, 1] distances, [1] the row count). ``ignored_tokens``
    rides along as an attr, as in the JAX layer."""
    helper = LayerHelper("edit_distance", **locals())
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized,
                            "ignored_tokens": list(ignored_tokens or [])})
    return out, seq_num


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """Each ``filter_size`` window of the image a row: ``[N * oh * ow,
    C * kh * kw]``. ``padding``: one int, (h, w), or (up, left, down,
    right)."""
    helper = LayerHelper("im2sequence", **locals())
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if len(padding) == 2:
        padding = padding + padding
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": filter_size, "strides": stride,
                            "paddings": padding})
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """The hierarchical sigmoid cost over a complete binary tree of
    ``num_classes`` leaves: W ``[num_classes - 1, D]`` and, unless
    ``bias_attr`` is False, a bias ``[num_classes - 1, 1]``."""
    helper = LayerHelper("hierarchical_sigmoid", **locals())
    dtype = helper.input_dtype()
    dim = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_classes - 1, dim], dtype=dtype)
    b = None
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr or ParamAttr(),
                                    shape=[num_classes - 1, 1], dtype=dtype,
                                    is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = (input.shape[0], 1)
    helper.append_op(type="hierarchical_sigmoid",
                     inputs={"X": [input], "W": [w], "Label": [label],
                             "Bias": [b] if b is not None else []},
                     outputs={"Out": [out]},
                     attrs={"num_classes": num_classes})
    return out
