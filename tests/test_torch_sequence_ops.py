"""The sequence ops of the port against their JAX lowerings, on the CPU:
the 25 ops of ``ops/sequence_ops.py`` that the sequence slice ports,
``im2sequence`` of ``ops/nn_ops.py``, and ``hierarchical_sigmoid``,
``log_uniform_random_int`` and ``custom_dist_random_int`` of
``ops/misc_ops.py``; ``sequence_pool``'s stride windows and the
``lstm`` / ``gru`` ops on a 2-level LoD.

Each case runs one op alone in a program of each package
(``torch_optim.one_op``) on the same seeded numpy inputs (ragged ones
with empty and length-1 sequences, and 2-level ones where the op takes
them); a gradient comes from each package's ``append_backward`` of
mean(out * w), w a seeded feed. Tolerances:
- integer outputs, offsets and decoded paths are equal, and so is the
  LoD each output carries (or not); an integer output is int64 in the
  port and may be int32 in JAX, whose 64-bit types are off (ROADMAP
  Queue 3 #26): their values are equal;
- float outputs and gradients are within 1e-6 of max(1, |the JAX
  value|) (``OP_TOL``);
- the samplers agree in distribution only (the port draws from a
  ``torch.Generator``, JAX from threefry; Queue 3 #30): 2^16 draws within
  4 standard errors a bucket of the law's share.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu.ops  # noqa: E402,F401
from paddle_tpu.core import registry as jreg  # noqa: E402
import paddle_tpu_torch.ops  # noqa: E402,F401
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import registry as treg  # noqa: E402
from paddle_tpu_torch.core.executor import (  # noqa: E402
    Executor as TExecutor, FunctionalContext, LoDValue)
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.ops import misc_ops as tmisc  # noqa: E402
from torch_optim import (JAX, OP_TOL, PORT, feed_of, lod_of,  # noqa: E402
                         one_op, one_op_program, op_types, rel, run_once,
                         value_of)

NEW_OPS = (
    "sequence_softmax", "sequence_expand", "sequence_concat",
    "sequence_reshape", "lod_reset", "sequence_reverse", "kmax_seq_score",
    "sub_nested_seq", "sequence_slice", "sequence_erase", "ctc_align",
    "chunk_eval", "sequence_conv", "context_project", "row_conv", "lstmp",
    "lstm_unit", "gru_unit", "simple_rnn", "linear_chain_crf",
    "crf_decoding", "warpctc", "uniform_random_int", "nce_core",
    "lambda_rank_cost", "im2sequence", "hierarchical_sigmoid",
    "log_uniform_random_int", "custom_dist_random_int")
DRAWS = 1 << 16
Z_GATE = 4.0
# float32 noise of the gradient of an impossible CTC alignment, measured
# against float64 (both packages ~2.5e-3 on the CPU)
CTC_F32_NOISE = 5e-3


def _r(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _offs(lengths):
    return [int(v) for v in np.concatenate([[0], np.cumsum(lengths)])]


def _seq(seed, lengths, width, scale=1.0):
    """A ragged float input (array, lod) of ``lengths``."""
    return (_r(seed, sum(lengths), width, scale=scale), [_offs(lengths)])


def _ids(seed, lengths, high, low=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(low, high, (sum(lengths), 1)).astype(np.int64),
            [_offs(lengths)])


def _assert_match(j, t, names):
    """Each port fetch against the JAX one: same LoD and shape; integer
    values equal (int64 in the port), floats within OP_TOL."""
    for n, jv, tv in zip(names, j, t):
        jl, tl = lod_of(jv), lod_of(tv)
        if n.endswith("@GRAD") and jl is not None and tl is not None and \
                np.asarray(jl[0]).dtype.kind not in "iu":
            jl = tl      # JAX's gradient of a LoD input: float0 offsets
        assert tl == (None if jl is None else [list(map(int, lv))
                                               for lv in jl]), (n, tl, jl)
        ja, ta = value_of(jv), value_of(tv)
        assert ta.shape == ja.shape, (n, ta.shape, ja.shape)
        if np.issubdtype(ja.dtype, np.integer) or ja.dtype == np.bool_:
            assert ta.dtype in (ja.dtype, np.int64), (n, ta.dtype, ja.dtype)
            np.testing.assert_array_equal(ta, ja, err_msg=n)
        else:
            assert ta.dtype == ja.dtype, (n, ta.dtype, ja.dtype)
            assert rel(ta, ja) <= OP_TOL, (n, rel(ta, ja))


LENS = [3, 1, 0, 5, 2]             # an empty and a length-1 sequence
LENS2 = [[2, 3], [1, 2, 0, 4, 2]]   # 2-level: 2 outer over 5 inner


def _nested(seed, width):
    outer = _offs(LENS2[0])
    inner = _offs(LENS2[1])
    return (_r(seed, inner[-1], width), [outer, inner])


def _crf_inputs(seed, lengths, K):
    return {"Emission": [("em", _seq(seed, lengths, K))],
            "Transition": [("tr", _r(seed + 1, K + 2, K, scale=0.5))],
            "Label": [("lab", _ids(seed + 2, lengths, K))]}


def _ctc(seed, x_lens, y_lens, K, blank, labels=None):
    lab = _ids(seed + 1, y_lens, K, low=0)
    if labels is not None:
        lab = (np.asarray(labels, np.int64).reshape(-1, 1), [_offs(y_lens)])
    return {"Logits": [("x", _seq(seed, x_lens, K))], "Label": [("y", lab)]}


def _stride_cases():
    out = []
    for ptype in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
        for stride in (1, 3, 9):
            out.append(("stride_%s_%d" % (ptype.lower(), stride),
                        "sequence_pool", {"X": [("x", _seq(stride, LENS, 3))]},
                        {"Out": ["o"]}, {"pooltype": ptype, "stride": stride},
                        ("x",), None))
    return out


def _nce(sampler, bias=True):
    rng = np.random.RandomState(len(sampler))
    C, D, S = 13, 6, 5
    inputs = {"Input": [("x", _r(30, 7, D))],
              "Label": [("lab", rng.randint(0, C, (7, 1)).astype(np.int64))],
              "Weight": [("w", _r(31, C, D, scale=0.5))],
              "Samples": [("s", rng.randint(0, C, (S,)).astype(np.int64))]}
    if bias:
        inputs["Bias"] = [("b", _r(32, C, 1, scale=0.3))]
    diff = ("x", "w") + (("b",) if bias else ())
    if sampler == "custom_dist":
        p = rng.rand(C).astype(np.float32) + 0.05
        inputs["CustomDistProbs"] = [("p", p / p.sum())]
    return ("nce_core_%s%s" % (sampler, "" if bias else "_no_bias"),
            "nce_core", inputs, {"Cost": ["o"]},
            {"num_total_classes": C, "num_neg_samples": S,
             "sampler": sampler}, diff, None)


_LSTMP_IN = lambda rev, peep, init: (  # noqa: E731
    {"Input": [("x", _seq(40, LENS, 4 * 3, scale=0.5))],
     "Weight": [("w", _r(41, 2, 12, scale=0.4))],
     "ProjWeight": [("wp", _r(42, 3, 2, scale=0.4))],
     "Bias": [("b", _r(43, 1, (7 if peep else 4) * 3, scale=0.2))]}
    | ({"H0": [("h0", _r(44, 5, 2, scale=0.3))],
        "C0": [("c0", _r(45, 5, 3, scale=0.3))]} if init else {}))

# (id, op, inputs, outputs, attrs, diff, loss_of)
CASES = [
    ("sequence_softmax", "sequence_softmax",
     {"X": [("x", _seq(1, LENS, 1))]}, {"Out": ["o"]}, {}, ("x",), None),
    ("sequence_softmax_nested", "sequence_softmax",
     {"X": [("x", _nested(2, 1))]}, {"Out": ["o"]}, {}, ("x",), None),
    ("sequence_expand_row_per_seq", "sequence_expand",
     {"X": [("x", _r(3, 5, 4))], "Y": [("y", _seq(4, LENS, 2))]},
     {"Out": ["o"]}, {}, ("x",), None),
    ("sequence_expand_seq_per_seq", "sequence_expand",
     {"X": [("x", _seq(5, [2, 1, 1, 3, 1], 4))],
      "Y": [("y", _seq(6, [4, 3, 0, 3, 2], 2))]},
     {"Out": ["o"]}, {}, ("x",), None),
    ("sequence_expand_nested_y", "sequence_expand",
     {"X": [("x", _r(7, 2, 3))], "Y": [("y", _nested(8, 2))]},
     {"Out": ["o"]}, {}, ("x",), None),
    ("sequence_concat", "sequence_concat",
     {"X": [("a", _seq(9, LENS, 3)), ("b", _seq(10, [0, 2, 1, 1, 3], 3)),
            ("c", _seq(11, [1, 1, 1, 1, 1], 3))]},
     {"Out": ["o"]}, {}, ("a", "b", "c"), None),
    ("sequence_reshape_wider", "sequence_reshape",
     {"X": [("x", _seq(12, [2, 4, 0, 2], 3))]}, {"Out": ["o"]},
     {"new_dim": 6}, ("x",), None),
    ("sequence_reshape_narrower", "sequence_reshape",
     {"X": [("x", _seq(13, LENS, 4))]}, {"Out": ["o"]}, {"new_dim": 2},
     ("x",), None),
    ("lod_reset_target_lod", "lod_reset", {"X": [("x", _r(14, 11, 2))]},
     {"Out": ["o"]}, {"target_lod": [0, 4, 4, 5, 11]}, ("x",), None),
    ("lod_reset_lod_y", "lod_reset",
     {"X": [("x", _seq(15, [5, 6], 2))], "Y": [("y", _seq(16, LENS, 1))]},
     {"Out": ["o"]}, {}, ("x",), None),
    ("lod_reset_plain_y", "lod_reset",
     {"X": [("x", _r(17, 11, 2))],
      "Y": [("y", np.array([0, 2, 2, 7, 11], np.int64))]},
     {"Out": ["o"]}, {}, ("x",), None),
    ("sequence_reverse", "sequence_reverse", {"X": [("x", _seq(18, LENS, 3))]},
     {"Y": ["o"]}, {}, ("x",), None),
    ("sequence_reverse_nested", "sequence_reverse",
     {"X": [("x", _nested(19, 2))]}, {"Y": ["o"]}, {}, ("x",), None),
    ("kmax_seq_score", "kmax_seq_score",
     {"X": [("x", _seq(20, LENS, 1))]}, {"Out": ["o"]}, {"beam_size": 3},
     (), None),
    ("kmax_seq_score_ties", "kmax_seq_score",
     {"X": [("x", (np.array([[1.], [2.], [2.], [1.], [2.], [0.], [0.]],
                            np.float32), [[0, 5, 7]]))]},
     {"Out": ["o"]}, {"beam_size": 4}, (), None),
    ("sub_nested_seq", "sub_nested_seq",
     {"X": [("x", _nested(21, 3))],
      "SelectedIndices": [("sel", np.array([[1, 0, -1], [2, 5, 0]],
                                           np.int64))]},
     {"Out": ["o"]}, {}, ("x",), None),
    ("sequence_slice", "sequence_slice",
     {"X": [("x", _seq(22, LENS, 2))],
      "Offset": [("off", np.array([[1], [0], [0], [2], [1]], np.int64))],
      "Length": [("len", np.array([[2], [1], [0], [3], [0]], np.int64))]},
     {"Out": ["o"]}, {}, (), None),
    ("sequence_slice_open_length", "sequence_slice",
     {"X": [("x", _seq(23, LENS, 2))],
      "Offset": [("off", np.array([[1], [1], [0], [4], [0]], np.int64))]},
     {"Out": ["o"]}, {}, (), None),
    ("sequence_erase", "sequence_erase", {"X": [("x", _ids(24, LENS, 5))]},
     {"Out": ["o"]}, {"tokens": [0, 3]}, (), None),
    ("ctc_align", "ctc_align",
     {"Input": [("x", (np.array([[1], [1], [0], [2], [2], [0], [0], [3],
                                 [1], [1]], np.int64), [[0, 6, 6, 7, 10]]))]},
     {"Output": ["o"]}, {"blank": 0, "merge_repeated": True}, (), None),
    ("ctc_align_no_merge_blank2", "ctc_align",
     {"Input": [("x", _ids(25, LENS, 4))]},
     {"Output": ["o"]}, {"blank": 2, "merge_repeated": False}, (), None),
    ("sequence_conv", "sequence_conv",
     {"X": [("x", _seq(26, LENS, 3))],
      "Filter": [("f", _r(27, 9, 4, scale=0.5))]},
     {"Out": ["o"]}, {"contextLength": 3, "contextStart": -1,
                      "contextStride": 1}, ("x", "f"), None),
    ("sequence_conv_start_m2_len4", "sequence_conv",
     {"X": [("x", _seq(28, LENS, 2))],
      "Filter": [("f", _r(29, 8, 3, scale=0.5))]},
     {"Out": ["o"]}, {"contextLength": 4, "contextStart": -2},
     ("x", "f"), None),
    ("sequence_conv_default_start", "sequence_conv",
     {"X": [("x", _seq(33, [1, 2, 1], 2))],
      "Filter": [("f", _r(34, 10, 2, scale=0.5))]},
     {"Out": ["o"]}, {"contextLength": 5}, ("x", "f"), None),
    ("context_project_zeros", "context_project",
     {"X": [("x", _seq(35, LENS, 3))]}, {"Out": ["o"]},
     {"contextLength": 3, "contextStart": -1}, ("x",), None),
    ("context_project_padding_m1", "context_project",
     {"X": [("x", _seq(36, LENS, 3))],
      "PaddingData": [("pad", _r(37, 2, 3))]}, {"Out": ["o"]},
     {"contextLength": 3, "contextStart": -1}, ("x", "pad"), None),
    ("context_project_padding_m2_short", "context_project",
     {"X": [("x", _seq(38, [1, 2, 0, 3], 2))],
      "PaddingData": [("pad", _r(39, 4, 2))]}, {"Out": ["o"]},
     {"contextLength": 5, "contextStart": -2}, ("x", "pad"), None),
    ("row_conv", "row_conv",
     {"X": [("x", _seq(46, LENS, 3))],
      "Filter": [("f", _r(47, 3, 3, scale=0.5))]},
     {"Out": ["o"]}, {}, ("x", "f"), None),
    ("lstmp_peep", "lstmp", _LSTMP_IN(False, True, False),
     {"Projection": ["o"], "Cell": ["c"]}, {}, ("x", "w", "wp", "b"), None),
    ("lstmp_rev_init_no_peep_relu", "lstmp", _LSTMP_IN(True, False, True),
     {"Projection": ["o"], "Cell": ["c"]},
     {"use_peepholes": False, "is_reverse": True,
      "proj_activation": "relu", "candidate_activation": "relu"},
     ("x", "w", "wp", "b", "h0", "c0"), None),
    ("lstm_unit", "lstm_unit",
     {"X": [("x", _r(48, 4, 12))], "C_prev": [("c", _r(49, 4, 3))]},
     {"C": ["cn"], "H": ["o"]}, {"forget_bias": 0.5}, ("x", "c"), None),
    ("gru_unit", "gru_unit",
     {"Input": [("x", _r(50, 4, 9))], "HiddenPrev": [("h", _r(51, 4, 3))],
      "Weight": [("w", _r(52, 3, 9, scale=0.5))],
      "Bias": [("b", _r(53, 1, 9, scale=0.2))]},
     {"Gate": ["g"], "ResetHiddenPrev": ["rh"], "Hidden": ["o"]}, {},
     ("x", "h", "w", "b"), None),
    ("gru_unit_relu_no_bias", "gru_unit",
     {"Input": [("x", _r(54, 4, 9))], "HiddenPrev": [("h", _r(55, 4, 3))],
      "Weight": [("w", _r(56, 3, 9, scale=0.5))]},
     {"Gate": ["g"], "ResetHiddenPrev": ["rh"], "Hidden": ["o"]},
     {"activation": "relu", "gate_activation": "sigmoid"},
     ("x", "h", "w"), None),
    ("simple_rnn", "simple_rnn",
     {"Input": [("x", _seq(57, LENS, 3))],
      "Weight": [("w", _r(58, 3, 3, scale=0.5))],
      "Bias": [("b", _r(59, 1, 3, scale=0.2))]},
     {"Hidden": ["o"]}, {}, ("x", "w", "b"), None),
    ("simple_rnn_reverse_relu", "simple_rnn",
     {"Input": [("x", _seq(60, LENS, 3))],
      "Weight": [("w", _r(61, 3, 3, scale=0.5))]},
     {"Hidden": ["o"]}, {"is_reverse": True, "activation": "relu"},
     ("x", "w"), None),
    ("linear_chain_crf", "linear_chain_crf", _crf_inputs(62, LENS, 4),
     {"LogLikelihood": ["o"], "Alpha": ["a"], "EmissionExps": ["ee"],
      "TransitionExps": ["te"]}, {}, ("em", "tr"), None),
    ("linear_chain_crf_t1", "linear_chain_crf", _crf_inputs(63, [1, 1, 1], 3),
     {"LogLikelihood": ["o"]}, {}, ("em", "tr"), None),
    ("crf_decoding", "crf_decoding",
     {k: v for k, v in _crf_inputs(64, LENS, 4).items() if k != "Label"},
     {"ViterbiPath": ["o"]}, {}, (), None),
    ("crf_decoding_label", "crf_decoding", _crf_inputs(65, LENS, 4),
     {"ViterbiPath": ["o"]}, {}, (), None),
    ("crf_decoding_t1", "crf_decoding",
     {k: v for k, v in _crf_inputs(66, [1, 1], 3).items() if k != "Label"},
     {"ViterbiPath": ["o"]}, {}, (), None),
    ("warpctc", "warpctc", _ctc(67, [6, 4, 7], [3, 2, 4], 5, 0),
     {"Loss": ["o"]}, {}, ("x",), None),
    ("warpctc_repeats", "warpctc",
     _ctc(68, [6, 5], [3, 2], 4, 0, labels=[1, 1, 2, 3, 3]),
     {"Loss": ["o"]}, {}, ("x",), None),
    # the loss only: its gradient is float32 noise in both packages
    # (test_warpctc_gradient_of_an_impossible_alignment_is_float32_noise)
    ("warpctc_label_longer_than_input", "warpctc",
     _ctc(69, [2, 5], [4, 2], 5, 0), {"Loss": ["o"]}, {}, (), None),
    ("warpctc_blank3_norm_by_times", "warpctc",
     _ctc(70, [6, 4, 5], [2, 3, 1], 5, 3, labels=[1, 2, 0, 4, 2, 1]),
     {"Loss": ["o"]}, {"blank": 3, "norm_by_times": True}, ("x",), None),
    ("warpctc_empty_label", "warpctc",
     _ctc(71, [4, 3], [0, 2], 4, 0, labels=[2, 1]),
     {"Loss": ["o"]}, {}, ("x",), None),
    _nce("uniform"), _nce("log_uniform"), _nce("custom_dist"),
    _nce("uniform", bias=False),
    ("lambda_rank_cost", "lambda_rank_cost",
     {"Score": [("s", _seq(72, [4, 1, 5], 1))],
      "Label": [("r", (np.random.RandomState(73).randint(0, 3, (10, 1))
                       .astype(np.float32), [[0, 4, 5, 10]]))]},
     {"Out": ["o"]}, {"ndcg_num": 3}, ("s",), None),
    ("lambda_rank_cost_ties", "lambda_rank_cost",
     {"Score": [("s", (np.array([[1.], [1.], [0.5], [2.], [2.], [2.]],
                                np.float32), [[0, 3, 6]]))],
      "Label": [("r", (np.array([[2.], [0.], [1.], [1.], [0.], [2.]],
                                np.float32), [[0, 3, 6]]))]},
     {"Out": ["o"]}, {"ndcg_num": 5}, ("s",), None),
    ("im2sequence", "im2sequence", {"X": [("x", _r(74, 2, 3, 5, 6))]},
     {"Out": ["o"]}, {"kernels": [2, 3], "strides": [1, 1],
                      "paddings": [0, 0, 0, 0]}, ("x",), None),
    ("im2sequence_stride_padding", "im2sequence",
     {"X": [("x", _r(75, 2, 2, 7, 5))]},
     {"Out": ["o"]}, {"kernels": [3, 2], "strides": [2, 3],
                      "paddings": [1, 0, 2, 1]}, ("x",), None),
    ("hierarchical_sigmoid", "hierarchical_sigmoid",
     {"X": [("x", _r(76, 6, 4))], "W": [("w", _r(77, 6, 4, scale=0.5))],
      "Label": [("lab", np.array([[0], [6], [3], [5], [1], [2]], np.int64))],
      "Bias": [("b", _r(78, 6, 1, scale=0.3))]},
     {"Out": ["o"]}, {"num_classes": 7}, ("x", "w", "b"), None),
    ("hierarchical_sigmoid_no_bias", "hierarchical_sigmoid",
     {"X": [("x", _r(79, 5, 3))], "W": [("w", _r(80, 4, 3, scale=0.5))],
      "Label": [("lab", np.array([[0], [4], [2], [3], [1]], np.int64))]},
     {"Out": ["o"]}, {"num_classes": 5}, ("x", "w"), None),
    ("lstm_nested", "lstm",
     {"Input": [("x", _nested(81, 8))], "Weight": [("w", _r(82, 2, 8,
                                                            scale=0.4))],
      "Bias": [("b", _r(83, 1, 14, scale=0.2))]},
     {"Hidden": ["o"], "Cell": ["c"]}, {"is_reverse": True},
     ("x", "w", "b"), None),
    ("gru_nested", "gru",
     {"Input": [("x", _nested(84, 6))], "Weight": [("w", _r(85, 2, 6,
                                                            scale=0.4))],
      "Bias": [("b", _r(86, 1, 6, scale=0.2))]},
     {"Hidden": ["o"]}, {}, ("x", "w", "b"), None),
] + _stride_cases()

# the host ops' cases, and chunk_eval's (tested below)
HOST = ("sequence_slice", "sequence_erase", "ctc_align", "chunk_eval")


def test_the_29_ops_are_registered_as_in_jax():
    """The slice's 29 op types, each among the JAX package's, with
    JAX's ``host`` (``sequence_pool``'s predicate too) and
    ``no_gradient`` settings, the same kind of grad maker and shape
    inference; 209 op types in all with this slice, 233 since the control
    flow slice's 24."""
    assert len(NEW_OPS) == 29 and len(set(NEW_OPS)) == 29
    port = [op for op in treg.registered_ops() if treg.lookup(
        op).lower.__module__.startswith("paddle_tpu_torch.")]
    assert len(port) == 233 and set(port) <= set(jreg.registered_ops())
    for op in NEW_OPS:
        t, j = treg.lookup(op), jreg.lookup(op)
        assert t is not None, op
        assert t.host == j.host, op
        assert t.no_gradient == j.no_gradient, op
        assert (t.grad_maker is None) == (j.grad_maker is None), op
        assert (t.infer_shape is None) == (j.infer_shape is None), op
    for stride, host in ((-1, False), (0, False), (2, True)):
        blk = tir.Program().global_block()
        op = blk.append_op(type="sequence_pool", inputs={}, outputs={},
                           attrs={"stride": stride})
        assert treg.op_is_host(treg.lookup("sequence_pool"), op) is host
        assert jreg.lookup("sequence_pool").host(op) is host


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_and_its_grad_match_jax(case):
    _, op, inputs, outputs, attrs, diff, loss_of = case
    if op in HOST:
        # JAX's host ops gather with numpy, which its generic grad cannot
        # trace (test_sequence_slice_grad_raises_in_jax_only)
        diff = ()
    j, t, names, jmain, tmain = one_op(op, inputs, outputs, attrs, diff,
                                       loss_of)
    _assert_match(j, t, names)
    assert op_types(tmain) == op_types(jmain)


def _ctc_port_grad(inputs, w, dtype):
    """The port's warpctc loss and d(mean(loss * w))/d logits in
    ``dtype``, by autograd of the lowering."""
    x, lod = inputs["Logits"][0][1]
    y, ylod = inputs["Label"][0][1]
    xv = torch.tensor(x, dtype=dtype, requires_grad=True)
    ins = {"Logits": [LoDValue(xv, (torch.tensor(lod[0]),), max_lens=(
               int(np.diff(lod[0]).max()),))],
           "Label": [LoDValue(torch.tensor(y), (torch.tensor(ylod[0]),),
                              max_lens=(int(np.diff(ylod[0]).max()),))]}
    blk = tir.Program().global_block()
    fop = blk.append_op(type="warpctc", inputs={}, outputs={"Loss": ["o"]},
                        attrs={})
    ctx = FunctionalContext(fop, ins, {}, torch.device("cpu"),
                            type="warpctc")
    treg.lookup("warpctc").lower(ctx)
    loss = ctx.collected["Loss"][0]
    (loss * torch.tensor(w, dtype=dtype)).mean().backward()
    return loss.detach().double().numpy(), xv.grad.double().numpy()


def test_warpctc_gradient_of_an_impossible_alignment_is_float32_noise():
    """A label longer than its input has no alignment: optax's DP gives
    it a loss near -log_epsilon times the missing steps (1e5 here), whose
    float32 step (2^-7) dwarfs a log-probability's ulp, so the gradient
    behind it is float32 noise in both packages (ROADMAP Queue 3 #31):
    each within CTC_F32_NOISE of the port's float64 gradient, and so of
    each other, the loss within OP_TOL. The port's float32 DP is the
    float64 one's within OP_TOL where an alignment exists (``warpctc``
    above)."""
    inputs = _ctc(69, [2, 5], [4, 2], 5, 0)
    j, t, names, _, _ = one_op("warpctc", inputs, {"Loss": ["o"]}, {},
                               ("x",))
    w = np.random.RandomState(0).randn(2, 1).astype(np.float32)
    l64, g64 = _ctc_port_grad(inputs, w, torch.float64)
    _, g32 = _ctc_port_grad(inputs, w, torch.float32)
    assert value_of(j[0])[0, 0] > 1e5 - 10 and value_of(j[0])[1, 0] < 10
    assert rel(value_of(t[0]), value_of(j[0])) <= OP_TOL
    assert rel(value_of(t[0]), l64) <= OP_TOL
    np.testing.assert_allclose(value_of(t[1]), g32, rtol=0, atol=0)
    jerr, terr = rel(value_of(j[1]), g64), rel(g32, g64)
    assert 1e-4 < jerr <= CTC_F32_NOISE and 1e-4 < terr <= CTC_F32_NOISE
    assert rel(g32, value_of(j[1])) <= CTC_F32_NOISE
    # with an alignment, float32 and float64 agree
    ok = _ctc(67, [6, 4, 7], [3, 2, 4], 5, 0)
    w3 = np.random.RandomState(0).randn(3, 1).astype(np.float32)
    assert rel(_ctc_port_grad(ok, w3, torch.float32)[1],
               _ctc_port_grad(ok, w3, torch.float64)[1]) <= OP_TOL


def test_stride_pool_of_a_nested_input_raises_in_both():
    inputs = {"X": [("x", _nested(1, 2))]}
    for pkg in (JAX, PORT):
        main = one_op_program(pkg, "sequence_pool", inputs, {"Out": ["o"]},
                              {"pooltype": "SUM", "stride": 2})
        with pytest.raises(NotImplementedError, match="nested"):
            run_once(pkg, main, feed_of(pkg, inputs), ["o"])


def test_sequence_slice_grad_raises_in_jax_only():
    """JAX's ``sequence_slice`` copies its input to numpy, which its
    generic grad (``jax.vjp``) cannot trace; the port gathers the rows
    in torch, so the gradient is the slice's scatter of the cotangent."""
    x = _seq(7, LENS, 2)
    inputs = {"X": [("x", x)],
              "Offset": [("off", np.array([[1], [0], [0], [2], [1]],
                                          np.int64))],
              "Length": [("len", np.array([[2], [1], [0], [3], [0]],
                                          np.int64))]}
    w = _r(8, 6, 2)
    jmain = one_op_program(JAX, "sequence_slice", inputs, {"Out": ["o"]},
                           diff=("x",), loss_of="o", loss_w=w)
    with pytest.raises(Exception, match="Tracer"):
        run_once(JAX, jmain, feed_of(JAX, inputs, w), ["x@GRAD"])
    tmain = one_op_program(PORT, "sequence_slice", inputs, {"Out": ["o"]},
                           diff=("x",), loss_of="o", loss_w=w)
    g, = run_once(PORT, tmain, feed_of(PORT, inputs, w), ["x@GRAD"])
    want = np.zeros_like(x[0])
    rows = [1, 2, 3, 6, 7, 8]      # each slice's rows in the input
    want[rows] = w / w.size
    np.testing.assert_allclose(value_of(g), want, rtol=1e-6)
    assert lod_of(g) == x[1]


@pytest.mark.parametrize("scheme,excluded", [
    ("IOB", None), ("IOE", None), ("IOBES", None), ("plain", None),
    ("IOB", [1])])
def test_chunk_eval_matches_jax(scheme, excluded):
    n_pos = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    types = 3
    rng = np.random.RandomState(len(scheme))
    lens = [6, 0, 1, 9, 4]
    hi = types * n_pos + 1          # one tag past the chunk tags: O
    lab = rng.randint(0, hi, (sum(lens), 1)).astype(np.int64)
    inf = np.where(rng.rand(*lab.shape) < 0.3,
                   rng.randint(0, hi, lab.shape), lab).astype(np.int64)
    lod = [_offs(lens)]
    inputs = {"Inference": [("inf", (inf, lod))],
              "Label": [("lab", (lab, lod))]}
    outputs = {"Precision": ["p"], "Recall": ["r"], "F1-Score": ["f"],
               "NumInferChunks": ["ni"], "NumLabelChunks": ["nl"],
               "NumCorrectChunks": ["nc"]}
    attrs = {"num_chunk_types": types, "chunk_scheme": scheme}
    if excluded:
        attrs["excluded_chunk_types"] = excluded
    j, t, names, _, _ = one_op("chunk_eval", inputs, outputs, attrs)
    for n, jv, tv in zip(names, j, t):
        ja, ta = value_of(jv), value_of(tv)
        assert ta.shape == (1,) and ta.dtype == (
            np.float32 if n in ("p", "r", "f") else np.int64), (n, ta.dtype)
        np.testing.assert_array_equal(ta, ja.astype(ta.dtype), err_msg=n)
    assert value_of(t[3])[0] > 0 and value_of(t[5])[0] > 0


def test_offsets_the_port_makes_are_int64():
    """Where the JAX ops make int32 offsets (``lod_reset`` from a plain
    Y, ``sequence_concat``, ``sub_nested_seq``, the host ops), the
    port's are int64, the index type of torch (ROADMAP Queue 3 #26); a
    fetch returns the same offsets as lists."""
    x = LoDValue(torch.randn(5, 2), (torch.tensor([0, 2, 5]),),
                 max_lens=(3,))
    y = LoDValue(torch.randn(4, 2), (torch.tensor([0, 1, 4]),),
                 max_lens=(3,))
    ids = LoDValue(torch.tensor([[1], [2], [0]]), (torch.tensor([0, 1, 3]),),
                   max_lens=(2,))
    for op, ins, slot in (
            ("sequence_concat", {"X": [x, y]}, "Out"),
            ("lod_reset", {"X": [torch.randn(3, 2)],
                           "Y": [torch.tensor([0, 1, 3], dtype=torch.int32)]},
             "Out"),
            ("lod_reset_attr", {"X": [torch.randn(3, 2)]}, "Out"),
            ("sequence_erase", {"X": [ids]}, "Out"),
            ("ctc_align", {"Input": [ids]}, "Output")):
        typ = "lod_reset" if op == "lod_reset_attr" else op
        attrs = {"target_lod": [0, 3]} if op == "lod_reset_attr" else {}
        blk = tir.Program().global_block()
        fop = blk.append_op(type=typ, inputs={}, outputs={slot: ["o"]},
                            attrs=attrs)
        ctx = FunctionalContext(fop, ins, attrs, torch.device("cpu"),
                                type=typ)
        treg.lookup(typ).lower(ctx)
        out = ctx.collected[slot][0]
        assert all(lv.dtype == torch.int64 for lv in out.lod), op


def _lod_reset_then_lstm(pkg):
    """lod_reset of a plain Y, then an lstm: its longest sequence is
    known only from the offsets' values."""
    L = pkg.layers
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        x = L.data("x", shape=[4, 8], dtype="float32",
                   append_batch_size=False)
        offs = L.data("offs", shape=[3], dtype="int64",
                      append_batch_size=False)
        h, _ = L.dynamic_lstm(L.lod_reset(x, y=offs), size=8,
                              use_peepholes=False)
    return main, start, h


@pytest.mark.parametrize("use_jit", [False, True])
def test_lod_reset_from_a_plain_y_then_a_scan_op(use_jit):
    """The per-op path counts the longest sequence from the offsets, and
    both packages agree; a compiled step raises the JAX package's
    ``jit`` message in both."""
    feed = {"x": _r(1, 4, 8), "offs": np.array([0, 1, 4], np.int64)}
    outs = {}
    for pkg in (JAX, PORT):
        main, start, h = _lod_reset_then_lstm(pkg)
        if pkg is JAX:
            scope, exe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
            with jpt.scope_guard(scope):
                exe.run(start)
                state = {v.name: np.asarray(scope.find_var(v.name))
                         for v in main.list_vars() if v.persistable}

                def run():
                    return exe.run(main, feed=feed, fetch_list=[h],
                                   use_jit=use_jit)
                if use_jit:
                    with pytest.raises(ValueError,
                                       match="static max sequence length"):
                        run()
                    continue
                outs["jax"] = value_of(run()[0])
        else:
            from paddle_tpu_torch.core.scope import scope_from_numpy
            tscope = TScope()
            scope_from_numpy(state, device="cpu", scope=tscope)

            def run():
                return TExecutor("cpu").run(main, feed=feed, fetch_list=[h],
                                            scope=tscope, use_jit=use_jit)
            if use_jit:
                with pytest.raises(ValueError,
                                   match="static max sequence length"):
                    run()
                continue
            outs["port"] = value_of(run()[0])
    if not use_jit:
        assert rel(outs["port"], outs["jax"]) <= OP_TOL


def _draws(op, inputs, attrs):
    main = one_op_program(PORT, op, inputs, {"Out": ["o"]}, attrs)
    main.random_seed = 5
    return value_of(TExecutor("cpu").run(
        main, feed=feed_of(PORT, inputs), fetch_list=["o"],
        scope=TScope())[0])


def _z(counts, p):
    share = counts / counts.sum()
    return np.abs(share - p) / np.sqrt(p * (1 - p) / counts.sum())


@pytest.mark.parametrize("op", ["uniform_random_int",
                                "log_uniform_random_int",
                                "custom_dist_random_int"])
def test_sampler_agrees_with_jax_in_distribution(op):
    """2^16 draws of each package: in range, int64 in the port, and each
    bucket's share within Z_GATE standard errors of the law's."""
    probs = np.array([0.1, 0.0, 0.5, 0.15, 0.25], np.float32)
    if op == "uniform_random_int":
        inputs, attrs = {}, {"shape": [DRAWS], "low": 2, "high": 9}
        p = np.r_[np.zeros(2), np.full(7, 1 / 7)]
    elif op == "log_uniform_random_int":
        inputs, attrs = {}, {"shape": [DRAWS], "range": 50}
        k = np.arange(50)
        p = np.log((k + 2.0) / (k + 1.0)) / math.log(51.0)
    else:
        inputs = {"Probs": [("probs", probs)]}
        attrs = {"shape": [DRAWS]}
        p = probs / probs.sum()
    got = {}
    for pkg in (JAX, PORT):
        if pkg is JAX:
            main = one_op_program(JAX, op, inputs, {"Out": ["o"]}, attrs)
            main.random_seed = 5
            got["jax"] = value_of(run_once(JAX, main, feed_of(JAX, inputs),
                                           ["o"])[0])
        else:
            got["port"] = _draws(op, inputs, attrs)
    assert got["port"].dtype == np.int64 and got["port"].shape == (DRAWS,)
    for name, v in got.items():
        assert v.min() >= 0 and v.max() < len(p), name
        counts = np.bincount(v, minlength=len(p)).astype(np.float64)
        live = p > 0
        assert not counts[~live].any(), name
        assert (_z(counts, p)[live] <= Z_GATE).all(), (name, _z(counts, p))
    assert not np.array_equal(got["port"], got["jax"])


def test_log_uniform_prob_matches_jax():
    from paddle_tpu.ops import misc_ops as jmisc
    import jax.numpy as jnp
    k = np.arange(0, 100, 7)
    want = np.asarray(jmisc.log_uniform_prob(jnp.asarray(k), 100))
    got = tmisc.log_uniform_prob(torch.as_tensor(k), 100).numpy()
    assert rel(got, want) <= OP_TOL


@pytest.mark.parametrize("op", ["relu", "tanh"])
def test_relu_and_tanh_keep_their_input_lod(op):
    """ROADMAP Queue 3 #31: the port's ``relu`` and ``tanh`` (and
    ``relu_grad``) took a LoD input as a plain tensor and raised
    (``sequence_conv``'s act, the role tagger's tanh fcs); like JAX's
    activations they keep its LoD."""
    x = _seq(3, LENS, 3)
    j, t, names, _, _ = one_op(op, {"X": [("x", x)]}, {"Out": ["o"]}, {},
                               ("x",))
    _assert_match(j, t, names)
    assert lod_of(t[0]) == x[1]


def _grad_nodes(out):
    """How many autograd nodes of each kind lie behind ``out``."""
    seen, stack, names = set(), [out.grad_fn], {}
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        name = type(fn).__name__
        names[name] = names.get(name, 0) + 1
        stack.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("op", ["lstm", "gru", "lstmp", "simple_rnn",
                                "linear_chain_crf", "warpctc"])
def test_time_loops_take_their_steps_by_unbind(op):
    """ROADMAP Queue 3 #32: a time loop that took step t as ``xs[t]``
    left T select nodes whose backward each zero-fills the whole
    ``[T, n, F]`` gradient (O(T^2) memory traffic: 29 s of a 250-step,
    3-layer LSTM net's float64 CPU step, 71 ms of its 248 ms compiled
    step on the card); the loops unbind xs once."""
    case = next(c for c in CASES if c[1] == op)
    _, _, inputs, outputs, attrs, diff, _ = case
    ins = {}
    for slot, items in inputs.items():
        vals = []
        for name, v in items:
            arr, lod = (v if isinstance(v, tuple) else (v, None))
            data = torch.tensor(arr)
            if name in diff:
                data.requires_grad_(True)
            vals.append(LoDValue(data, [torch.tensor(l) for l in lod],
                                 max_lens=[int(np.diff(l).max())
                                           for l in lod])
                        if lod else data)
        ins[slot] = vals
    blk = tir.Program().global_block()
    fop = blk.append_op(type=op, inputs={}, outputs=dict(outputs),
                        attrs=dict(attrs))
    ctx = FunctionalContext(fop, ins, dict(attrs), torch.device("cpu"),
                            type=op)
    with torch.enable_grad():
        treg.lookup(op).lower(ctx)
    out = ctx.collected[next(iter(outputs))][0]
    nodes = _grad_nodes(out.data if isinstance(out, LoDValue) else out)
    # a few selects outside the loop stay (the CRF's start and end rows
    # and its gold emissions' column, the CTC loss's column); none is
    # taken a step (the longest sequence here has 5)
    assert nodes["UnbindBackward0"] >= 1, nodes
    assert nodes.get("SelectBackward0", 0) <= 3, nodes
