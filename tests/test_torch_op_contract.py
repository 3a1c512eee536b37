"""The JAX package's per-op contract suite run through the port: every
``CASES`` entry of ``tests/test_op_contract_suite.py`` whose op type the
port registers, its outputs against the case's numpy reference and,
where the case has ``grad``, the port's appended gradient against finite
differences, each with the case's own ``atol`` / ``rtol`` / ``grad_rel``
(``tests/torch_op_test.py``, the twin of ``tests/op_test.py``). Beside
them the port's twins of the suite's random-op property tests, of
``tests/test_op_contract_suite2.py``'s ``sampling_id`` and ``range``
tests, of the ``shape`` case with the dtype the port gives it, and of
the suite2 sequence contracts whose ops the port registers (the
sequence ops, CRF, CTC, the ranking ops, ``chunk_eval``, ``hsigmoid``,
``nce`` and the int samplers), each op fed its weights, and of its
control flow contracts (``while`` to ``beam_search``).

A case the port cannot pass for a deliberate difference would be left
out by name in ``EXCLUDED``, with its ROADMAP Queue 3 number; there is
none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_op_contract_suite import CASES  # noqa: E402
from torch_op_test import OpTest  # noqa: E402
from paddle_tpu_torch.core import lod as tlod  # noqa: E402

import paddle_tpu_torch.ops  # noqa: E402,F401
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.registry import registered_ops  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.layers.layer_helper import LayerHelper  # noqa: E402

EXCLUDED = {}  # case name -> ROADMAP Queue 3 number
PORT_CASES = [c for c in CASES
              if c[1] in registered_ops() and c[0] not in EXCLUDED]
GRAD_CASES = [c for c in PORT_CASES if "grad" in c[2]]


class _Case(OpTest):
    def __init__(self, op_type, spec):
        self.op_type = op_type
        self._spec = spec

    def setup(self):
        self.inputs = self._spec["inputs"]
        self.outputs = self._spec["outputs"]
        self.attrs = dict(self._spec.get("attrs", {}))


@pytest.mark.parametrize("name,op_type,spec", PORT_CASES,
                         ids=[c[0] for c in PORT_CASES])
def test_output(name, op_type, spec):
    _Case(op_type, spec).check_output(atol=spec.get("atol", 1e-5),
                                      rtol=spec.get("rtol", 1e-5))


@pytest.mark.parametrize("name,op_type,spec", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_grad(name, op_type, spec):
    ins, out = spec["grad"]
    _Case(op_type, spec).check_grad(
        ins, out, max_relative_error=spec.get("grad_rel", 5e-3))


def test_the_sweep_covers_every_registered_case():
    """Every case whose op type the port registers runs: the op types of
    the dense slice and of the conv-net slice that the suite holds are
    among them."""
    assert len(PORT_CASES) >= 159 and len(GRAD_CASES) >= 62
    covered = {c[1] for c in PORT_CASES}
    for op in ("matmul", "concat", "split", "slice", "cos_sim", "scatter",
               "one_hot", "argsort", "rank_loss", "smooth_l1_loss",
               "prelu", "log_softmax", "maxout", "dropout",
               "depthwise_conv2d", "conv2d_transpose", "conv3d",
               "conv3d_transpose", "pool3d", "lrn", "l2_normalize",
               "auc", "precision_recall", "edit_distance"):
        assert op in covered, op


# -- random ops: properties ----------------------------------------------------

def _run_random(op_type, attrs, seed=7):
    """Two runs of a one-op program from one seed, each in a scope of
    its own."""
    main = tir.Program()
    main.random_seed = seed
    blk = main.global_block()
    blk.create_var(name="r_out", shape=None, dtype="float32")
    blk.append_op(type=op_type, inputs={}, outputs={"Out": ["r_out"]},
                  attrs=attrs)
    exe = TExecutor("cpu")
    a, = exe.run(main, fetch_list=["r_out"], scope=TScope())
    b, = exe.run(main, fetch_list=["r_out"], scope=TScope())
    return np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("op_type,attrs,check", [
    ("uniform_random", {"shape": [512, 8], "min": -2.0, "max": 3.0},
     lambda a: a.min() >= -2.0 and a.max() <= 3.0
     and abs(a.mean() - 0.5) < 0.15),
    ("gaussian_random", {"shape": [2048, 4], "mean": 1.5, "std": 0.5},
     lambda a: abs(a.mean() - 1.5) < 0.05 and abs(a.std() - 0.5) < 0.05),
    ("truncated_gaussian_random",
     {"shape": [2048, 4], "mean": 0.0, "std": 1.0},
     lambda a: np.abs(a).max() <= 2.0 + 1e-5 and abs(a.mean()) < 0.08),
], ids=["uniform_random", "gaussian_random", "truncated_gaussian_random"])
def test_random_op_properties(op_type, attrs, check):
    """The suite's property tests (``test_op_contract_suite.py:1433-
    1456``): shape, bounds and moments; a seeded rerun is equal."""
    a, b = _run_random(op_type, attrs)
    assert a.shape == tuple(attrs["shape"]) and check(a)
    np.testing.assert_array_equal(a, b)


def test_sampling_id_degenerate():
    """One-hot rows sample their hot index (``test_op_contract_suite2.py
    :604``)."""
    probs = np.zeros((4, 5), np.float32)
    probs[:, 3] = 1.0
    main, start = tir.Program(), tir.Program()
    with tir.program_guard(main, start):
        x = tlayers.data("x", shape=[5], dtype="float32")
        helper = LayerHelper("sid")
        out = helper.create_variable_for_type_inference("int64")
        helper.append_op(type="sampling_id", inputs={"X": [x]},
                         outputs={"Out": [out]})
    got, = TExecutor("cpu").run(main, feed={"x": probs}, fetch_list=[out],
                                scope=TScope())
    assert got.dtype == np.int64 and (got == 3).all()


def test_range_op():
    """``range`` of float bounds 1, 7, 2 then a scale
    (``test_op_contract_suite2.py:747``): a host op, so the program runs
    on the hybrid path."""
    main, start = tir.Program(), tir.Program()
    with tir.program_guard(main, start):
        helper = LayerHelper("rg")
        bounds = [tlayers.fill_constant([1], "float32", v)
                  for v in (1.0, 7.0, 2.0)]
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="range",
                         inputs={"Start": [bounds[0]], "End": [bounds[1]],
                                 "Step": [bounds[2]]},
                         outputs={"Out": [out]})
        y = tlayers.scale(out, scale=1.0)
    exe = TExecutor("cpu")
    got, raw = exe.run(main, fetch_list=[y, out], scope=TScope())
    np.testing.assert_allclose(got, [1.0, 3.0, 5.0])
    assert raw.dtype == np.int64 and raw.tolist() == [1, 3, 5]
    assert exe.stats["hybrid_runs"] == 1


def test_shape_case_is_int64():
    """The suite's ``shape`` case (``test_op_contract_suite.py:645``),
    with the int64 the port gives it (ROADMAP Queue 3 #26)."""
    spec = next(c[2] for c in CASES if c[0] == "shape")
    (name, want, got), = _Case("shape", spec).run_outputs()
    assert got.dtype == np.int64 and got.tolist() == want.tolist()


# -- twins of tests/test_op_contract_suite2.py's sequence contracts ------------
# each op alone through torch_op_test.OpTest, its weights fed, against the
# same numpy recurrence, closed form or enumeration as the JAX test

def _lod(seqs):
    return tlod.build_lod_tensor([np.asarray(s) for s in seqs])


def _sig(v):
    return 1 / (1 + np.exp(-v))


class _Contract(OpTest):
    def __init__(self, op_type, inputs, outputs, attrs=None):
        self.op_type = op_type
        self._io = (inputs, outputs, dict(attrs or {}))

    def setup(self):
        self.inputs, self.outputs, self.attrs = self._io


def test_sequence_reverse_contract():
    seqs = [np.random.RandomState(0).randn(n, 4).astype(np.float32)
            for n in (3, 2)]
    _Contract("sequence_reverse", {"X": _lod(seqs)},
              {"Y": np.concatenate([s[::-1] for s in seqs])}).check_output(
        atol=0, rtol=1e-6)


def test_sequence_slice_contract():
    seqs = [np.random.RandomState(1).randn(n, 2).astype(np.float32)
            for n in (4, 3)]
    _Contract("sequence_slice",
              {"X": _lod(seqs), "Offset": np.array([[1], [0]], np.int64),
               "Length": np.array([[2], [1]], np.int64)},
              {"Out": np.concatenate([seqs[0][1:3], seqs[1][0:1]])}
              ).check_output(atol=0, rtol=1e-6)


def test_sequence_conv_contract():
    """A window-3 context conv against numpy with zero-padded edges."""
    rng = np.random.RandomState(2)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in (4, 2)]
    w = rng.randn(9, 5).astype(np.float32)
    want = []
    for s in seqs:
        pad = np.vstack([np.zeros((1, 3), np.float32), s,
                         np.zeros((1, 3), np.float32)])
        want += [pad[t:t + 3].reshape(-1) @ w for t in range(len(s))]
    _Contract("sequence_conv", {"X": _lod(seqs), "Filter": w},
              {"Out": np.asarray(want, np.float32)},
              {"contextLength": 3, "contextStart": -1,
               "contextStride": 1}).check_output(atol=1e-5, rtol=1e-4)


def test_lstmp_op_contract():
    """The standard cell and a tanh projection fed back as the recurrent
    input, against numpy."""
    rng = np.random.RandomState(11)
    D, P = 3, 2
    seq = rng.randn(4, 4 * D).astype(np.float32) * 0.5
    w = rng.randn(P, 4 * D).astype(np.float32) * 0.5
    wp = rng.randn(D, P).astype(np.float32) * 0.5
    rv, cv = np.zeros(P, np.float32), np.zeros(D, np.float32)
    want_p, want_c = [], []
    for t in range(4):
        g = seq[t] + rv @ w
        cand, i, f, o = (np.tanh(g[:D]), _sig(g[D:2 * D]),
                         _sig(g[2 * D:3 * D]), _sig(g[3 * D:]))
        cv = f * cv + i * cand
        rv = np.tanh((o * np.tanh(cv)) @ wp)
        want_p.append(rv.copy())
        want_c.append(cv.copy())
    _Contract("lstmp", {"Input": _lod([seq]), "Weight": w, "ProjWeight": wp},
              {"Projection": np.asarray(want_p, np.float32),
               "Cell": np.asarray(want_c, np.float32)},
              {"use_peepholes": False}).check_output(atol=1e-5, rtol=1e-4)


def test_gru_and_lstm_op_contracts():
    """``dynamic_gru``'s and ``dynamic_lstm``'s gate math (update|reset
    then candidate, h = (1 - u) h + u c; slabs c~, i, f, o, no
    peepholes) against numpy."""
    rng = np.random.RandomState(3)
    D = 3
    seq = rng.randn(4, 3 * D).astype(np.float32) * 0.5
    w = rng.randn(D, 3 * D).astype(np.float32) * 0.5
    hv, want = np.zeros(D, np.float32), []
    for t in range(4):
        ur = _sig(seq[t, :2 * D] + hv @ w[:, :2 * D])
        u, r = ur[:D], ur[D:]
        c = np.tanh(seq[t, 2 * D:] + (r * hv) @ w[:, 2 * D:])
        hv = (1 - u) * hv + u * c
        want.append(hv.copy())
    _Contract("gru", {"Input": _lod([seq]), "Weight": w},
              {"Hidden": np.asarray(want, np.float32)}).check_output(
        atol=1e-5, rtol=1e-4)
    D = 2
    seq = rng.randn(3, 4 * D).astype(np.float32) * 0.5
    w = rng.randn(D, 4 * D).astype(np.float32) * 0.5
    hv, cv, want = np.zeros(D, np.float32), np.zeros(D, np.float32), []
    for t in range(3):
        g = seq[t] + hv @ w
        cand, i, f, o = (np.tanh(g[:D]), _sig(g[D:2 * D]),
                         _sig(g[2 * D:3 * D]), _sig(g[3 * D:]))
        cv = f * cv + i * cand
        hv = o * np.tanh(cv)
        want.append(hv.copy())
    _Contract("lstm", {"Input": _lod([seq]), "Weight": w},
              {"Hidden": np.asarray(want, np.float32)},
              {"use_peepholes": False}).check_output(atol=1e-5, rtol=1e-4)


def test_simple_rnn_op_contract():
    rng = np.random.RandomState(5)
    seq = rng.randn(3, 4).astype(np.float32) * 0.5
    w = rng.randn(4, 4).astype(np.float32) * 0.5
    hv, want = np.zeros(4, np.float32), []
    for t in range(3):
        hv = np.tanh(seq[t] + hv @ w)
        want.append(hv.copy())
    _Contract("simple_rnn", {"Input": _lod([seq]), "Weight": w},
              {"Hidden": np.asarray(want, np.float32)},
              {"activation": "tanh"}).check_output(atol=1e-6, rtol=1e-4)


def test_warpctc_closed_form():
    """T = 2, one label, blank 0: p = p1[l] p2[b] + p1[b] p2[l] + p1[l]
    p2[l], the loss -log p."""
    logits = np.array([[0.2, 1.0, -0.3], [0.5, -0.2, 0.9]], np.float32)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p = p / p.sum(1, keepdims=True)
    prob = p[0, 1] * p[1, 0] + p[0, 0] * p[1, 1] + p[0, 1] * p[1, 1]
    _Contract("warpctc", {"Logits": _lod([logits]),
                          "Label": tlod.LoDTensor(np.array([[1]], np.int64),
                                                  [[0, 1]])},
              {"Loss": np.array([[-np.log(prob)]], np.float32)},
              {"blank": 0}).check_output(atol=1e-6, rtol=1e-4)


def test_crf_forward_and_viterbi():
    """-log-likelihood against the numpy forward algorithm, the decoded
    path against numpy Viterbi, on one transition."""
    rng = np.random.RandomState(6)
    T, C = 3, 2
    emit = rng.rand(T, C).astype(np.float32)
    lab = rng.randint(0, C, (T, 1)).astype(np.int64)
    w = rng.randn(C + 2, C).astype(np.float32)
    start, end, trans = w[0], w[1], w[2:]
    alpha = start + emit[0]
    for t in range(1, T):
        alpha = emit[t] + np.log(np.exp(alpha[:, None] + trans).sum(0))
    log_z = np.log(np.exp(alpha + end).sum())
    score = start[lab[0, 0]] + emit[0, lab[0, 0]] + end[lab[-1, 0]] + sum(
        trans[lab[t - 1, 0], lab[t, 0]] + emit[t, lab[t, 0]]
        for t in range(1, T))
    ins = {"Emission": tlod.LoDTensor(emit, [[0, T]]), "Transition": w,
           "Label": tlod.LoDTensor(lab, [[0, T]])}
    _Contract("linear_chain_crf", ins,
              {"LogLikelihood": np.array([[log_z - score]], np.float32)}
              ).check_output(atol=1e-5, rtol=1e-4)
    delta, back = start + emit[0], []
    for t in range(1, T):
        m = delta[:, None] + trans
        back.append(m.argmax(0))
        delta = emit[t] + m.max(0)
    path = [int((delta + end).argmax())]
    for b in reversed(back):
        path.append(int(b[path[-1]]))
    _Contract("crf_decoding", {k: ins[k] for k in ("Emission", "Transition")},
              {"ViterbiPath": np.asarray(path[::-1], np.int64)[:, None]}
              ).check_output(atol=0, rtol=0)


def test_kmax_and_sub_nested_contract():
    scores = np.array([[0.3], [0.9], [0.1], [0.7]], np.float32)
    _Contract("kmax_seq_score", {"X": tlod.LoDTensor(scores, [[0, 4]])},
              {"Out": np.array([[1, 3, 0]], np.int64)},
              {"beam_size": 3}).check_output(atol=0, rtol=0)
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    case = _Contract("sub_nested_seq",
                     {"X": tlod.LoDTensor(data, [[0, 3], [0, 1, 3, 5]]),
                      "SelectedIndices": np.array([[2, 0]], np.int64)},
                     {"Out": np.zeros((5, 2), np.float32)})
    (_, _, got), = case.run_outputs()
    np.testing.assert_allclose(got[:3], np.concatenate([data[3:5],
                                                        data[0:1]]))
    assert not got[3:].any()


def test_ranking_ops_contract():
    """positive_negative_pair and lambda_rank_cost at their hand values:
    idcg 1, d = [1, 1 / log2(3)], cost (1 - d1) log(1 + e^-1)."""
    s = tlod.LoDTensor(np.array([[2.0], [1.0]], np.float32), [[0, 2]])
    r = tlod.LoDTensor(np.array([[1.0], [0.0]], np.float32), [[0, 2]])
    d1 = 1.0 / np.log2(3.0)
    _Contract("lambda_rank_cost", {"Score": s, "Label": r},
              {"Out": np.array([(1 - d1) * np.log1p(np.exp(-1.0))],
                               np.float32)},
              {"ndcg_num": 2}).check_output(atol=1e-6, rtol=1e-4)
    case = _Contract("positive_negative_pair", {"Score": s, "Label": r},
                     {"PositivePair": np.array([1.0], np.float32)})
    (_, _, got), = case.run_outputs()
    assert float(np.asarray(got).reshape(-1)[0]) == 1.0


def test_chunk_eval_exact():
    """IOB chunks: inference equal to the label gives P = R = F1 = 1 (a
    host op, on the hybrid path)."""
    lab = tlod.LoDTensor(np.array([[0], [1], [2], [0]], np.int64), [[0, 4]])
    _Contract("chunk_eval", {"Inference": lab, "Label": lab},
              {"Precision": np.ones(1, np.float32),
               "Recall": np.ones(1, np.float32),
               "F1-Score": np.ones(1, np.float32),
               "NumInferChunks": np.array([2], np.int64)},
              {"num_chunk_types": 1, "chunk_scheme": "IOB"}).check_output(
        atol=0, rtol=0)


def test_hsigmoid_two_classes_is_sigmoid():
    """num_classes 2: one internal node, the cost one logistic -log
    sigmoid(+-z), class 0 taking +z."""
    rng = np.random.RandomState(8)
    x = rng.rand(3, 4).astype(np.float32)
    y = np.array([[0], [1], [0]], np.int64)
    w = rng.randn(1, 4).astype(np.float32)
    b = rng.randn(1, 1).astype(np.float32)
    z = x @ w[0] + b[0, 0]
    sign = np.where(y[:, 0] == 0, 1.0, -1.0)
    _Contract("hierarchical_sigmoid", {"X": x, "W": w, "Label": y, "Bias": b},
              {"Out": np.log1p(np.exp(-sign * z)).astype(
                  np.float32)[:, None]},
              {"num_classes": 2}).check_output(atol=1e-6, rtol=1e-5)


def test_nce_trains():
    """The suite's sampled-op property (``test_op_contract_suite2.py
    :656``): nce's loss is finite and falls under SGD."""
    rng = np.random.RandomState(9)
    main, start = tir.Program(), tir.Program()
    with tir.program_guard(main, start):
        x = tlayers.data("x", shape=[8], dtype="float32")
        y = tlayers.data("y", shape=[1], dtype="int64")
        cost = tlayers.mean(tlayers.nce(x, y, num_total_classes=10,
                                        num_neg_samples=4))
        from paddle_tpu_torch import optimizer as toptimizer
        toptimizer.SGD(learning_rate=0.1).minimize(cost)
    feed = {"x": rng.rand(6, 8).astype(np.float32),
            "y": rng.randint(0, 10, (6, 1)).astype(np.int64)}
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(start, scope=scope)
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[cost],
                                       scope=scope)[0]))
              for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_random_int_samplers():
    """The nce samplers' range and shape, log-uniform's skew to small
    ids, and a one-hot custom distribution's one class; a seeded rerun
    is equal."""
    main = tir.Program()
    main.random_seed = 11
    blk = main.global_block()
    for nm in ("u_int", "lu_int", "cd_int"):
        blk.create_var(name=nm, shape=None, dtype="int64")
    blk.append_op(type="uniform_random_int", inputs={},
                  outputs={"Out": ["u_int"]},
                  attrs={"shape": [256], "low": 2, "high": 9})
    blk.append_op(type="log_uniform_random_int", inputs={},
                  outputs={"Out": ["lu_int"]},
                  attrs={"shape": [256], "range": 50})
    blk.create_var(name="cd_probs", shape=(4,), dtype="float32")
    blk.append_op(type="assign_value", inputs={},
                  outputs={"Out": ["cd_probs"]},
                  attrs={"shape": [4], "values": [0.0, 0.0, 1.0, 0.0],
                         "dtype": "float32"})
    blk.append_op(type="custom_dist_random_int",
                  inputs={"Probs": ["cd_probs"]},
                  outputs={"Out": ["cd_int"]}, attrs={"shape": [256]})
    runs = [[np.asarray(v) for v in TExecutor("cpu").run(
        main, fetch_list=["u_int", "lu_int", "cd_int"], scope=TScope())]
        for _ in range(2)]
    u, lu, cd = runs[0]
    assert u.min() >= 2 and u.max() < 9 and u.dtype == np.int64
    assert lu.min() >= 0 and lu.max() < 50
    assert (lu < 10).sum() > (lu >= 40).sum()
    assert (cd == 2).all()
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


# -- twins of tests/test_op_contract_suite2.py's control flow contracts
# (:347-470): each program built through the port's layers, run on the
# per-op path as the JAX test runs it, against the same closed form

def _cf_run(build_fn, feed, use_jit=False):
    """(fetched values, program) of ``build_fn()`` (it returns the fetch
    list) in a program of its own."""
    main, start = tir.Program(), tir.Program()
    with tir.program_guard(main, start):
        fetch = build_fn()
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(start, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   use_jit=use_jit), main


def test_array_roundtrip_forward_exact():
    """lod_tensor_to_array -> while(read, scale, write) ->
    array_to_lod_tensor: 2x with the ragged order kept, and the array
    length the longest sequence (``test_op_contract_suite2.py:347``)."""
    rng = np.random.RandomState(7)
    seqs = [rng.randn(n, 2).astype(np.float32) for n in (3, 2)]
    F = tlayers

    def build_fn():
        x = F.data("x", shape=[2], dtype="float32", lod_level=1)
        table = F.lod_rank_table(x)
        arr = F.lod_tensor_to_array(x, table)
        max_len = F.max_sequence_len(table)
        n_arr = F.array_length(arr)
        out_arr = F.create_array("float32")
        i = F.zeros(shape=[1], dtype="int64")
        cond = F.less_than(i, max_len)
        w = F.While(cond=cond)
        with w.block():
            F.array_write(F.scale(F.array_read(array=arr, i=i), scale=2.0),
                          i=i, array=out_arr)
            i = F.increment(x=i, in_place=True)
            F.less_than(i, max_len, cond=cond)
        y = F.array_to_lod_tensor(out_arr, table)
        return [F.mean(y), n_arr, y]
    (lv, nv, y), _ = _cf_run(build_fn, {"x": _lod(seqs)})
    total = np.concatenate(seqs)
    np.testing.assert_allclose(float(np.asarray(lv).reshape(-1)[0]),
                               2.0 * total.mean(), rtol=1e-5)
    assert int(np.asarray(nv).reshape(-1)[0]) == 3
    np.testing.assert_array_equal(y.numpy(), 2.0 * total)
    assert y.lod() == [[0, 3, 5]]


def test_dynamic_rnn_substrate_and_static_rnn():
    """DynamicRNN builds on shrink_rnn_memory; its ragged sums match
    numpy; a StaticRNN's ``recurrent`` op is a prefix sum
    (``test_op_contract_suite2.py:385``)."""
    rng = np.random.RandomState(17)
    seqs = [rng.randn(n, 2).astype(np.float32) for n in (3, 1)]
    xs = np.arange(6, dtype=np.float32).reshape(3, 1, 2)
    F = tlayers

    def build_fn():
        x = F.data("x", shape=[2], dtype="float32", lod_level=1)
        rnn = F.DynamicRNN()
        with rnn.block():
            x_t = rnn.step_input(x)
            mem = rnn.memory(shape=[2], value=0.0)
            acc = F.elementwise_add(x_t, mem)
            rnn.update_memory(mem, acc)
            rnn.output(acc)
        last = F.sequence_last_step(rnn())
        x2 = F.data("xs", shape=[3, 1, 2], dtype="float32",
                    append_batch_size=False)
        boot = F.fill_constant(shape=[1, 2], dtype="float32", value=0.0)
        srnn = F.StaticRNN()
        with srnn.step():
            xt = srnn.step_input(x2)
            h = srnn.memory(init=boot)
            nh = F.elementwise_add(xt, h)
            srnn.update_memory(h, nh)
            srnn.step_output(nh)
        return [last, srnn()]
    for use_jit in (False, True):
        (last, sout), main = _cf_run(build_fn, {"x": _lod(seqs), "xs": xs},
                                     use_jit)
        ops = {op.type for blk in main.blocks for op in blk.ops}
        assert {"shrink_rnn_memory", "recurrent"} <= ops
        np.testing.assert_allclose(np.asarray(last),
                                   np.stack([s.sum(0) for s in seqs]),
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(sout).reshape(3, 1, 2),
                                   np.cumsum(xs, axis=0), rtol=1e-6)


def test_conditional_block_contract():
    """Switch drives conditional_block: |a| by branch
    (``test_op_contract_suite2.py:430``)."""
    F = tlayers

    def build_fn():
        a = F.data("a", shape=[1], append_batch_size=False)
        zero = F.fill_constant(shape=[1], dtype="float32", value=0.0)
        out = F.create_global_var(shape=[1], value=0.0, dtype="float32",
                                  persistable=True, name="cb_contract_out")
        sw = F.Switch()
        with sw.case(F.less_than(a, zero)):
            F.assign(F.scale(a, scale=-1.0), out)
        with sw.default():
            F.assign(F.scale(a, scale=1.0), out)
        return [out]
    for v in (-3.0, 2.5):
        (got,), _ = _cf_run(build_fn, {"a": np.array([v], np.float32)})
        assert float(np.asarray(got).reshape(-1)[0]) == abs(v)


def test_beam_search_tiny_trace():
    """One expansion step on a hand-computed beam: the top 2 of {0.9: 3,
    0.1: 4, 0.8: 5, 0.2: 6} are ids 3 and 5
    (``test_op_contract_suite2.py:449``)."""
    pre = tlod.LoDTensor(np.array([[1], [2]], np.int64),
                         lod=[[0, 2], [0, 1, 2]])
    F = tlayers

    def build_fn():
        pre_v = F.data("pre", shape=[1], dtype="int64", lod_level=2)
        ids_v = F.data("ids", shape=[2], dtype="int64")
        sc_v = F.data("sc", shape=[2], dtype="float32")
        helper = LayerHelper("bs")
        sel_ids = helper.create_variable_for_type_inference("int64")
        sel_sc = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="beam_search",
                         inputs={"pre_ids": [pre_v], "ids": [ids_v],
                                 "scores": [sc_v]},
                         outputs={"selected_ids": [sel_ids],
                                  "selected_scores": [sel_sc]},
                         attrs={"beam_size": 2, "end_id": 0, "level": 0})
        return [sel_ids, sel_sc]
    (si, ss), _ = _cf_run(build_fn, {
        "pre": pre, "ids": np.array([[3, 4], [5, 6]], np.int64),
        "sc": np.array([[0.9, 0.1], [0.8, 0.2]], np.float32)})
    assert set(si.numpy().reshape(-1).tolist()) == {3, 5}
    np.testing.assert_allclose(ss.numpy().reshape(-1), [0.9, 0.8])
