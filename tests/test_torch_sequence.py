"""The port's sequence (LoD) stack against the JAX package's, on the CPU:
the LoDTensor and offset helpers, ragged DataFeeder feeds, the ragged
<-> padded helpers, ``sequence_pool`` and the ``lstm`` and ``gru`` ops
with their gradients, and the generic grad of a LoD-valued input.

Op programs are built the same way in both packages (same var names,
shapes and attrs), fed the same numpy arrays made from a seed as
``LoDTensor``s, and differentiated by each package's
``append_backward`` through a loss ``mean(mul(out, r))`` with a fed
``r``. Tolerance: the largest absolute error <= 2e-5 x max(1, largest
magnitude of the JAX value), float32 on both sides; the recurrent ops
run up to 5 steps of D = 128-term products and their gradients sum over
the batch's rows, where XLA and PyTorch sum in other orders (~1e-7
relative a term), as in the JAX package's own fused-kernel tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import data_feeder as jfeeder  # noqa: E402
from paddle_tpu.core import backward as jbackward  # noqa: E402
from paddle_tpu.core import lod as jlod  # noqa: E402
from paddle_tpu.ops import sequence_ops as jseq  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch.core import backward as tbackward  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import lod as tlod  # noqa: E402
from paddle_tpu_torch.core.executor import (  # noqa: E402
    Executor as TExecutor, LoDValue, to_lod_value)
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.data_feeder import DataFeeder as TFeeder  # noqa: E402
from paddle_tpu_torch.flags import FLAGS  # noqa: E402
from paddle_tpu_torch.ops import sequence_ops as tseq  # noqa: E402

TOL = 2e-5
LENGTHS = [3, 1, 5, 2]


def _close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max()) if want.size \
        else 0.0
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (name, err)


# -- LoDTensor, offsets, DataFeeder -------------------------------------------

@pytest.mark.parametrize("lengths", [[3, 1, 5, 2], [0, 4, 0], [7]])
def test_offset_helpers_match_jax(lengths):
    offs = tlod.lengths_to_offsets(lengths)
    assert offs == jlod.lengths_to_offsets(lengths)
    assert tlod.offsets_to_lengths(offs) == jlod.offsets_to_lengths(offs)
    want = np.asarray(jseq.segment_ids(jnp.asarray(offs, jnp.int32),
                                       offs[-1]))
    seg = tseq.segment_ids(torch.tensor(offs), offs[-1])
    np.testing.assert_array_equal(seg.numpy(), want)
    np.testing.assert_array_equal(tlod.offsets_to_segment_ids(offs), want)
    if lengths[-1]:    # the JAX host copy raises on a trailing empty one
        np.testing.assert_array_equal(tlod.offsets_to_segment_ids(offs),
                                      jlod.offsets_to_segment_ids(offs))


def test_lod_tensor_api_matches_jax():
    rng = np.random.RandomState(0)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in LENGTHS]
    t, j = tlod.build_lod_tensor(seqs), jlod.build_lod_tensor(seqs)
    np.testing.assert_array_equal(t.numpy(), j.numpy())
    assert t.lod() == j.lod()
    assert t.recursive_sequence_lengths() == j.recursive_sequence_lengths()
    assert t.has_valid_recursive_sequence_lengths()
    t.set_recursive_sequence_lengths([[2, 2]])
    assert not t.has_valid_recursive_sequence_lengths()


def _feed_vars(block_create, lod_level):
    return [block_create(name="words", shape=[-1, 1], dtype="int64",
                         lod_level=lod_level),
            block_create(name="label", shape=[-1, 1], dtype="int64")]


@pytest.mark.parametrize("lod_level", [1, 2])
def test_ragged_data_feeder_matches_jax(lod_level):
    rng = np.random.RandomState(lod_level)
    if lod_level == 1:
        words = [rng.randint(0, 50, (n, 1)) for n in LENGTHS]
    else:
        words = [[rng.randint(0, 50, (n, 1)) for n in (2, 1)],
                 [rng.randint(0, 50, (n, 1)) for n in (3,)]]
    batch = [(w, [int(rng.randint(0, 2))]) for w in words]
    jp, tp = jpt.Program(), tir.Program()
    jfeed = jfeeder.DataFeeder(
        _feed_vars(jp.global_block().create_var, lod_level)).feed(batch)
    tfeed = TFeeder(_feed_vars(tp.global_block().create_var, lod_level),
                    device="cpu").feed(batch)
    got = tfeed["words"]
    assert isinstance(got, LoDValue)
    np.testing.assert_array_equal(got.data.numpy(), jfeed["words"].numpy())
    assert [l.tolist() for l in got.lod] == jfeed["words"].lod()
    assert all(l.dtype == torch.int64 for l in got.lod)
    want_max = [max(tlod.offsets_to_lengths(l)) for l in jfeed["words"].lod()]
    assert list(got.max_lens) == want_max
    np.testing.assert_array_equal(tfeed["label"].numpy(), jfeed["label"])


def test_executor_fetches_a_lod_value_as_a_lod_tensor():
    rng = np.random.RandomState(3)
    t = tlod.build_lod_tensor([rng.randn(n, 2).astype(np.float32)
                               for n in LENGTHS])
    prog = tir.Program()
    prog.global_block().create_var(name="x", shape=[-1, 2],
                                   dtype="float32", lod_level=1)
    prog.global_block().create_var(name="y", shape=[-1, 2],
                                   dtype="float32", lod_level=1)
    prog.global_block().append_op(type="assign", inputs={"X": ["x"]},
                                  outputs={"Out": ["y"]})
    out, = TExecutor("cpu").run(prog, feed={"x": t}, fetch_list=["y"],
                                scope=TScope())
    assert isinstance(out, tlod.LoDTensor)
    assert out.lod() == t.lod()
    np.testing.assert_array_equal(out.numpy(), t.numpy())


# -- ragged <-> padded --------------------------------------------------------

@pytest.mark.parametrize("lengths", [[3, 1, 5, 2], [0, 4, 0, 1]])
def test_padded_round_trips_match_jax(lengths):
    rng = np.random.RandomState(4)
    offs = tlod.lengths_to_offsets(lengths)
    data = rng.randn(offs[-1], 3).astype(np.float32)
    ml = max(lengths)
    to, jo = torch.tensor(offs), jnp.asarray(offs, jnp.int32)
    tpad, tmask = tseq.lod_to_padded(torch.tensor(data), to, ml)
    jpad, jmask = jseq.lod_to_padded(jnp.asarray(data), jo, ml)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    trev = tseq.reverse_padded(tpad, tmask, to, ml)
    np.testing.assert_array_equal(
        trev.numpy(), np.asarray(jseq.reverse_padded(jpad, jmask, jo, ml)))
    # reversing twice and scattering back give the ragged rows again
    back = tseq.reverse_padded(trev, tmask, to, ml)
    np.testing.assert_array_equal(
        tseq.padded_to_lod(back, to, offs[-1]).numpy(), data)
    np.testing.assert_array_equal(
        tseq.padded_to_lod(trev, to, offs[-1]).numpy(),
        np.asarray(jseq.padded_to_lod(jseq.reverse_padded(jpad, jmask, jo,
                                                          ml), jo, offs[-1])))


# -- op programs in both packages ---------------------------------------------

def _build_and_run(pkg, vars_, ops, loss_outs, feed, fetch, flags=None):
    """One program of ``vars_`` ({name: (shape, dtype, lod_level,
    stop_gradient)}) and ``ops`` ([(type, inputs, outputs, attrs)]), a
    loss ``sum of mean(mul(out, r_<out>))`` over ``loss_outs`` (each
    ``r_<out>`` fed), backward appended, run once on the CPU."""
    if pkg == "jax":
        prog, startup = jpt.Program(), jpt.Program()
        guard, backward = jpt.program_guard, jbackward.append_backward
    else:
        prog, startup = tir.Program(), tir.Program()
        guard, backward = tir.program_guard, tbackward.append_backward
    block = prog.global_block()
    with guard(prog, startup):
        for name, (shape, dtype, lod_level, sg) in vars_.items():
            block.create_var(name=name, shape=shape, dtype=dtype,
                             lod_level=lod_level, stop_gradient=sg)
        for t, inputs, outputs, attrs in ops:
            block.append_op(type=t, inputs=inputs, outputs=outputs,
                            attrs=dict(attrs))
        terms = []
        for out in loss_outs:
            for n, shape in ((out + "_r", None), (out + "_p", None),
                             (out + "_m", (1,))):
                block.create_var(name=n, shape=shape, dtype="float32",
                                 stop_gradient=(n == out + "_r"))
            block.append_op(type="mul", inputs={"X": [out],
                                                "Y": [out + "_r"]},
                            outputs={"Out": [out + "_p"]},
                            attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
            block.append_op(type="mean", inputs={"X": [out + "_p"]},
                            outputs={"Out": [out + "_m"]})
            terms.append(out + "_m")
        loss = terms[0]
        if len(terms) > 1:
            block.create_var(name="loss", shape=(1,), dtype="float32")
            block.append_op(type="sum", inputs={"X": terms},
                            outputs={"Out": ["loss"]})
            loss = "loss"
        backward(block.var(loss))
    if pkg == "jax":
        with jpt.scope_guard(jpt.Scope()), jpt.flags_guard(**(flags or {})):
            outs = jpt.Executor(jpt.CPUPlace()).run(prog, feed=feed,
                                                    fetch_list=fetch)
        return [np.asarray(o) for o in outs]
    return [np.asarray(o) for o in TExecutor("cpu").run(
        prog, feed=feed, fetch_list=fetch, scope=TScope())]


def _ragged(rng, width, lengths=LENGTHS, scale=1.0):
    return jlod.LoDTensor(
        (rng.randn(sum(lengths), width) * scale).astype(np.float32),
        [jlod.lengths_to_offsets(lengths)])


def _both(vars_, ops, loss_outs, feed, fetch, jax_flags=None):
    """Run in both packages (each its own LoDTensor class) and compare."""
    tfeed = {k: tlod.LoDTensor(v.numpy(), v.lod())
             if isinstance(v, jlod.LoDTensor) else v for k, v in feed.items()}
    want = _build_and_run("jax", vars_, ops, loss_outs, feed, fetch,
                          jax_flags)
    got = _build_and_run("port", vars_, ops, loss_outs, tfeed, fetch)
    for name, g, w in zip(fetch, got, want):
        _close(g, w, name)
    return got, want


POOLTYPES = ["SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST", "AVG"]


@pytest.mark.parametrize("pooltype", POOLTYPES)
@pytest.mark.parametrize("lengths", [LENGTHS, [2, 0, 3]])
def test_sequence_pool_and_its_grad_match_jax(pooltype, lengths):
    rng = np.random.RandomState(len(pooltype) + len(lengths))
    F = 6
    vars_ = {"x": ((-1, F), "float32", 1, False),
             "out": ((-1, F), "float32", 0, False),
             "idx": ((-1, F), "int32", 0, True)}
    ops = [("sequence_pool", {"X": ["x"]},
            {"Out": ["out"], "MaxIndex": ["idx"]}, {"pooltype": pooltype})]
    feed = {"x": _ragged(rng, F, lengths),
            "out_r": rng.randn(F, 1).astype(np.float32)}
    fetch = ["out", "x@GRAD"] + (["idx"] if pooltype == "MAX" and
                                 0 not in lengths else [])
    got, _ = _both(vars_, ops, ["out"], feed, fetch)
    if 0 in lengths:                   # an empty sequence pools to zeros
        assert not got[0][lengths.index(0)].any()


def _lstm_case(rng, D, peep, rev, init, acts):
    n = len(LENGTHS)
    vars_ = {"x": ((-1, 4 * D), "float32", 1, False),
             "w": ((D, 4 * D), "float32", 0, False),
             "b": ((1, (7 if peep else 4) * D), "float32", 0, False),
             "h": ((-1, D), "float32", 1, False),
             "c": ((-1, D), "float32", 1, False)}
    inputs = {"Input": ["x"], "Weight": ["w"], "Bias": ["b"]}
    feed = {"x": _ragged(rng, 4 * D, scale=0.5),
            "w": (rng.randn(D, 4 * D) * 0.1).astype(np.float32),
            "b": (rng.randn(1, (7 if peep else 4) * D) * 0.1)
            .astype(np.float32),
            "h_r": rng.randn(D, 1).astype(np.float32),
            "c_r": rng.randn(D, 1).astype(np.float32)}
    if init:
        for s, name in (("H0", "h0"), ("C0", "c0")):
            vars_[name] = ((n, D), "float32", 0, False)
            inputs[s] = [name]
            feed[name] = (rng.randn(n, D) * 0.3).astype(np.float32)
    attrs = {"use_peepholes": peep, "is_reverse": rev,
             "gate_activation": acts[0], "cell_activation": acts[1],
             "candidate_activation": acts[2]}
    return vars_, inputs, feed, attrs


LSTM_CASES = [
    # (use_peepholes, is_reverse, H0/C0, activations)
    (False, False, False, ("sigmoid", "tanh", "tanh")),
    (False, True, True, ("sigmoid", "tanh", "tanh")),
    (True, False, False, ("sigmoid", "tanh", "tanh")),
    (True, True, True, ("sigmoid", "tanh", "tanh")),
    (False, False, True, ("sigmoid", "relu", "identity")),
]


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("case", range(len(LSTM_CASES)))
def test_lstm_op_and_its_grads_match_jax(case, impl):
    peep, rev, init, acts = LSTM_CASES[case]
    D = 128
    rng = np.random.RandomState(10 + case)
    vars_, inputs, feed, attrs = _lstm_case(rng, D, peep, rev, init, acts)
    attrs["lstm_impl"] = impl          # the port reads it; JAX its flag
    ops = [("lstm", inputs, {"Hidden": ["h"], "Cell": ["c"]}, attrs)]
    fetch = ["h", "c", "x@GRAD", "w@GRAD", "b@GRAD"] + (
        ["h0@GRAD", "c0@GRAD"] if init else [])
    kernels.reset_launches()
    _both(vars_, ops, ["h", "c"], feed, fetch, {"lstm_impl": impl})
    assert kernels.launch_counts()["fused_lstm"] == 0     # the CPU


@pytest.mark.parametrize("impl", ["scan", "pallas"])
@pytest.mark.parametrize("rev,init", [(False, False), (True, True),
                                      (True, False)])
def test_gru_op_and_its_grads_match_jax(rev, init, impl):
    D = 128
    n = len(LENGTHS)
    rng = np.random.RandomState(20 + 2 * rev + init)
    vars_ = {"x": ((-1, 3 * D), "float32", 1, False),
             "w": ((D, 3 * D), "float32", 0, False),
             "b": ((1, 3 * D), "float32", 0, False),
             "h": ((-1, D), "float32", 1, False)}
    inputs = {"Input": ["x"], "Weight": ["w"], "Bias": ["b"]}
    feed = {"x": _ragged(rng, 3 * D, scale=0.5),
            "w": (rng.randn(D, 3 * D) * 0.1).astype(np.float32),
            "b": (rng.randn(1, 3 * D) * 0.1).astype(np.float32),
            "h_r": rng.randn(D, 1).astype(np.float32)}
    if init:
        vars_["h0"] = ((n, D), "float32", 0, False)
        inputs["H0"] = ["h0"]
        feed["h0"] = (rng.randn(n, D) * 0.3).astype(np.float32)
    ops = [("gru", inputs, {"Hidden": ["h"]},
            {"is_reverse": rev, "gate_activation": "sigmoid",
             "activation": "tanh", "lstm_impl": impl})]
    fetch = ["h", "x@GRAD", "w@GRAD", "b@GRAD"] + (["h0@GRAD"] if init
                                                  else [])
    _both(vars_, ops, ["h"], feed, fetch, {"lstm_impl": impl})


@pytest.mark.parametrize("attr,flag,fused", [
    (None, "scan", False), (None, "pallas", True), ("pallas", "scan", True),
    ("scan", "pallas", False)])
def test_an_ops_lstm_impl_attr_takes_precedence_over_the_flag(
        attr, flag, fused, monkeypatch):
    calls = []
    real = tseq.fused_lstm
    monkeypatch.setattr(tseq, "fused_lstm",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(FLAGS, "lstm_impl", flag)
    assert FLAGS.lstm_impl == flag
    D = 128
    rng = np.random.RandomState(30)
    vars_, inputs, feed, attrs = _lstm_case(
        rng, D, False, False, False, ("sigmoid", "tanh", "tanh"))
    if attr is not None:
        attrs["lstm_impl"] = attr
    _build_and_run("port", vars_, [("lstm", inputs,
                                    {"Hidden": ["h"], "Cell": ["c"]},
                                    attrs)], ["h"],
                   {k: tlod.LoDTensor(v.numpy(), v.lod())
                    if isinstance(v, jlod.LoDTensor) else v
                    for k, v in feed.items()}, ["h"])
    # the forward, and its replay in the generic grad
    assert len(calls) == (2 if fused else 0)


@pytest.mark.parametrize("readers", [1, 2])
def test_generic_grad_of_a_lod_input_is_its_gradient_with_its_lod(readers):
    """sequence_pool has no explicit grad: its generic grad replays it with
    the LoD value's data as the primal. The gradient must be the pool's
    (not zeros) and carry the input's offsets; with two readers of x the
    two LoD gradients meet in backward's ``sum`` op."""
    rng = np.random.RandomState(40)
    F = 5
    x = tlod.LoDTensor(rng.randn(sum(LENGTHS), F).astype(np.float32),
                       [tlod.lengths_to_offsets(LENGTHS)])
    prog, startup = tir.Program(), tir.Program()
    with tir.program_guard(prog, startup):
        xv = tlayers.data(name="x", shape=[F], lod_level=1,
                          stop_gradient=False)
        pooled = [tlayers.sequence_pool(input=xv, pool_type="sum")
                  for _ in range(readers)]
        total = pooled[0] if readers == 1 else \
            tlayers.elementwise_add(pooled[0], pooled[1])
        tbackward.append_backward(tlayers.mean(total))
    # x's whole gradient: x@GRAD, or the sum of it and the renamed one
    sums = [op for op in prog.global_block().ops if op.type == "sum"
            and "x@GRAD" in op.input("X")]
    assert len(sums) == readers - 1
    g, = TExecutor("cpu").run(
        prog, feed={"x": x}, scope=TScope(),
        fetch_list=[sums[0].output("Out")[0] if sums else "x@GRAD"])
    assert isinstance(g, tlod.LoDTensor) and g.lod() == x.lod()
    # d mean(sum-pool) / dx = 1 / (num_seqs * F) at every row, per reader
    np.testing.assert_allclose(g.numpy(), readers / (len(LENGTHS) * F),
                               rtol=1e-6)


def test_lod_values_keep_their_lod_through_mul_and_add():
    rng = np.random.RandomState(41)
    v = to_lod_value(tlod.LoDTensor(rng.randn(11, 3).astype(np.float32),
                                    [tlod.lengths_to_offsets(LENGTHS)]),
                     torch.device("cpu"))
    assert v.max_lens == (5,)
    prog = tir.Program()
    b = prog.global_block()
    for n, shape in (("x", (-1, 3)), ("w", (3, 4)), ("y", (-1, 4)),
                     ("bias", (4,)), ("z", (-1, 4))):
        b.create_var(name=n, shape=shape, dtype="float32")
    b.append_op(type="mul", inputs={"X": ["x"], "Y": ["w"]},
                outputs={"Out": ["y"]})
    b.append_op(type="elementwise_add", inputs={"X": ["y"], "Y": ["bias"]},
                outputs={"Out": ["z"]}, attrs={"axis": 1})
    z, = TExecutor("cpu").run(
        prog, feed={"x": v, "w": rng.randn(3, 4).astype(np.float32),
                    "bias": rng.randn(4).astype(np.float32)},
        fetch_list=["z"], scope=TScope(), return_numpy=False)
    assert isinstance(z, LoDValue) and z.max_lens == (5,)
    assert z.lod[0].tolist() == tlod.lengths_to_offsets(LENGTHS)
