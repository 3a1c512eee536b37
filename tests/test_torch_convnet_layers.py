"""The layer functions, ``nets`` and ``evaluator`` of the rest of the
conv-net path against the JAX package's, on the CPU.

- Programs: each layer function (``dropout``, ``conv2d_transpose``,
  ``conv3d_transpose``, ``conv3d``, ``pool3d``, ``auc``,
  ``l2_normalize``, ``lrn``, ``prelu``, ``maxout``, ``edit_distance``)
  and each net (``simple_img_conv_pool``, ``img_conv_group`` with batch
  norm and dropout, ``glu``, ``scaled_dot_product_attention``) builds,
  through each package's layers under its name guard, main and startup
  programs whose ops have the same types, inputs, outputs and attrs and
  whose variables the same names, shapes, dtypes, LoD levels and flags.
- A few run in both on the same feeds from the JAX startup's state,
  their outputs within 1e-6 of max(1, |the JAX value|) (``OP_TOL``).
- ``Accuracy`` and ``EditDistance`` accumulate over three batches to the
  same totals in both; ``reset`` zeroes them. ``ChunkEvaluator`` and
  ``nets.sequence_conv_pool`` (ROADMAP.md Queue 1 item 5a) against the
  JAX package's the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import evaluator as jevaluator  # noqa: E402
from paddle_tpu import nets as jnets  # noqa: E402
from paddle_tpu_torch import evaluator as tevaluator  # noqa: E402
from paddle_tpu_torch import nets as tnets  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.core.scope import scope_guard as tscope_guard  # noqa: E402
from torch_optim import (JAX, OP_TOL, PKGS, PORT, build, jax_run,  # noqa: E402
                         jax_startup_state, port_run, rel)

NETS = {JAX.name: jnets, PORT.name: tnets}


def _data(L, name, shape, dtype="float32"):
    return L.data(name=name, shape=shape, dtype=dtype,
                  append_batch_size=False)


def _img(L, c=4, hw=6, n=2):
    return _data(L, "img", [n, c, hw, hw])


def _vol(L):
    return _data(L, "vol", [2, 4, 5, 5, 5])


def _net(p, name, **kw):
    return getattr(NETS[p.name], name)(**kw)


BUILDERS = {
    "dropout": lambda p: p.layers.dropout(_img(p.layers), 0.3),
    "dropout_is_test": lambda p: p.layers.dropout(
        _img(p.layers), dropout_prob=0.5, is_test=True, seed=3),
    "conv2d_transpose": lambda p: p.layers.conv2d_transpose(
        _img(p.layers), num_filters=6, filter_size=3, stride=2, padding=1,
        act="relu"),
    "conv2d_transpose_output_size_groups": lambda p:
        p.layers.conv2d_transpose(_img(p.layers), num_filters=6,
                                  output_size=[13, 12], stride=2,
                                  dilation=1, groups=2, bias_attr=False),
    "conv3d_transpose": lambda p: p.layers.conv3d_transpose(
        _vol(p.layers), num_filters=4, filter_size=[2, 3, 2], stride=2,
        groups=2),
    "conv3d_transpose_output_size": lambda p: p.layers.conv3d_transpose(
        _vol(p.layers), num_filters=3, output_size=9, padding=1),
    "conv3d": lambda p: p.layers.conv3d(
        _vol(p.layers), num_filters=6, filter_size=3, padding=1,
        act="relu"),
    "conv3d_grouped_strided": lambda p: p.layers.conv3d(
        _vol(p.layers), num_filters=6, filter_size=[3, 2, 3],
        stride=[2, 1, 1], dilation=[1, 2, 1], groups=2, bias_attr=False),
    "pool3d": lambda p: p.layers.pool3d(
        _vol(p.layers), pool_size=2, pool_stride=2),
    "pool3d_avg_ceil": lambda p: p.layers.pool3d(
        _vol(p.layers), pool_size=[3, 3, 2], pool_type="avg",
        pool_stride=2, pool_padding=[1, 1, 0], ceil_mode=True),
    "pool3d_global": lambda p: p.layers.pool3d(
        _vol(p.layers), pool_type="avg", global_pooling=True),
    "auc": lambda p: p.layers.auc(_data(p.layers, "prob", [8, 2]),
                                  _data(p.layers, "lab", [8, 1], "int64"),
                                  num_thresholds=50),
    "l2_normalize": lambda p: p.layers.l2_normalize(
        _data(p.layers, "x", [3, 5]), axis=1),
    "lrn": lambda p: p.layers.lrn(_img(p.layers), n=5, alpha=1e-4,
                                  beta=0.75),
    "prelu_all": lambda p: p.layers.prelu(_img(p.layers)),
    "prelu_channel": lambda p: p.layers.prelu(_img(p.layers), "channel"),
    "prelu_element": lambda p: p.layers.prelu(_img(p.layers), "element"),
    "maxout": lambda p: p.layers.maxout(_img(p.layers), groups=2),
    "edit_distance": lambda p: p.layers.edit_distance(
        _data(p.layers, "hyp", [3, 6], "int64"),
        _data(p.layers, "ref", [3, 4], "int64"), normalized=True),
    "simple_img_conv_pool": lambda p: _net(
        p, "simple_img_conv_pool", input=_img(p.layers, c=1, hw=12),
        num_filters=4, filter_size=5, pool_size=2, pool_stride=2,
        act="relu"),
    "img_conv_group_bn_dropout": lambda p: _net(
        p, "img_conv_group", input=_img(p.layers, c=3, hw=8),
        conv_num_filter=[4, 4], pool_size=2, conv_act="relu",
        conv_with_batchnorm=True, conv_batchnorm_drop_rate=[0.3, 0.0],
        pool_stride=2),
    "img_conv_group_plain": lambda p: _net(
        p, "img_conv_group", input=_img(p.layers, c=3, hw=8),
        conv_num_filter=[4, 6, 8], pool_size=2, conv_padding=[1, 1, 0],
        conv_act="tanh", pool_stride=2, pool_type="avg"),
    "glu": lambda p: _net(p, "glu", input=_data(p.layers, "x", [4, 8])),
    "sdpa_one_head": lambda p: _net(
        p, "scaled_dot_product_attention",
        queries=_data(p.layers, "q", [2, 5, 8]),
        keys=_data(p.layers, "k", [2, 7, 8]),
        values=_data(p.layers, "v", [2, 7, 6])),
    "sdpa_four_heads_dropout": lambda p: _net(
        p, "scaled_dot_product_attention",
        queries=_data(p.layers, "q", [2, 5, 8]),
        keys=_data(p.layers, "k", [2, 7, 8]),
        values=_data(p.layers, "v", [2, 7, 8]), num_heads=4,
        dropout_rate=0.2),
}


def program_of(main, start):
    """Everything the two programs must share, by block: the ops' types,
    slots and attrs (numpy values as lists), and every variable's name,
    shape, dtype, LoD level and flags."""
    out = []
    for prog in (main, start):
        blk = prog.global_block()
        ops = []
        for op in blk.ops:
            attrs = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in op.attrs.items()}
            ops.append((op.type, dict(op.inputs), dict(op.outputs), attrs))
        out.append((ops, sorted(
            (v.name, None if v.shape is None else tuple(v.shape),
             None if v.dtype is None else str(v.dtype), v.lod_level,
             v.persistable, v.stop_gradient)
            for v in blk.vars.values())))
    return out


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layer_and_net_build_the_jax_program(name):
    progs = {}
    for pkg in PKGS:
        main, start, _ = build(pkg, BUILDERS[name])
        progs[pkg.name] = program_of(main, start)
    assert progs["port"] == progs["jax"]


def test_every_layer_function_of_the_slice_is_exported():
    for name in ("dropout", "conv2d_transpose", "conv3d_transpose",
                 "conv3d", "pool3d", "auc", "l2_normalize", "lrn", "prelu",
                 "maxout", "edit_distance"):
        assert callable(getattr(PORT.layers, name)), name
        assert callable(getattr(JAX.layers, name)), name
    assert set(tnets.__all__) == set(jnets.__all__)


RUNS = ["conv2d_transpose_output_size_groups", "conv3d_transpose",
        "conv3d_grouped_strided", "pool3d_avg_ceil", "lrn",
        "prelu_channel", "maxout", "simple_img_conv_pool",
        "img_conv_group_plain", "glu", "sdpa_four_heads_dropout",
        "dropout_is_test", "l2_normalize"]


def _feeds_of(main, seed):
    rng = np.random.RandomState(seed)
    blk = main.global_block()
    made = {n for op in blk.ops for n in op.output_arg_names}
    feed = {}
    for op in blk.ops:
        for n in op.input_arg_names:
            v = blk.var(n)
            if n in made or v.persistable or n in feed:
                continue
            if str(v.dtype) == "int64":
                feed[n] = rng.randint(0, 4, v.shape).astype(np.int64)
            else:
                feed[n] = rng.randn(*v.shape).astype(np.float32)
    return feed


@pytest.mark.parametrize("name", RUNS)
def test_layer_and_net_compute_what_jax_computes(name):
    """From the JAX startup's state, on the same feeds; the dropout of
    ``sdpa_four_heads_dropout`` is a training dropout, so that case runs
    with its dropout's probability scaled out: both packages run it with
    the rate the program holds and fetch the input to the dropout and
    the final output's shape only."""
    jmain, jstart, jout = build(JAX, BUILDERS[name])
    tmain, _, tout = build(PORT, BUILDERS[name])
    state = jax_startup_state(jmain, jstart)
    feed = _feeds_of(jmain, len(name))
    if name == "sdpa_four_heads_dropout":
        drop = next(op for op in jmain.global_block().ops
                    if op.type == "dropout")
        fetch = [drop.input("X")[0], jout.name]
    else:
        fetch = [o.name for o in (jout if isinstance(jout, list)
                                  else [jout])]
    want = jax_run(jmain, state, [feed], fetch)[0][0]
    got = port_run(tmain, state, [feed], fetch)[0][0]
    if name == "sdpa_four_heads_dropout":
        want, got = want[:1], got[:1]
        assert got[0].shape == want[0].shape
    for j, t in zip(want, got):
        assert t.shape == j.shape and rel(t, j) <= OP_TOL, rel(t, j)


def test_sequence_conv_pool_waits_on_item_5():
    """Item 5 has landed: ``sequence_conv_pool`` builds the JAX program
    and computes what it computes from the JAX startup's state, on a
    ragged batch with a length-1 sequence (``OP_TOL``)."""
    def fn(p):
        x = p.layers.data("w", shape=[4], dtype="float32", lod_level=1)
        return _net(p, "sequence_conv_pool", input=x, num_filters=3,
                    filter_size=3, act="tanh", pool_type="sqrt")
    (jmain, jstart, jout), (tmain, tstart, tout) = [build(p, fn)
                                                    for p in PKGS]
    assert program_of(tmain, tstart) == program_of(jmain, jstart)
    state = jax_startup_state(jmain, jstart)
    rows = np.random.RandomState(3).randn(7, 4).astype(np.float32)
    lod = [[0, 3, 4, 7]]
    want = jax_run(jmain, state, [{"w": jpt.core.lod.LoDTensor(rows, lod)}],
                   [jout.name])[0][0][0]
    from paddle_tpu_torch.core.lod import LoDTensor
    got = port_run(tmain, state, [{"w": LoDTensor(rows, lod)}],
                   [tout.name])[0][0][0]
    assert got.shape == want.shape == (3, 3)
    assert rel(got, want) <= OP_TOL


def test_chunk_evaluator_waits_on_item_5():
    """Item 5 has landed: ``ChunkEvaluator`` accumulates the chunk counts
    of three batches to the same precision, recall and F1 in both
    packages (its ``chunk_eval`` on the hybrid path of the port), and
    ``reset`` zeroes them."""
    def fn(p):
        inf = p.layers.data("inf", shape=[1], dtype="int64", lod_level=1)
        lab = p.layers.data("lab", shape=[1], dtype="int64", lod_level=1)
        ev = {JAX.name: jevaluator, PORT.name: tevaluator}[p.name]
        return ev.ChunkEvaluator(inf, lab, "IOB", 3)
    rng = np.random.RandomState(4)
    feeds = []
    for _ in range(3):
        lod = [[0, 5, 6, 12]]
        lab = rng.randint(0, 7, (12, 1)).astype(np.int64)
        inf = np.where(rng.rand(12, 1) < 0.3, rng.randint(0, 7, (12, 1)),
                       lab).astype(np.int64)
        feeds.append((inf, lab, lod))
    got = {}
    for pkg in PKGS:
        main, start, ev = build(pkg, fn)
        if pkg is JAX:
            scope, guard = jpt.Scope(), jpt.scope_guard
            exe = jpt.Executor(jpt.CPUPlace())
            mk = jpt.core.lod.LoDTensor
        else:
            from paddle_tpu_torch.core.lod import LoDTensor as mk
            scope, guard = TScope(), tscope_guard
            exe = TExecutor("cpu")
        with pkg.program_guard(main, start), guard(scope):
            exe.run(start)
            for inf, lab, lod in feeds:
                exe.run(main, feed={"inf": mk(inf, lod), "lab": mk(lab, lod)},
                        fetch_list=[ev.metrics[0]])
            out = ev.eval(exe)
            states = [int(ev._state_value(s)[0]) for s in ev.states]
            ev.reset(exe)
            zeros = [ev._state_value(s) for s in ev.states]
        got[pkg.name] = (out, states, zeros)
        if pkg is PORT:
            assert exe.stats["hybrid_runs"] == 3
    (jout, jst, _), (tout, tst, tzero) = got["jax"], got["port"]
    assert tst == jst and tst[1] > 0 and tst[2] > 0
    np.testing.assert_allclose(np.asarray(tout, np.float64),
                               np.asarray(jout, np.float64), rtol=1e-6)
    assert all(not np.any(z) for z in tzero)


def _evaluators(pkg):
    L = pkg.layers
    ev = {JAX.name: jevaluator, PORT.name: tevaluator}[pkg.name]
    prob = _data(L, "prob", [6, 5])
    label = _data(L, "label", [6, 1], "int64")
    hyp = _data(L, "hyp", [6, 4], "int64")
    ref = _data(L, "ref", [6, 3], "int64")
    return ev.Accuracy(prob, label, k=2), ev.EditDistance(hyp, ref)


def _evaluate(pkg, main, start, evs, feeds):
    """Three batches, then each evaluator's eval and states, then the
    states after a reset."""
    if pkg is JAX:
        scope, guard = jpt.Scope(), jpt.scope_guard
        exe = jpt.Executor(jpt.CPUPlace())
    else:
        scope, guard = TScope(), tscope_guard
        exe = TExecutor("cpu")
    with guard(scope):
        exe.run(start)
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[evs[0].metrics[0]])
        out = [evs[0].eval(exe), evs[1].eval(exe)]
        states = [ev._state_value(s) for ev in evs for s in ev.states]
        for ev in evs:
            ev.reset(exe)
        zeros = [ev._state_value(s) for ev in evs for s in ev.states]
    return out, states, zeros


def test_accuracy_and_edit_distance_accumulate_like_jax():
    rng = np.random.RandomState(9)
    feeds = [{"prob": rng.rand(6, 5).astype(np.float32),
              "label": rng.randint(0, 5, (6, 1)).astype(np.int64),
              "hyp": rng.randint(0, 3, (6, 4)).astype(np.int64),
              "ref": rng.randint(0, 3, (6, 3)).astype(np.int64)}
             for _ in range(3)]
    got = {}
    for pkg in PKGS:
        main, start, evs = build(pkg, _evaluators)
        with pkg.program_guard(main, start):
            got[pkg.name] = _evaluate(pkg, main, start, evs, feeds)
    (jout, jstates, jzero), (tout, tstates, tzero) = got["jax"], got["port"]
    assert len(tstates) == len(jstates) == 5
    for j, t in zip(jstates, tstates):
        np.testing.assert_allclose(np.asarray(t, np.float64),
                                   np.asarray(j, np.float64), rtol=1e-6)
    # 18 rows seen: the totals of three batches
    assert int(tstates[0][0]) == 18 and int(tstates[3][0]) == 18
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(tout[1]), np.asarray(jout[1]),
                               rtol=1e-6)
    assert all(not np.any(z) for z in tzero)
    assert all(not np.any(z) for z in jzero)
