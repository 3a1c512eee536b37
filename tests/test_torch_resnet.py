"""The port's conv-net training path against the JAX package's, on the
CPU: the ops of ResNet's training step one at a time, then ImageNet
ResNet-50 trained for 3 Momentum steps in both packages from the same
state, then the CIFAR config through the port's CLI.

Single-op programs hold one forward op (and, where it has one, its grad
op fed a cotangent), built with the same var names, shapes and attrs in
both packages and fed the same numpy arrays made from a seed. Tolerance:
the largest absolute error <= 1e-5 x max(1, largest magnitude of the JAX
output), float32 on both sides (XLA and PyTorch sum in other orders,
~1e-7 relative a value).

ResNet-50 runs at 64 x 64 with 10 classes, batch 4, ``Momentum(0.01,
0.9)`` and ``conv_impl=pallas3x3`` (the JAX side runs the conv3x3 Pallas
kernel in interpret mode; the port's wrapper takes its plain version on
the CPU), from the JAX startup state carried across with
``scope_from_numpy``. Smaller inputs leave stage 4 with one pixel and its
batch norms with two values a channel, where the loss jumps to the
clip ceiling. Tolerances: the step-0 loss within 1e-5 relative; every
parameter and running statistic after step 1 within 1e-4 relative norm
(53 convs and batch norms deep, sum orders differ), with the floor the
test states for gradients that are zero but for noise; the losses of steps
1 and 2 within 1e-3 absolute (the loss falls to ~1e-2 on the one batch,
where the step-1 differences are amplified).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.core import registry as jregistry  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.configs import resnet_cifar as tcfg  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import registry as tregistry  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope as TScope,  # noqa: E402
                                         scope_from_numpy, scope_to_numpy)
from paddle_tpu_torch.flags import FLAGS  # noqa: E402
from paddle_tpu_torch.ops import nn_ops  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _run_single(pkg, ops, feeds, fetches):
    """Build one program of ``ops`` ([(type, inputs, outputs, attrs)],
    slots -> var names) in ``pkg`` ("jax" or "port"), with a var for
    every fed array and every output, and run it once on the CPU."""
    shapes = {n: a.shape for n, a in feeds.items()}
    dtypes = {n: str(a.dtype) for n, a in feeds.items()}
    prog = jpt.Program() if pkg == "jax" else tir.Program()
    block = prog.global_block()
    for _, inputs, outputs, _ in ops:
        for names in list(inputs.values()) + list(outputs.values()):
            for n in names:
                if not block.has_var(n):
                    block.create_var(name=n, shape=shapes.get(n),
                                     dtype=dtypes.get(n, "float32"))
    for t, inputs, outputs, attrs in ops:
        block.append_op(type=t, inputs=inputs, outputs=outputs,
                        attrs=dict(attrs))
    if pkg == "jax":
        with jpt.scope_guard(jpt.Scope()):
            outs = jpt.Executor(jpt.CPUPlace()).run(prog, feed=feeds,
                                                    fetch_list=fetches)
        return [np.asarray(o) for o in outs]
    return TExecutor("cpu").run(prog, feed=feeds, fetch_list=fetches,
                                scope=TScope())


def _assert_ops_match(ops, feeds, fetches):
    want = _run_single("jax", ops, feeds, fetches)
    got = _run_single("port", ops, feeds, fetches)
    for name, g, w in zip(fetches, got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        err = float(np.abs(g.astype(np.float64) - w).max()) if w.size else 0.
        assert err <= TOL * max(1.0, float(np.abs(w).max())), (name, err)
    return got, want


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


CONV_CASES = [
    # (x shape, w shape, strides, paddings)
    ((2, 4, 9, 9), (6, 4, 3, 3), [1, 1], [1, 1]),
    ((2, 4, 9, 9), (6, 4, 3, 3), [2, 2], [1, 1]),
    ((2, 8, 6, 6), (5, 8, 1, 1), [1, 1], [0, 0]),
    ((2, 8, 7, 7), (5, 8, 1, 1), [2, 2], [0, 0]),
    ((2, 3, 16, 16), (4, 3, 7, 7), [2, 2], [3, 3]),
]


@pytest.mark.parametrize("impl", ["conv", "pallas3x3"])
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv2d_and_its_grad_match_jax(case, impl, monkeypatch):
    # the conv lowering of both packages, through their shared override
    monkeypatch.setenv("PADDLE_TPU_CONV_IMPL", impl)
    xs, ws, s, p = CONV_CASES[case]
    rng = np.random.RandomState(case)
    x, w = _randn(rng, *xs), _randn(rng, *ws) * 0.3
    oh = (xs[2] + 2 * p[0] - ws[2]) // s[0] + 1
    ow = (xs[3] + 2 * p[1] - ws[3]) // s[1] + 1
    dy = _randn(rng, xs[0], ws[0], oh, ow)
    attrs = {"strides": s, "paddings": p, "dilations": [1, 1], "groups": 1}
    ops = [("conv2d", {"Input": ["x"], "Filter": ["w"]},
            {"Output": ["y"]}, attrs),
           ("conv2d_grad", {"Input": ["x"], "Filter": ["w"],
                            "Output@GRAD": ["dy"]},
            {"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]}, attrs)]
    kernels.reset_launches()
    _assert_ops_match(ops, {"x": x, "w": w, "dy": dy}, ["y", "dx", "dw"])
    # the CPU takes the plain versions: no launch is counted
    assert set(kernels.launch_counts().values()) == {0}


def _conv3x3_config(w_shape, s, p, d, groups, program_choice=None):
    """The conv's dispatch decision with the tune cache off: what the
    flag alone routes (``{}`` = the kernel, None = torch's conv2d)."""
    return nn_ops.conv3x3_config((2, w_shape[1], 9, 9), w_shape, s, p, d,
                                 groups, torch.float32, program_choice)


def test_conv2d_routes_only_its_population_to_the_kernel(monkeypatch):
    monkeypatch.setattr(FLAGS, "tune", False)
    monkeypatch.setenv("PADDLE_TPU_CONV_IMPL", "pallas3x3")
    assert _conv3x3_config((6, 4, 3, 3), [1, 1], [1, 1], [1, 1], 1) == {}
    assert _conv3x3_config((6, 4, 3, 3), [2, 2], [1, 1], [1, 1], 1) is None
    assert _conv3x3_config((6, 4, 1, 1), [1, 1], [0, 0], [1, 1], 1) is None
    monkeypatch.setenv("PADDLE_TPU_CONV_IMPL", "conv")
    assert _conv3x3_config((6, 4, 3, 3), [1, 1], [1, 1], [1, 1], 1) is None


def test_conv_knobs_that_are_not_ported_raise(monkeypatch):
    """The three knobs that raised until the port had them (matmul, nhwc,
    s2d) now run: under each, a 3x3 conv's dispatch decision is made
    without raising, and with the cache off no knob but ``pallas3x3``
    routes it to the kernel (``tests/test_torch_conv_variants.py`` holds
    each knob's numbers)."""
    monkeypatch.setattr(FLAGS, "tune", False)
    monkeypatch.delenv("PADDLE_TPU_CONV_IMPL", raising=False)
    assert FLAGS.conv_impl == "conv" and nn_ops.conv_impl() == "conv"
    for env, value in (("PADDLE_TPU_CONV_IMPL", "matmul"),
                       ("PADDLE_TPU_CONV_LAYOUT", "nhwc"),
                       ("PADDLE_TPU_CONV_S2D", "1")):
        monkeypatch.setenv(env, value)
        assert _conv3x3_config((6, 4, 3, 3), [1, 1], [1, 1], [1, 1],
                               1) is None
        monkeypatch.delenv(env)
    assert nn_ops.conv_impl("matmul") == "matmul"


POOL_CASES = [
    # (pooling_type, ksize, strides, paddings, ceil_mode, exclusive)
    ("max", [3, 3], [2, 2], [1, 1], False, True),
    ("max", [3, 3], [2, 2], [0, 0], True, True),
    ("avg", [2, 2], [2, 2], [0, 0], False, True),
    ("avg", [3, 3], [2, 2], [1, 1], False, True),
    ("avg", [3, 3], [2, 2], [1, 1], False, False),
    ("avg", [3, 3], [2, 2], [1, 1], True, True),
]


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool2d_and_its_grad_match_jax(case):
    ptype, k, s, p, ceil, exclusive = POOL_CASES[case]
    rng = np.random.RandomState(10 + case)
    x = _randn(rng, 2, 3, 10, 10)
    attrs = {"pooling_type": ptype, "ksize": k, "strides": s,
             "paddings": p, "global_pooling": False, "ceil_mode": ceil,
             "exclusive": exclusive}
    y = _run_single("jax", [("pool2d", {"X": ["x"]}, {"Out": ["y"]},
                             attrs)], {"x": x}, ["y"])[0]
    dy = _randn(rng, *y.shape)
    ops = [("pool2d", {"X": ["x"]}, {"Out": ["y"]}, attrs),
           ("pool2d_grad", {"X": ["x"], "Out@GRAD": ["dy"]},
            {"X@GRAD": ["dx"]}, attrs)]
    _assert_ops_match(ops, {"x": x, "dy": dy}, ["y", "dx"])


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_global_pool2d_and_its_grad_match_jax(ptype):
    rng = np.random.RandomState(20)
    x = _randn(rng, 2, 3, 4, 4)
    x[0, 0, 1, 1] = x[0, 0, 2, 3] = x[0, 0].max() + 1.0   # a tied maximum
    attrs = {"pooling_type": ptype, "ksize": [1, 1], "global_pooling": True}
    ops = [("pool2d", {"X": ["x"]}, {"Out": ["y"]}, attrs),
           ("pool2d_grad", {"X": ["x"], "Out@GRAD": ["dy"]},
            {"X@GRAD": ["dx"]}, attrs)]
    _assert_ops_match(ops, {"x": x, "dy": _randn(rng, 2, 3, 1, 1)},
                      ["y", "dx"])


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (8, 6)])
def test_batch_norm_and_its_grad_match_jax(shape, is_test):
    rng = np.random.RandomState(30)
    C = shape[1]
    feeds = {"x": _randn(rng, *shape) * 2 + 0.5,
             "scale": _randn(rng, C), "bias": _randn(rng, C),
             "mean": _randn(rng, C) * 0.1,
             "var": np.abs(_randn(rng, C)) + 0.5,
             "dy": _randn(rng, *shape)}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": "NCHW"}
    ops = [("batch_norm",
            {"X": ["x"], "Scale": ["scale"], "Bias": ["bias"],
             "Mean": ["mean"], "Variance": ["var"]},
            {"Y": ["y"], "MeanOut": ["mean_out"], "VarianceOut": ["var_out"],
             "SavedMean": ["saved_mean"], "SavedVariance": ["saved_var"]},
            attrs),
           ("batch_norm_grad",
            {"X": ["x"], "Scale": ["scale"], "SavedMean": ["saved_mean"],
             "SavedVariance": ["saved_var"], "Y@GRAD": ["dy"]},
            {"X@GRAD": ["dx"], "Scale@GRAD": ["dscale"],
             "Bias@GRAD": ["dbias"]}, attrs)]
    got, _ = _assert_ops_match(
        ops, feeds, ["y", "mean_out", "var_out", "saved_mean", "saved_var",
                     "dx", "dscale", "dbias"])
    if not is_test:
        # Paddle's running-stat convention, with the biased variance
        axes = (0, 2, 3) if len(shape) == 4 else (0,)
        np.testing.assert_allclose(
            got[2], 0.9 * feeds["var"] + 0.1 * feeds["x"].var(axis=axes),
            rtol=1e-5)


def _bare_bn_grads(pkg, feeds, attrs):
    """A batch_norm op whose saved statistics are not wired, with the
    grad ops its registered grad maker appends for a cotangent of Y."""
    prog = jpt.Program() if pkg == "jax" else tir.Program()
    reg = jregistry if pkg == "jax" else tregistry
    block = prog.global_block()
    for n, a in feeds.items():
        block.create_var(name=n, shape=a.shape, dtype="float32")
    for n in ("y", "mean_out", "var_out"):
        block.create_var(name=n, dtype="float32")
    op = block.append_op(
        type="batch_norm",
        inputs={"X": ["x"], "Scale": ["scale"], "Bias": ["bias"],
                "Mean": ["mean"], "Variance": ["var"]},
        outputs={"Y": ["y"], "MeanOut": ["mean_out"],
                 "VarianceOut": ["var_out"]}, attrs=dict(attrs))
    descs = reg.lookup(op.type).grad_maker(op, block, {"y": "dy"}, set())
    fetches = ["y", "mean_out", "var_out"]
    for gtype, gin, gout, gattrs in descs:
        for names in gout.values():
            for n in names:
                block.create_var(name=n, dtype="float32")
        block.append_op(type=gtype, inputs=gin, outputs=gout, attrs=gattrs)
        fetches += [n for names in gout.values() for n in names]
    if pkg == "jax":
        with jpt.scope_guard(jpt.Scope()):
            outs = jpt.Executor(jpt.CPUPlace()).run(prog, feed=feeds,
                                                    fetch_list=fetches)
        outs = [np.asarray(o) for o in outs]
    else:
        outs = TExecutor("cpu").run(prog, feed=feeds, fetch_list=fetches,
                                    scope=TScope())
    return [d[0] for d in descs], dict(zip(fetches, outs))


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("shape", [(4, 6, 5, 5), (8, 6)])
def test_batch_norm_without_saved_stats_grads_match_jax(shape, is_test):
    # the grad maker's fallback: the generic replay of (X, Scale, Bias)
    # -> Y, the running-stat update left out
    rng = np.random.RandomState(31)
    C = shape[1]
    feeds = {"x": _randn(rng, *shape) * 2 + 0.5,
             "scale": _randn(rng, C), "bias": _randn(rng, C),
             "mean": _randn(rng, C) * 0.1,
             "var": np.abs(_randn(rng, C)) + 0.5,
             "dy": _randn(rng, *shape)}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": "NCHW"}
    jtypes, want = _bare_bn_grads("jax", feeds, attrs)
    ttypes, got = _bare_bn_grads("port", feeds, attrs)
    assert ttypes == jtypes == ["generic_grad"]
    assert sorted(got) == sorted(want) == sorted(
        ["y", "mean_out", "var_out", "x@GRAD", "scale@GRAD", "bias@GRAD"])
    for name, w in want.items():
        err = float(np.abs(got[name].astype(np.float64) - w).max())
        assert err <= TOL * max(1.0, float(np.abs(w).max())), (name, err)


@pytest.mark.parametrize("soft_label", [False, True])
def test_cross_entropy_and_its_grad_match_jax(soft_label):
    rng = np.random.RandomState(40)
    logits = _randn(rng, 6, 5) * 3
    x = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
         ).astype(np.float32)
    x[0, 0] = 1e-20                                   # under the clip
    if soft_label:
        label = np.abs(_randn(rng, 6, 5))
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.randint(0, 5, (6, 1)).astype(np.int64)
        label[0, 0] = 0
    attrs = {"soft_label": soft_label}
    ops = [("cross_entropy", {"X": ["x"], "Label": ["label"]},
            {"Y": ["y"]}, attrs),
           ("cross_entropy_grad",
            {"X": ["x"], "Label": ["label"], "Y@GRAD": ["dy"]},
            {"X@GRAD": ["dx"]}, attrs)]
    # the clipped row's gradient is zero in both (outside [1e-15, 1])
    got, _ = _assert_ops_match(
        ops, {"x": x, "label": label, "dy": _randn(rng, 6, 1)},
        ["y", "dx"])
    assert got[1][0, 0] == 0


def test_softmax_top_k_and_accuracy_match_jax():
    rng = np.random.RandomState(50)
    x = _randn(rng, 7, 9)
    label = rng.randint(0, 9, (7, 1)).astype(np.int64)
    ops = [("softmax", {"X": ["x"]}, {"Out": ["p"]}, {}),
           ("softmax_grad", {"Out": ["p"], "Out@GRAD": ["dp"]},
            {"X@GRAD": ["dx"]}, {}),
           ("top_k", {"X": ["p"]}, {"Out": ["vals"], "Indices": ["idx"]},
            {"k": 3}),
           ("accuracy", {"Out": ["vals"], "Indices": ["idx"],
                         "Label": ["label"]},
            {"Accuracy": ["acc"], "Correct": ["correct"],
             "Total": ["total"]}, {})]
    got, want = _assert_ops_match(
        ops, {"x": x, "label": label, "dp": _randn(rng, 7, 9)},
        ["p", "dx", "vals", "idx", "acc", "correct", "total"])
    assert got[3].dtype == np.int64
    assert got[5].dtype == want[5].dtype == np.int32


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_matches_jax(nesterov):
    rng = np.random.RandomState(60)
    feeds = {"p": _randn(rng, 5, 4), "g": _randn(rng, 5, 4),
             "v": _randn(rng, 5, 4), "lr": np.array([0.1], np.float32)}
    ops = [("momentum", {"Param": ["p"], "Grad": ["g"], "Velocity": ["v"],
                         "LearningRate": ["lr"]},
            {"ParamOut": ["p_out"], "VelocityOut": ["v_out"]},
            {"mu": 0.9, "use_nesterov": nesterov})]
    got, _ = _assert_ops_match(ops, feeds, ["p_out", "v_out"])
    v = 0.9 * feeds["v"] + feeds["g"]
    step = feeds["g"] + 0.9 * v if nesterov else v
    np.testing.assert_allclose(got[0], feeds["p"] - 0.1 * step, rtol=1e-6)


# -- ResNet-50, three Momentum steps in both packages -------------------------

R50 = dict(variant="imagenet", depth=50, image=64, class_dim=10, batch=4,
           samples=4, learning_rate=0.01)
STEPS = 3


def _jax_model():
    """The JAX twin of ``configs/resnet_cifar.model(**R50)``."""
    img = jlayers.data(name="img", shape=[3, R50["image"], R50["image"]],
                       dtype="float32")
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    pred = jmodels.resnet(img, class_dim=R50["class_dim"],
                          depth=R50["depth"], variant=R50["variant"])
    avg_cost = jlayers.mean(x=jlayers.cross_entropy(input=pred, label=label))
    jlayers.accuracy(input=pred, label=label)
    opt = jpt.optimizer.Momentum(learning_rate=R50["learning_rate"],
                                 momentum=0.9)
    opt.minimize(avg_cost)
    return avg_cost


def _signature(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
            for op in program.global_block().ops]


@pytest.fixture(scope="module")
def r50_run():
    # The JAX package reads its conv lowering from the environment when
    # each conv executes; the port's program carries the config's choice
    # on its conv ops, so the port side runs with the variable unset.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PADDLE_TPU_CONV_IMPL", "pallas3x3")
        jmain, jstart = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(jmain, jstart):
            jcost = _jax_model()
        persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
        tmain, tstart = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(tmain, tstart):
            spec = tcfg.model(**R50)
            spec["optimizer"].minimize(spec["cost"])
        batch = next(iter(spec["reader"]()))
        feed = {"img": np.stack([b[0] for b in batch]),
                "label": np.stack([b[1] for b in batch])}
        jexe = jpt.Executor(jpt.CPUPlace())
        jscope = jpt.Scope()
        with jpt.scope_guard(jscope):
            jexe.run(jstart)
            state = {n: np.asarray(jscope.find_var(n)) for n in persist
                     if jscope.find_var(n) is not None}
            jlosses, jafter1 = [], None
            for _ in range(STEPS):
                out = jexe.run(jmain, feed=feed, fetch_list=[jcost])
                jlosses.append(float(np.asarray(out[0]).reshape(-1)[0]))
                if jafter1 is None:
                    jafter1 = {n: np.asarray(jscope.find_var(n))
                               for n in state}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("PADDLE_TPU_CONV_IMPL", raising=False)
        texe = TExecutor("cpu")
        tscope = scope_from_numpy(state, device="cpu", scope=TScope())
        kernels.reset_launches()
        tlosses, tafter1 = [], None
        for _ in range(STEPS):
            out = texe.run(tmain, feed=feed, fetch_list=[spec["cost"]],
                           scope=tscope)
            tlosses.append(float(out[0].reshape(-1)[0]))
            if tafter1 is None:
                tafter1 = scope_to_numpy(tscope, names=state)
        launches = kernels.launch_counts()
    return dict(jmain=jmain, tmain=tmain, jlosses=jlosses, tlosses=tlosses,
                start=state, jafter1=jafter1, tafter1=tafter1,
                launches=launches)


def test_resnet50_programs_match_op_for_op(r50_run):
    jmain, tmain = r50_run["jmain"], r50_run["tmain"]
    assert _signature(tmain) == _signature(jmain)
    convs = [op for op in tmain.global_block().ops if op.type == "conv2d"]
    k3 = [op for op in convs if nn_ops.conv3x3.supports_conv3x3(
        tmain.global_block().var(op.input("Filter")[0]).shape,
        op.attr("strides"), op.attr("paddings"), op.attr("dilations"),
        op.attr("groups"))]
    # 53 convs, the 16 3x3 ones all stride 1 / pad 1 (the kernel's)
    assert len(convs) == 53 and len(k3) == 16
    grads = [op for op in tmain.global_block().ops
             if op.type == "conv2d_grad" and op.output("Input@GRAD")]
    assert len(grads) == 52          # every conv but the stem on the image


def test_resnet50_step0_loss_matches_jax(r50_run):
    j, t = r50_run["jlosses"][0], r50_run["tlosses"][0]
    assert np.isfinite(t) and abs(t - j) <= 1e-5 * abs(j)


def test_resnet50_state_after_step1_matches_jax(r50_run):
    jafter, tafter, start = (r50_run["jafter1"], r50_run["tafter1"],
                             r50_run["start"])
    assert sorted(tafter) == sorted(jafter)
    stats = [n for n in jafter if n.startswith("batch_norm")
             and n.endswith(("w_1", "w_2"))]
    assert len(stats) == 2 * 53      # running mean and variance a norm
    # The bias of each bottleneck's last batch norm has a gradient that is
    # zero but for float32 noise (~1e-7 against gradients of ~1): the
    # residual add carries no relu (a fault of the reference the port
    # mirrors), so the shift reaches the loss only through later batch
    # norms, which remove it. Noise has no sign to agree on, so each
    # error is held to 1e-4 of its parameter's norm plus a floor of 1e-6
    # of the largest step-1 update of any parameter.
    floor = 1e-6 * max(float(np.linalg.norm(jafter[n] - start[n]))
                       for n in jafter)
    for name, want in jafter.items():
        got = tafter[name]
        assert got.shape == want.shape, name
        err = float(np.linalg.norm(got - want))
        assert err <= 1e-4 * float(np.linalg.norm(want)) + floor, \
            (name, err, float(np.linalg.norm(want)))


def test_resnet50_losses_match_jax_and_fall(r50_run):
    j, t = r50_run["jlosses"], r50_run["tlosses"]
    np.testing.assert_allclose(t[1:], j[1:], rtol=0, atol=1e-3)
    assert t[-1] < t[0]
    assert set(r50_run["launches"].values()) == {0}


@pytest.mark.parametrize("impl", ["pallas3x3", "conv"])
def test_cifar_config_opts_only_its_own_program_into_the_kernel(
        impl, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_CONV_IMPL", raising=False)
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    conv3x3 = nn_ops.conv3x3
    monkeypatch.setattr(conv3x3, "conv3x3_s1_nhwc",
                        counted("fwd", conv3x3.conv3x3_s1_nhwc))
    monkeypatch.setattr(conv3x3, "conv3x3_bwd",
                        counted("bwd", conv3x3.conv3x3_bwd))
    main, startup = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, startup):
        spec = tcfg.model(conv_impl=impl)
        spec["optimizer"].minimize(spec["cost"])
    # the choice rides on the program's conv ops, not on the process flag
    assert FLAGS.conv_impl == "conv"
    ops = main.global_block().ops
    convs = [op for op in ops if op.type == "conv2d"]
    assert {op.attr("conv_impl") for op in ops
            if op.type in ("conv2d", "conv2d_grad")} == {impl}
    k3 = [op for op in convs if nn_ops.conv3x3.supports_conv3x3(
        main.global_block().var(op.input("Filter")[0]).shape,
        op.attr("strides"), op.attr("paddings"), op.attr("dilations"),
        op.attr("groups"))]
    batch = next(iter(spec["reader"]()))
    feed = {"img": np.stack([b[0] for b in batch]),
            "label": np.stack([b[1] for b in batch])}
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(startup, scope=scope)
    loss, = exe.run(main, feed=feed, fetch_list=[spec["cost"]], scope=scope)
    assert np.isfinite(loss).all()
    # ResNet-20: the stem and 16 of the blocks' 18 3x3 convs are s1 / p1
    assert len(k3) == 17
    want = len(k3) if impl == "pallas3x3" else 0
    assert calls == {"fwd": want, "bwd": want}
    # a conv2d op that carries no choice still takes the process default
    monkeypatch.setattr(FLAGS, "tune", False)
    assert _conv3x3_config((6, 4, 3, 3), [1, 1], [1, 1], [1, 1], 1) is None


def test_cli_trains_the_cifar_config_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join("paddle_tpu_torch", "configs", "resnet_cifar.py"),
         "--device", "cpu", "--log_period", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    costs = [float(ln.split(" cost ")[1]) for ln in out.stdout.splitlines()
             if ln.startswith("pass ") and " cost " in ln]
    assert len(costs) == 4                  # 32 samples in batches of 8
    assert all(np.isfinite(costs))
