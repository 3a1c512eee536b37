"""Shared by the checkpoint and program tests of the port: the port's book
configs and their JAX twins, built alike under each package's
``unique_name.guard()`` (so that every variable has the same name in
both), the same numpy feeds for both, and training runs of each package
from one state (the JAX startup's, carried into the port's scope: the
two initializers draw from different generators).

Kinds: ``fit_a_line``, ``tiny_lm`` and ``recognize_digits_conv`` (the
JAX configs of ``examples/configs`` beside the port's), ``resnet_cifar``
(a ResNet-8 at 16 x 16, batch 4, its convs on the plain path in both)
and ``text_rnn`` (the LSTM classifier at small widths on ragged words,
the recurrence on its scan path in both).
"""
import importlib.util
import os

import numpy as np

import paddle_tpu as jpt
from paddle_tpu import layers as jlayers
from paddle_tpu import models as jmodels
from paddle_tpu.core import lod as jlod
from paddle_tpu.core import unique_name as jun
from paddle_tpu_torch.configs import fit_a_line as tfit
from paddle_tpu_torch.configs import recognize_digits_conv as tdigits
from paddle_tpu_torch.configs import resnet_cifar as tresnet
from paddle_tpu_torch.configs import text_rnn as trnn
from paddle_tpu_torch.configs import tiny_lm as ttiny
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.core import unique_name as tun
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.core.scope import scope_from_numpy, scope_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("fit_a_line", "tiny_lm", "resnet_cifar", "text_rnn",
         "recognize_digits_conv")
# losses within 1e-5 relative, persistables within 1e-5 of max(1, the
# largest magnitude): float32 on both sides, sums in other orders
REL_TOL = 1e-5
RNN = dict(vocab=200, hidden=32, layers=2, batch=4, learning_rate=0.002)
RESNET = dict(variant="cifar", depth=8, image=16, class_dim=10, batch=4)


def jax_config(name):
    spec = importlib.util.spec_from_file_location(
        "jax_book_" + name, os.path.join(ROOT, "examples", "configs",
                                         name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_rnn():
    words = jlayers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    inp = jlayers.embedding(input=words, size=[RNN["vocab"], RNN["hidden"]])
    for i in range(RNN["layers"]):
        proj = jlayers.fc(input=inp, size=RNN["hidden"] * 4)
        inp, _ = jlayers.dynamic_lstm(input=proj, size=RNN["hidden"] * 4,
                                      use_peepholes=False,
                                      is_reverse=(i % 2 == 1))
    pooled = jlayers.sequence_pool(input=inp, pool_type="max")
    pred = jlayers.fc(input=pooled, size=2, act="softmax")
    cost = jlayers.mean(jlayers.cross_entropy(input=pred, label=label))
    return {"cost": cost, "feed_list": [words, label], "prediction": pred,
            "optimizer": jpt.optimizer.Adam(
                learning_rate=RNN["learning_rate"])}


def _jax_resnet():
    img = jlayers.data(name="img", shape=[3, RESNET["image"],
                                          RESNET["image"]], dtype="float32")
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    pred = jmodels.resnet(img, class_dim=RESNET["class_dim"],
                          depth=RESNET["depth"], variant=RESNET["variant"])
    cost = jlayers.mean(x=jlayers.cross_entropy(input=pred, label=label))
    acc = jlayers.accuracy(input=pred, label=label)
    return {"cost": cost, "metrics": [acc], "feed_list": [img, label],
            "prediction": pred,
            "optimizer": jpt.optimizer.Momentum(learning_rate=0.01,
                                                momentum=0.9)}


def _port_spec(kind):
    if kind == "fit_a_line":
        return tfit.model()
    if kind == "tiny_lm":
        return ttiny.model()
    if kind == "recognize_digits_conv":
        return tdigits.model()
    if kind == "resnet_cifar":
        return tresnet.model(samples=4 * RESNET["batch"], conv_impl="conv",
                             **RESNET)
    return trnn.model(lstm_impl="scan", samples=4 * RNN["batch"],
                      seq_len=8, **RNN)


def _jax_spec(kind):
    if kind == "resnet_cifar":
        return _jax_resnet()
    if kind == "text_rnn":
        return _jax_rnn()
    return jax_config(kind).model()


def prediction_name(kind, spec):
    """The name of the model's output before the loss: the fetch of an
    inference model."""
    if "prediction" in spec:
        return spec["prediction"].name
    cost_op = spec["cost"].op
    block = spec["cost"].block
    if kind == "fit_a_line":
        # mean(square_error_cost(fc)): the fc's output
        return block.var(cost_op.input("X")[0]).op.input("X")[0]
    if kind == "tiny_lm":
        # mean(softmax_with_cross_entropy(reshape(logits)))
        ce = block.var(cost_op.input("X")[0]).op
        return ce.input("Logits")[0]
    # mean(cross_entropy(softmax fc))
    ce = block.var(cost_op.input("X")[0]).op
    return ce.input("X")[0]


def build(pkg, kind, minimize=True):
    """(main, startup, spec) of ``kind`` in ``pkg`` ('jax' or 'port'),
    with the optimizer's ops appended when ``minimize``; ``spec`` gains
    ``prediction_name``."""
    if pkg == "jax":
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            spec = _jax_spec(kind)
            spec["prediction_name"] = prediction_name(kind, spec)
            if minimize:
                spec["optimizer"].minimize(spec["cost"])
    else:
        main, start = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, start):
            spec = _port_spec(kind)
            spec["prediction_name"] = prediction_name(kind, spec)
            if minimize:
                spec["optimizer"].minimize(spec["cost"])
    return main, start, spec


def _port_batches(kind):
    """The port config's reader's batches (lists of samples)."""
    main, start = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, start):
        spec = _port_spec(kind)
    return list(spec["reader"]())


def batches(kind, n):
    """``n`` batches of samples from the port config's reader, cycled."""
    bs = _port_batches(kind)
    return [bs[i % len(bs)] for i in range(n)]


def reader_of(batches_):
    """A batched reader over ``batches_``."""
    return lambda: iter(list(batches_))


def make_trainer(pkg, kind, **kw):
    """(Trainer of ``kind`` in ``pkg`` on the CPU, spec): built, with its
    optimizer, under the package's name guard; the metrics of the
    config are its extra fetches."""
    if pkg == "jax":
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            spec = _jax_spec(kind)
            spec["prediction_name"] = prediction_name(kind, spec)
            tr = jpt.Trainer(spec["cost"], spec["optimizer"],
                             spec["feed_list"], place=jpt.CPUPlace(),
                             fetch_list=spec.get("metrics"),
                             main_program=main, startup_program=start,
                             **kw)
    else:
        from paddle_tpu_torch.trainer import Trainer
        main, start = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, start):
            spec = _port_spec(kind)
            spec["prediction_name"] = prediction_name(kind, spec)
            tr = Trainer(spec["cost"], spec["optimizer"], spec["feed_list"],
                         device="cpu", fetch_list=spec.get("metrics"),
                         main_program=main, startup_program=start, **kw)
    return tr, spec


def init_from(tr, pkg, state):
    """Run ``tr``'s startup without a restore, then install ``state``
    into the global scope."""
    tr._maybe_init(load=False)
    if pkg == "jax":
        for n, v in state.items():
            jpt.global_scope().set_var(n, v)
    else:
        from paddle_tpu_torch.core.scope import global_scope
        scope_from_numpy(state, device="cpu", scope=global_scope())


def feeds(kind, pkg, n):
    """``n`` feed dicts of numpy arrays (a ragged feed as ``pkg``'s
    LoDTensor), from the port config's reader, cycled."""
    batches = _port_batches(kind)
    names = {"fit_a_line": ("x", "y"), "tiny_lm": ("toks", "tgt"),
             "recognize_digits_conv": ("img", "label"),
             "resnet_cifar": ("img", "label"),
             "text_rnn": ("words", "label")}[kind]
    out = []
    for i in range(n):
        b = batches[i % len(batches)]
        if kind == "text_rnn":
            lod_mod = jlod if pkg == "jax" else tlod
            out.append({"words": lod_mod.build_lod_tensor([s[0] for s in b]),
                        "label": np.stack([s[1] for s in b])})
        else:
            out.append({nm: np.stack([s[j] for s in b])
                        for j, nm in enumerate(names)})
    return out


def persist_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def jax_startup_state(main, start):
    """The JAX startup's persistables of ``main`` as numpy."""
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        jpt.Executor(jpt.CPUPlace()).run(start)
    return {n: np.asarray(scope.find_var(n)) for n in persist_names(main)
            if scope.find_var(n) is not None}


def jax_run(main, state, feeds_, fetch):
    """Run ``main`` over ``feeds_`` in the JAX package from ``state``:
    (each run's fetches as numpy, the final persistables)."""
    scope = jpt.Scope()
    exe = jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, v)
        outs = [[np.asarray(o) for o in exe.run(main, feed=f,
                                                fetch_list=fetch)]
                for f in feeds_]
        final = {n: np.asarray(scope.find_var(n)) for n in state}
    return outs, final


def port_run(main, state, feeds_, fetch, use_jit=True):
    """The same in the port on the CPU."""
    exe, scope = TExecutor("cpu"), TScope()
    scope_from_numpy(state, device="cpu", scope=scope)
    outs = [[np.asarray(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                            scope=scope, use_jit=use_jit)]
            for f in feeds_]
    return outs, scope_to_numpy(scope, names=state)


def rel(got, want):
    """The largest error over max(1, the largest magnitude of want)."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1.0))


def loss_rel(got, want):
    """The largest relative error of a list of losses."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))
