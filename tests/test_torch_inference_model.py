"""Inference models (``paddle_tpu_torch/io.py``: ``save_inference_model``,
``load_inference_model``, ``get_inference_program``) against the JAX
package's (``paddle_tpu/io.py:113-173``), on the CPU.

- The port's round trip on each book config: the program pruned to the
  model's output, its persistables beside it, loaded under a fresh uid
  in a new Executor and scope, runs to the pruned program's output in
  the trained scope bit for bit.
- Only the persistables the pruned ops read are saved: no optimizer
  state, no gradient.
- A ``__model__`` the JAX package wrote, with its parameter files, loads
  in the port and runs to the JAX outputs; in a fresh interpreter the
  load leaves neither ``paddle_tpu`` nor ``jax`` in ``sys.modules``.
- A pickle that names any other global is refused with
  ``pickle.UnpicklingError`` before anything runs.

Tolerance: the port against itself exact; against the JAX package
1e-5 of max(1, the largest magnitude) (float32, sums in other orders).
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch.core import ir  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope, global_scope,  # noqa: E402
                                         scope_guard)
from paddle_tpu_torch.trainer import Trainer  # noqa: E402

import torch_book as book  # noqa: E402

STEPS = 2


def _feed_names(kind):
    return {"fit_a_line": ["x"], "tiny_lm": ["toks"],
            "recognize_digits_conv": ["img"], "resnet_cifar": ["img"],
            "text_rnn": ["words"], "word2vec": ["w0", "w1", "w2", "w3"],
            "recommender": list(book.REC_FEEDS[:-1]),
            "image_classification_vgg": ["pixel"],
            "recognize_digits_nets": ["img"],
            "understand_sentiment_conv": ["words"],
            "understand_sentiment_lstm": ["words"],
            "label_semantic_roles": list(book.SRL_FEEDS[:-1])}[kind]


def _only(feed, names):
    return {n: v for n, v in feed.items() if n in names}


def _port_trained(kind, state):
    """Train ``kind`` STEPS batches in the port from ``state`` in the
    current global scope: the trainer and its spec."""
    tr, spec = book.make_trainer("port", kind)
    book.init_from(tr, "port", state)
    tr.train(book.reader_of(book.batches(kind, STEPS)), pipeline=False)
    return tr, spec


@pytest.mark.parametrize("kind", book.KINDS)
def test_port_round_trip(tmp_path, kind):
    jmain, jstart, _ = book.build("jax", kind)
    state = book.jax_startup_state(jmain, jstart)
    names = _feed_names(kind)
    feed = _only(book.feeds(kind, "port", 1)[0], names)
    d = str(tmp_path / "model")
    with scope_guard(Scope()):
        tr, spec = _port_trained(kind, state)
        target = spec["prediction_name"]
        fetched = tr.save_inference_model(d, names, [target])
        assert fetched == [target]
        want = tr.exe.run(tr._test_program([target]), feed=feed,
                          fetch_list=[target])[0]
    with scope_guard(Scope()):
        exe = Executor("cpu")
        program, feeds, fetches = tio.load_inference_model(d, exe)
        assert feeds == names and fetches == [target]
        assert program._uid != tr.main_program._uid
        outs = [exe.run(program, feed=feed, fetch_list=fetches)[0]
                for _ in range(3)]  # warm-up, capture, replay
        assert exe.stats["jit_runs"] == 3
    for got in outs:
        assert np.array_equal(np.asarray(got), np.asarray(want))
    types = [op.type for op in program.global_block().ops]
    assert not any(t.endswith("_grad") or t in ("adam", "sgd", "momentum")
                   for t in types), types


def test_only_the_read_persistables_are_saved(tmp_path):
    kind = "resnet_cifar"
    jmain, jstart, _ = book.build("jax", kind)
    state = book.jax_startup_state(jmain, jstart)
    d = str(tmp_path / "model")
    with scope_guard(Scope()):
        tr, spec = _port_trained(kind, state)
        tr.save_inference_model(d, ["img"], [spec["prediction_name"]])
        pruned = tio.get_inference_program([spec["prediction_name"]],
                                           tr.main_program)
    read = {n for op in pruned.global_block().ops
            for n in op.input_arg_names}
    want = sorted(v.name for v in tr.main_program.list_vars()
                  if v.persistable and v.name in read)
    files = sorted(f for f in os.listdir(d) if f != "__model__")
    assert files == want
    assert not any("velocity" in f or "moment" in f or "@GRAD" in f
                   or "learning_rate" in f for f in files), files
    # the batch norms' running statistics are read in test mode
    assert any(f.endswith(".w_1") for f in files)
    assert len(files) < len([v for v in tr.main_program.list_vars()
                             if v.persistable])


def _jax_model(kind, d):
    """Train ``kind`` STEPS batches in the JAX package, save its inference
    model to ``d``, and return (feed, the JAX loaded model's output)."""
    names = _feed_names(kind)
    with jpt.scope_guard(jpt.Scope()):
        tr, spec = book.make_trainer("jax", kind)
        tr.train(book.reader_of(book.batches(kind, STEPS)))
        tr.save_inference_model(d, names, [spec["prediction_name"]])
    feed = _only(book.feeds(kind, "jax", 1)[0], names)
    with jpt.scope_guard(jpt.Scope()):
        exe = jpt.Executor(jpt.CPUPlace())
        program, feeds, fetches = jpt.io.load_inference_model(d, exe)
        want = np.asarray(exe.run(program, feed=feed,
                                  fetch_list=fetches)[0])
    return _only(book.feeds(kind, "port", 1)[0], names), want


@pytest.mark.parametrize("kind", ["recognize_digits_conv", "resnet_cifar",
                                  "tiny_lm"])
def test_jax_model_loads_in_the_port(tmp_path, kind):
    d = str(tmp_path / "jax_model")
    feed, want = _jax_model(kind, d)
    with scope_guard(Scope()):
        exe = Executor("cpu")
        program, feeds, fetches = tio.load_inference_model(d, exe)
        assert isinstance(program, ir.Program)
        assert program._shape_infer_failures == []
        assert not hasattr(program, "_shardings")
        for v in program.list_vars():
            assert type(v).__module__ == "paddle_tpu_torch.core.ir"
        got = exe.run(program, feed=feed, fetch_list=fetches)[0]
    assert feeds == _feed_names(kind)
    assert got.shape == want.shape
    assert book.rel(got, want) <= book.REL_TOL


_SUBPROCESS = """
import json, sys
import numpy as np
from paddle_tpu_torch import io
from paddle_tpu_torch.core.executor import Executor
d, feed_path = sys.argv[1], sys.argv[2]
feed = dict(np.load(feed_path))
exe = Executor("cpu")
program, feeds, fetches = io.load_inference_model(d, exe)
out = exe.run(program, feed=feed, fetch_list=fetches)[0]
np.save(feed_path + ".out.npy", out)
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("paddle_tpu", "jax",
                                               "jaxlib"))))
"""


def test_loading_a_jax_model_imports_no_jax(tmp_path):
    d = str(tmp_path / "jax_model")
    feed, want = _jax_model("recognize_digits_conv", d)
    feed_path = str(tmp_path / "feed.npz")
    np.savez(feed_path, **feed)
    env = dict(os.environ, PYTHONPATH=book.ROOT)
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS, d, feed_path],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    got = np.load(feed_path + ".out.npy")
    assert book.rel(got, want) <= book.REL_TOL


class _Evil(object):
    def __reduce__(self):
        return (os.system, ("echo owned > owned.txt",))


@pytest.mark.parametrize("payload", ["os.system", "builtins.eval",
                                     "paddle_tpu.layers"])
def test_a_pickle_naming_another_global_is_refused(tmp_path, monkeypatch,
                                                   payload):
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path / "model")
    os.makedirs(d)
    if payload == "os.system":
        obj = {"program": _Evil(), "feed_names": [], "fetch_names": []}
    elif payload == "builtins.eval":
        obj = {"program": eval, "feed_names": [], "fetch_names": []}
    else:
        obj = {"program": jpt.layers.fc, "feed_names": [], "fetch_names": []}
    with open(os.path.join(d, "__model__"), "wb") as f:
        pickle.dump(obj, f)
    with pytest.raises(pickle.UnpicklingError, match="__model__ names"):
        tio.load_inference_model(d, Executor("cpu"))
    assert not os.path.exists(str(tmp_path / "owned.txt"))


def test_trainer_export_matches_io(tmp_path):
    """``Trainer.save_inference_model`` is ``io.save_inference_model`` on
    the trainer's program and Executor: the same files."""
    kind = "fit_a_line"
    jmain, jstart, _ = book.build("jax", kind)
    state = book.jax_startup_state(jmain, jstart)
    with scope_guard(Scope()):
        tr, spec = _port_trained(kind, state)
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        tr.save_inference_model(a, ["x"], [spec["prediction_name"]])
        tio.save_inference_model(b, "x", [spec["prediction_name"]], tr.exe,
                                 main_program=tr.main_program)
        assert isinstance(tr, Trainer) and global_scope().find_var(
            "fc_0.w_0") is not None
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == \
        ["__model__", "fc_0.b_0", "fc_0.w_0"]
    for fn in ("fc_0.b_0", "fc_0.w_0"):
        with open(os.path.join(a, fn), "rb") as fa, \
                open(os.path.join(b, fn), "rb") as fb:
            assert fa.read() == fb.read()
