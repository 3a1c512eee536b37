"""Compiled inference artifacts of the port against the JAX package:
twins of the first three tests of ``tests/test_inference_export.py``
(round trip, ``run_many`` with no recapture and staged pass-through,
readable validation errors), and the same program exported by both
packages from one state (the JAX startup's, carried into the port's
scope).

Tolerances: ``CompiledModel.run`` of the two artifacts within 1e-6
(``OUT_TOL``) on a tiny fc and on a CIFAR ResNet whose convs carry
``conv_impl=pallas3x3`` (on the CPU the port's conv3x3 wrapper runs its
plain version, the JAX package its Pallas kernel in interpret mode);
the ``amp=True`` artifacts within one bfloat16 ulp of the largest
output (the rule of ``tests/test_torch_amp.py``), the JAX side in a
process of its own with XLA's excess precision off, as there. A row of
``run_many`` is bit-identical to ``run`` of that request alone.

Queue 3 #39's pin: a JAX artifact (a StableHLO program, no
``__model__``) is refused with ``ArtifactError``, and ``feed_spec``
reports a feed's own int64 where the JAX package's canonical avals say
int32.
"""
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.models as jmodels
from paddle_tpu import inference as jinf
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch.core.scope import scope_from_numpy
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.kernels import conv3x3 as tconv3x3
import paddle_tpu_torch.models as tmodels
import torch_optim as T

OUT_TOL = 1e-6


def bf16_ulp(m):
    """One bfloat16 ulp at magnitude ``m`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(m)) - 7) if m > 0 else 0.0


def _fc_net(pkg):
    x = pkg.layers.data("x", shape=[6], dtype="float32")
    h = pkg.layers.fc(x, size=8, act="relu")
    pred = pkg.layers.fc(h, size=3, act="softmax")
    return pred.name


def _tiny_net(pkg):
    x = pkg.layers.data("x", shape=[6], dtype="float32")
    return pkg.layers.fc(x, size=3, act="softmax").name


def _sample():
    return np.random.RandomState(0).rand(4, 6).astype(np.float32)


def _export_port(dirname, build=_fc_net, feed=None, state=None, amp=False,
                 feeds=("x",)):
    """Build ``build`` in the port, load ``state`` (default: the JAX
    startup's of the same program) and export it; (dirname, state)."""
    jm, js, _ = T.build(T.JAX, build)
    tm, _ts, name = T.build(T.PORT, build)
    state = T.jax_startup_state(jm, js) if state is None else state
    scope = scope_from_numpy(state, device="cpu")
    tinf.export_compiled(dirname, list(feeds), [name], None,
                         main_program=tm,
                         example_feed=feed or {"x": _sample()},
                         scope=scope, amp=amp)
    return dirname, state


def _export_jax(dirname, build, state, feed, amp=False, feeds=("x",)):
    jm, _js, name = T.build(T.JAX, build)
    scope = jpt.Scope()
    with jpt.scope_guard(scope):
        for n, v in state.items():
            scope.set_var(n, v)
        jinf.export_compiled(dirname, list(feeds), [name],
                             jpt.Executor(jpt.CPUPlace()), main_program=jm,
                             example_feed=feed, scope=scope, amp=amp)
    return dirname


def test_export_compiled_round_trip(tmp_path):
    sample = _sample()
    d, state = _export_port(str(tmp_path / "port"))
    jd = _export_jax(str(tmp_path / "jax"), _fc_net, state, {"x": sample})
    model = tinf.load_compiled(d, device="cpu")
    assert model.feed_names == ["x"]
    got = model.run({"x": sample})[0]
    want = np.asarray(jinf.load_compiled(jd).run({"x": sample})[0])
    assert T.rel(got.numpy(), want) < OUT_TOL

    # R stacked requests: each row is the request run alone
    stacked = np.stack([sample, sample * 0.5, sample * 2.0])
    outs = model.run_many({"x": stacked})[0]
    assert tuple(outs.shape) == (3,) + tuple(got.shape)
    for i in range(3):
        single = model.run({"x": stacked[i]})[0]
        assert torch.equal(outs[i], single)
    jouts = np.asarray(jinf.load_compiled(jd).run_many({"x": stacked})[0])
    assert T.rel(outs.numpy(), jouts) < OUT_TOL


def test_run_many_no_recapture_and_staged_passthrough(tmp_path):
    """A stack of any depth is replays of the one-request step, so no
    depth adds a compiled step or a capture (the JAX package traces its
    scan once a depth); a staged feed passes through untouched."""
    d, _ = _export_port(str(tmp_path / "compiled"), build=_tiny_net)
    sample = _sample()
    model = tinf.load_compiled(d, device="cpu")
    model.run_many({"x": np.stack([sample, sample * 0.5, sample * 2.0])})
    steps = model.stats["compiled_steps"]
    assert steps == 1
    model.run_many({"x": np.stack([sample * 3.0, sample, sample])})
    model.run_many({"x": np.stack([sample, sample * 4.0])})
    st = model.stats
    assert st["compiled_steps"] == steps
    assert st["eager_runs"] == 0

    staged = model.stage({"x": sample})
    assert model._feed_val(staged["x"]) is staged["x"]
    assert isinstance(model._feed_val(np.asarray(sample)), torch.Tensor)
    assert torch.equal(model.run(staged)[0], model.run({"x": sample})[0])
    assert model.feed_spec == {"x": ((4, 6), "float32")}


def test_artifact_validation_readable_errors(tmp_path):
    missing = str(tmp_path / "never-exported")
    assert any("does not exist" in p for p in tinf.validate_artifact(missing))
    with pytest.raises(tinf.ArtifactError, match="does not exist"):
        tinf.load_compiled(missing, device="cpu")

    d, _ = _export_port(str(tmp_path / "first"), build=_tiny_net)
    os.remove(os.path.join(d, tinf.PARAMS_FILE))
    os.truncate(os.path.join(d, tinf.META_FILE), 0)
    problems = "\n".join(tinf.validate_artifact(d))
    assert tinf.PARAMS_FILE in problems and tinf.META_FILE in problems
    with pytest.raises(tinf.ArtifactError) as ei:
        tinf.load_compiled(d, device="cpu")
    assert tinf.PARAMS_FILE in str(ei.value)
    assert tinf.META_FILE in str(ei.value)

    # corrupt contents (right files, wrong bytes) name the bad file too
    d2, _ = _export_port(str(tmp_path / "second"), build=_tiny_net)
    with open(os.path.join(d2, tinf.MODEL_FILE), "wb") as f:
        f.write(b"not a pickled program")
    with pytest.raises(tinf.ArtifactError, match=tinf.MODEL_FILE):
        tinf.load_compiled(d2, device="cpu")


def test_a_jax_artifact_is_refused(tmp_path):
    """Queue 3 #39: the JAX package's artifact is a StableHLO program,
    which the port cannot run; it is refused by name."""
    jm, js, _ = T.build(T.JAX, _tiny_net)
    jd = _export_jax(str(tmp_path / "jax"), _tiny_net,
                     T.jax_startup_state(jm, js), {"x": _sample()})
    problems = tinf.validate_artifact(jd)
    assert len(problems) == 1 and "JAX package artifact" in problems[0]
    with pytest.raises(tinf.ArtifactError, match=tinf.EXPORTED_FILE):
        tinf.load_compiled(jd, device="cpu")


def test_feed_spec_reports_int64_ids_where_jax_says_int32(tmp_path):
    """Queue 3 #39: a CTR slot's ids are int64 in the port's artifact,
    int32 in the JAX package's canonical avals; the probabilities
    agree."""
    feed = jmodels.synthetic_click_batch(np.random.RandomState(2), 1, 3, 2,
                                         20)
    feed.pop("click")
    names = sorted(feed)

    def build(pkg):
        _c, _a, prob, _f = (jmodels if pkg is T.JAX else tmodels).wide_deep(
            num_sparse_slots=3, dense_dim=2, vocab_size=20, embed_dim=4,
            hidden_sizes=(8,), with_auc=False)
        return prob.name

    d, state = _export_port(str(tmp_path / "port"), build=build, feed=feed,
                            feeds=names)
    jd = _export_jax(str(tmp_path / "jax"), build, state, feed, feeds=names)
    tm, jmod = tinf.load_compiled(d, device="cpu"), jinf.load_compiled(jd)
    for n in names:
        if n.startswith("C"):
            assert tm.feed_spec[n] == ((1, 1), "int64"), n
            assert jmod.feed_spec[n] == ((1, 1), "int32"), n
    got = tm.run(feed)[0].numpy()
    assert got.shape == (1, 1) and 0.0 <= float(got[0, 0]) <= 1.0
    assert T.rel(got, np.asarray(jmod.run(feed)[0])) < OUT_TOL


def _cifar_resnet(pkg):
    img = pkg.layers.data("img", shape=[3, 8, 8], dtype="float32")
    pred = (jmodels if pkg is T.JAX else tmodels).resnet(
        img, class_dim=10, depth=8, variant="cifar")
    main = img.block.program
    for op in main.global_block().ops:
        if op.type == "conv2d":
            op.attrs["conv_impl"] = "pallas3x3"
    return pred.name


def test_cifar_resnet_with_pallas3x3_matches_jax(tmp_path, monkeypatch):
    """The convs' ``conv_impl`` attr rides in the artifact: loaded where
    ``FLAGS.conv_impl`` is the default conv, the port's model still
    calls the conv3x3 wrapper, and agrees with the JAX artifact exported
    under ``pallas3x3``."""
    img = np.random.RandomState(1).rand(2, 3, 8, 8).astype(np.float32)
    jm, js, jname = T.build(T.JAX, _cifar_resnet)
    tm, _ts, tname = T.build(T.PORT, _cifar_resnet)
    state = T.jax_startup_state(jm, js)
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    tinf.export_compiled(str(tmp_path / "port"), ["img"], [tname], None,
                         main_program=ttest, example_feed={"img": img},
                         scope=scope_from_numpy(state, device="cpu"))
    old = JFLAGS.conv_impl
    JFLAGS.conv_impl = "pallas3x3"
    try:
        scope = jpt.Scope()
        with jpt.scope_guard(scope):
            for n, v in state.items():
                scope.set_var(n, v)
            jinf.export_compiled(str(tmp_path / "jax"), ["img"], [jname],
                                 None, main_program=jtest,
                                 example_feed={"img": img}, scope=scope)
        want = np.asarray(jinf.load_compiled(
            str(tmp_path / "jax")).run({"img": img})[0])
    finally:
        JFLAGS.conv_impl = old
    assert TFLAGS.conv_impl == "conv"
    calls = []
    real = tconv3x3.conv3x3_s1_nhwc
    monkeypatch.setattr(tconv3x3, "conv3x3_s1_nhwc",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = tinf.load_compiled(str(tmp_path / "port"), device="cpu")
    got = model.run({"img": img})[0].numpy()
    assert calls, "the artifact's convs did not reach the conv3x3 wrapper"
    assert got.shape == (2, 10)
    assert T.rel(got, want) < OUT_TOL


def _jax_amp_outputs(state, sample):
    """The JAX package's ``amp=True`` artifact of ``_fc_net`` run on
    ``sample`` (in the process :func:`_isolated` starts)."""
    with tempfile.TemporaryDirectory() as tmp:
        d = _export_jax(os.path.join(tmp, "amp"), _fc_net, state,
                        {"x": sample}, amp=True)
        return np.asarray(jinf.load_compiled(d).run({"x": sample})[0])


def _isolated(state, sample):
    """:func:`_jax_amp_outputs` in a process of its own with XLA's
    excess precision off, which XLA:CPU needs to round the bfloat16
    operands as the program writes them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([root, os.path.join(root,
                                                              "tests")]),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as fh:
            pickle.dump((state, sample), fh)
        subprocess.run([sys.executable, os.path.abspath(__file__), src,
                        out], check=True, env=env, timeout=600)
        with open(out, "rb") as fh:
            return pickle.load(fh)


def test_amp_export_matches_jax_at_one_bfloat16_ulp(tmp_path):
    """``amp=True`` pins the cast in the artifact: loaded on the CPU,
    where AMP is otherwise off, the port's products take bfloat16
    operands (the float32 artifact differs), within one bfloat16 ulp
    of the JAX package's ``amp=True`` artifact."""
    sample = _sample() * 3.0
    d, state = _export_port(str(tmp_path / "amp"), amp=True,
                            feed={"x": sample})
    f32, _ = _export_port(str(tmp_path / "f32"), state=state,
                          feed={"x": sample})
    got = tinf.load_compiled(d, device="cpu").run({"x": sample})[0].numpy()
    plain = tinf.load_compiled(f32, device="cpu").run(
        {"x": sample})[0].numpy()
    want = _isolated(state, sample)
    assert got.dtype == want.dtype == np.float32
    tol = bf16_ulp(float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    assert float(np.abs(got - plain).max()) > 1e-6


def test_compiled_model_on_cuda_without_a_card_raises(tmp_path):
    d, _ = _export_port(str(tmp_path / "compiled"), build=_tiny_net)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from paddle_tpu_torch.device import NoDeviceError
    with pytest.raises(NoDeviceError):
        tinf.CompiledModel(d)
    with pytest.raises(NoDeviceError):
        tinf.load_compiled(d, device="cuda")


if __name__ == "__main__":
    with open(sys.argv[1], "rb") as fh:
        _state, _x = pickle.load(fh)
    with open(sys.argv[2], "wb") as fh:
        pickle.dump(_jax_amp_outputs(_state, _x), fh)
