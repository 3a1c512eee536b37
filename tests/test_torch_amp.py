"""AMP (bfloat16) in the port against the JAX package's, on the CPU.

Both packages pin AMP on with ``amp.force(True)`` (off their accelerator
it is a no-op otherwise), build the same programs with the same names,
mark them with ``amp.enable(program, pure=...)`` and are fed the same
numpy arrays made from a seed. The JAX side runs its Pallas kernels
(conv3x3, the tuned matmul) in interpret mode; the port's wrappers take
their plain versions on the CPU.

Tolerances, by the dtype of the output (which must be the JAX output's):
- bfloat16: one bfloat16 ulp of the largest magnitude of the JAX output
  (2^(floor(log2 max) - 7)). Both packages sum bfloat16 products in
  float32, exactly but in other orders, and round once: an output that
  lies within float32 noise of a rounding boundary may land one ulp
  apart. A sum rounded to bfloat16 after each tap or k tile misses this.
- float32: 1e-5 of max(1, largest magnitude), the sum-order tolerance
  of the float32 parity tests; but one bfloat16 ulp for a float32 output
  that is a bfloat16 value cast back (a conv's output and gradients
  under plain AMP). XLA:CPU, allowed excess precision by default, drops
  the float32 -> bfloat16 -> float32 round trip of a ``lax.conv``
  written in bfloat16, so the JAX reference on the CPU holds the
  unrounded float32 sum there, up to half an ulp from the rounded value
  that the TPU, and the port, write. The port's outputs are checked to
  be bfloat16 values.

Training: a CIFAR ResNet (depth 8, 16 x 16, batch 4, Momentum 0.01)
and a 128-wide ``transformer_lm`` (Adam), each under plain and pure AMP,
3 steps in both packages from the JAX startup state. The JAX
side runs in a process of its own with XLA's excess precision off, so
that it rounds every bfloat16 result as the program writes it (see
above). Each step's loss, taken from the JAX state before the step,
must differ from the JAX loss by less than the port's own
AMP-vs-float32 difference, and so must the parameters after each step,
of those steps and of the port's own three: the port reproduces AMP's
roundings, not float32. The losses of the port's own three steps are
not held so: a bfloat16 rounding that flips under float32 noise moves
them by as much as AMP does (perturbing the JAX parameters by 1e-6
relative moves its ResNet AMP losses by 1.4e-3 to 3.2e-3, and the
float32 ones by 5e-7).

Pure AMP on the LM is also walked op by op: every op of one step runs
alone in the port on the inputs the JAX step gave it, its outputs held
to the JAX outputs (:func:`test_pure_amp_lm_matches_jax_op_by_op`).
"""
import math

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import tune as jtune  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu.flags import FLAGS as JFLAGS  # noqa: E402
from paddle_tpu.tune.results import device_kind as jkind  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import tune as ttune  # noqa: E402
from paddle_tpu_torch.configs import resnet_cifar as tcfg  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope as TScope,  # noqa: E402
                                         scope_from_numpy)
from paddle_tpu_torch.flags import FLAGS as TFLAGS  # noqa: E402
from paddle_tpu_torch.models import transformer as ttransformer  # noqa: E402

BF16 = np.dtype(ml_dtypes.bfloat16)
F32_TOL = 1e-5
MODES = {"plain": False, "pure": True}


def bf16_ulp(m):
    """One bfloat16 ulp at magnitude ``m`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def _set(flags, **kw):
    old = {k: getattr(flags, k) for k in kw}
    for k, v in kw.items():
        setattr(flags, k, v)
    return old


@pytest.fixture(autouse=True)
def _amp_forced_and_tune_isolated(tmp_path):
    """AMP pinned on in both packages, each tune cache in a throwaway
    directory with cold memory layers and counters."""
    jprev, tprev = jamp.force(True), tamp.force(True)
    jold = _set(JFLAGS, tune_cache_dir=str(tmp_path / "tune"), tune=True)
    told = _set(TFLAGS, tune_cache_dir=str(tmp_path / "tune"), tune=True)
    for t in (jtune, ttune):
        t.clear_memory_cache()
        t.reset_counters()
    yield
    for t in (jtune, ttune):
        t.clear_memory_cache()
        t.reset_counters()
    _set(JFLAGS, **jold)
    _set(TFLAGS, **told)
    jamp.force(jprev)
    tamp.force(tprev)


def _run_single(pkg, ops, feeds, fetches, pure=None):
    """One program of ``ops`` ([(type, inputs, outputs, attrs)]) in
    ``pkg`` ("jax" or "port"), under AMP (``pure`` False or True) or
    not (None), run once on the CPU; the fetches as numpy arrays."""
    prog = jpt.Program() if pkg == "jax" else tir.Program()
    block = prog.global_block()
    for _, inputs, outputs, _ in ops:
        for names in list(inputs.values()) + list(outputs.values()):
            for n in names:
                if n and not block.has_var(n):
                    a = feeds.get(n)
                    block.create_var(
                        name=n, shape=None if a is None else a.shape,
                        dtype="float32" if a is None else str(a.dtype))
    for t, inputs, outputs, attrs in ops:
        block.append_op(type=t, inputs=inputs, outputs=outputs,
                        attrs=dict(attrs))
    if pure is not None:
        (jamp if pkg == "jax" else tamp).enable(prog, pure=pure)
    if pkg == "jax":
        with jpt.scope_guard(jpt.Scope()):
            outs = jpt.Executor(jpt.CPUPlace()).run(prog, feed=feeds,
                                                    fetch_list=fetches)
        return [np.asarray(o) for o in outs]
    return TExecutor("cpu").run(prog, feed=feeds, fetch_list=fetches,
                                scope=TScope())


def _close(name, got, want, bf16_valued=False):
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    g, w = got.astype(np.float64), want.astype(np.float64)
    err = float(np.abs(g - w).max()) if w.size else 0.0
    m = float(np.abs(w).max()) if w.size else 0.0
    tol = bf16_ulp(m) if want.dtype == BF16 or bf16_valued \
        else F32_TOL * max(1.0, m)
    assert err <= tol, (name, err, tol)


def _jax_isolated(task, *args):
    """``task(*args)`` (a function of this module) run by the JAX package
    in a process of its own with XLA's excess precision off, so that
    XLA:CPU rounds every bfloat16 result as the program writes it; its
    return value, through a pickle."""
    import os
    import pickle
    import subprocess
    import sys
    import tempfile
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root,
               PADDLE_TPU_CONV_IMPL="pallas3x3",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as fh:
            pickle.dump((task, args), fh)
        subprocess.run([sys.executable, os.path.abspath(__file__), "task",
                        src, out], check=True, env=env, timeout=600)
        with open(out, "rb") as fh:
            return pickle.load(fh)


def _assert_ops_match(ops, feeds, fetches, pure, bf16_valued=False,
                      isolated=False):
    """The ops run once in each package on the same feeds; every fetch
    within :func:`_close`. ``isolated``: the JAX side in a process of its
    own with excess precision off (:func:`_jax_isolated`), for ops whose
    bfloat16 roundings XLA:CPU would otherwise drop."""
    want = (_jax_isolated("_run_single", "jax", ops, feeds, fetches, pure)
            if isolated else _run_single("jax", ops, feeds, fetches, pure))
    got = _run_single("port", ops, feeds, fetches, pure)
    for name, g, w in zip(fetches, got, want):
        _close(name, g, w, bf16_valued)
    return got, want


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


# -- per op -------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_mul_and_its_grad_match_jax(mode):
    rng = np.random.RandomState(1)
    x, y = _randn(rng, 3, 4, 96), _randn(rng, 96, 40) * 0.2
    dy = _randn(rng, 3, 4, 40)
    attrs = {"x_num_col_dims": 2, "y_num_col_dims": 1}
    ops = [("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, attrs),
           ("mul_grad", {"X": ["x"], "Y": ["y"], "Out@GRAD": ["dy"]},
            {"X@GRAD": ["dx"], "Y@GRAD": ["dw"]}, attrs)]
    got, _ = _assert_ops_match(ops, {"x": x, "y": y, "dy": dy},
                               ["out", "dx", "dw"], MODES[mode])
    # out is bfloat16 under pure AMP only; the grads take the operands'
    # declared dtypes
    assert got[0].dtype == (BF16 if mode == "pure" else np.float32)
    assert got[1].dtype == got[2].dtype == np.float32
    # the untuned gemm sums bfloat16 operands in float32: not the float32
    # product, and not rounded to bfloat16
    exact = x.reshape(12, 96).astype(np.float64) @ y
    assert np.abs(got[0].astype(np.float64).reshape(12, 40)
                  - exact).max() > 1e-3


CONV_CASES = [
    # (x shape, w shape, strides, paddings, conv_impl)
    ((2, 8, 6, 6), (16, 8, 3, 3), [1, 1], [1, 1], "pallas3x3"),
    ((2, 8, 6, 6), (16, 8, 3, 3), [1, 1], [1, 1], "conv"),
    ((2, 8, 7, 7), (6, 8, 3, 3), [2, 2], [1, 1], "pallas3x3"),
    ((2, 8, 6, 6), (12, 8, 1, 1), [1, 1], [0, 0], "pallas3x3"),
    ((2, 3, 16, 16), (8, 3, 7, 7), [2, 2], [3, 3], "pallas3x3"),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv2d_and_its_grad_match_jax(case, mode, monkeypatch):
    xs, ws, s, p, impl = CONV_CASES[case]
    monkeypatch.setenv("PADDLE_TPU_CONV_IMPL", impl)
    rng = np.random.RandomState(10 + case)
    x = _randn(rng, *xs)
    w = _randn(rng, *ws) * (2.0 / (ws[1] * ws[2] * ws[3])) ** 0.5
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
    got, _ = _assert_ops_match(ops, {"x": x, "w": w, "dy": dy},
                               ["y", "dx", "dw"], MODES[mode],
                               bf16_valued=True)
    assert got[0].dtype == (BF16 if mode == "pure" else np.float32)
    assert got[1].dtype == got[2].dtype == np.float32
    # under plain AMP the conv's output is bfloat16 cast back to float32
    # (the kernel's bfloat16 face and F.conv2d on bfloat16 write
    # bfloat16), and so are dx and dw
    for a in got:
        assert np.array_equal(a.astype(BF16).astype(a.dtype), a)
    # the CPU takes the plain versions: no launch is counted
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("mode", MODES)
def test_conv2d_without_amp_sums_bfloat16_operands_into_float32(mode,
                                                                monkeypatch):
    # bfloat16 operands outside AMP: float32 sums (the kernel's float32
    # output), written back in the input's dtype
    monkeypatch.setenv("PADDLE_TPU_CONV_IMPL", "pallas3x3")
    rng = np.random.RandomState(20)
    feeds = {"x": _randn(rng, 2, 8, 6, 6).astype(BF16),
             "w": (_randn(rng, 16, 8, 3, 3) * 0.2).astype(BF16)}
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1}
    ops = [("conv2d", {"Input": ["x"], "Filter": ["w"]},
            {"Output": ["y"]}, attrs)]
    want = _run_single("jax", ops, feeds, ["y"])
    got = _run_single("port", ops, feeds, ["y"])
    _close("y", got[0], want[0])
    assert got[0].dtype == BF16


BN_SHAPES = [(4, 6, 5, 5), (8, 6)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_batch_norm_of_a_bfloat16_input_matches_jax(shape, mode):
    # the pure-AMP activation: statistics and normalisation in float32,
    # Y in bfloat16, the running statistics float32
    rng = np.random.RandomState(30)
    C = shape[1]
    feeds = {"x": (_randn(rng, *shape) * 2 + 0.5).astype(BF16),
             "scale": _randn(rng, C), "bias": _randn(rng, C),
             "mean": _randn(rng, C) * 0.1,
             "var": np.abs(_randn(rng, C)) + 0.5,
             "dy": _randn(rng, *shape).astype(BF16)}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
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
                     "dx", "dscale", "dbias"], MODES[mode])
    assert got[0].dtype == got[5].dtype == BF16
    assert {a.dtype for a in got[1:5]} == {np.dtype(np.float32)}
    # the batch mean is the float32 mean of the bfloat16 values, not a
    # bfloat16 sum
    axes = (0, 2, 3) if len(shape) == 4 else (0,)
    np.testing.assert_allclose(
        got[3], feeds["x"].astype(np.float64).mean(axis=axes), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bf16_slot", ["X", "Y"])
def test_elementwise_add_of_a_bfloat16_operand_matches_jax(bf16_slot, mode):
    # a bias or residual add: float32 + bfloat16 promotes to float32, and
    # pure AMP writes the result back in bfloat16, whichever operand is
    # the bfloat16 one
    rng = np.random.RandomState(40)
    a = _randn(rng, 2, 6, 3, 3)
    b = _randn(rng, 2, 6, 3, 3).astype(BF16)
    feeds = {"x": b, "y": a} if bf16_slot == "X" else {"x": a, "y": b}
    feeds["dout"] = _randn(rng, 2, 6, 3, 3)
    ops = [("elementwise_add", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]},
            {"axis": -1}),
           ("elementwise_add_grad",
            {"X": ["x"], "Y": ["y"], "Out@GRAD": ["dout"]},
            {"X@GRAD": ["dx"], "Y@GRAD": ["dy"]}, {"axis": -1})]
    got, _ = _assert_ops_match(ops, feeds, ["out", "dx", "dy"], MODES[mode])
    assert got[0].dtype == (BF16 if mode == "pure" else np.float32)
    assert got[1].dtype == feeds["x"].dtype
    assert got[2].dtype == feeds["y"].dtype


BF16_UNARY = [
    ("relu", {"X": ["x"]}, {"Out": ["out"]}, {}),
    ("softmax", {"X": ["x"]}, {"Out": ["out"]}, {}),
    ("pool2d", {"X": ["x"]}, {"Out": ["out"]},
     {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
      "paddings": [1, 1], "global_pooling": False}),
    ("pool2d", {"X": ["x"]}, {"Out": ["out"]},
     {"pooling_type": "avg", "ksize": [1, 1], "global_pooling": True}),
    ("cross_entropy", {"X": ["x"], "Label": ["label"]}, {"Y": ["out"]},
     {"soft_label": False}),
    ("softmax_with_cross_entropy", {"Logits": ["x"], "Label": ["label"]},
     {"Softmax": ["sm"], "Loss": ["out"]}, {"soft_label": False}),
]


@pytest.mark.parametrize("case", range(len(BF16_UNARY)),
                         ids=[c[0] + ("_global" if c[3].get("global_pooling")
                                      else "") for c in BF16_UNARY])
def test_ops_of_a_bfloat16_activation_match_jax(case):
    # the ops a pure-AMP activation reaches keep its dtype, as in the JAX
    # package (the losses take their log in float32)
    op = BF16_UNARY[case]
    rng = np.random.RandomState(50 + case)
    if op[0] in ("relu", "pool2d"):
        x = _randn(rng, 2, 3, 6, 6)
    elif op[0] == "cross_entropy":
        e = np.exp(_randn(rng, 6, 5))
        x = e / e.sum(-1, keepdims=True)
    else:
        x = _randn(rng, 6, 5) * 3
    feeds = {"x": x.astype(BF16),
             "label": rng.randint(0, 5, (6, 1)).astype(np.int64)}
    fetches = ["out"] + (["sm"] if "Softmax" in op[2] else [])
    got, _ = _assert_ops_match([op], feeds, fetches, True)
    assert all(a.dtype == BF16 for a in got)


def test_a_pure_amp_fetch_is_a_numpy_bfloat16_array(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CONV_IMPL", "pallas3x3")
    rng = np.random.RandomState(60)
    ops = [("conv2d", {"Input": ["x"], "Filter": ["w"]}, {"Output": ["y"]},
            {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1})]
    feeds = {"x": _randn(rng, 1, 4, 5, 5), "w": _randn(rng, 8, 4, 3, 3)}
    got = _run_single("port", ops, feeds, ["y"], pure=True)[0]
    want = _run_single("jax", ops, feeds, ["y"], pure=True)[0]
    assert type(got) is np.ndarray and got.dtype == want.dtype == BF16
    # and it feeds back in bit for bit
    back = _run_single("port", [("relu", {"X": ["y"]}, {"Out": ["z"]}, {})],
                       {"y": got}, ["z"])[0]
    assert back.dtype == BF16 and np.array_equal(back, np.maximum(got, 0))


def test_amp_is_a_no_op_on_the_cpu_unless_forced():
    rng = np.random.RandomState(70)
    feeds = {"x": _randn(rng, 4, 128), "y": _randn(rng, 128, 128)}
    ops = [("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, {})]
    tamp.force(None)
    plain = _run_single("port", ops, feeds, ["out"])[0]
    unforced = _run_single("port", ops, feeds, ["out"], pure=True)[0]
    assert unforced.dtype == np.float32 and np.array_equal(plain, unforced)
    tamp.force(False)
    assert np.array_equal(
        _run_single("port", ops, feeds, ["out"], pure=True)[0], plain)
    tamp.force(True)
    forced = _run_single("port", ops, feeds, ["out"], pure=True)[0]
    assert forced.dtype == BF16
    # the program-level switches: enable, disable, amp_guard
    prog = tir.Program()
    tamp.enable(prog, pure=True)
    assert prog._amp and prog._amp_pure
    tamp.disable(prog)
    assert not prog._amp
    with tamp.amp_guard(prog):
        assert prog._amp
    assert not prog._amp


# -- the tuned-vs-untuned rounding of a bfloat16 gemm -------------------------

MM = (16, 256, 128)


def _mm_ops():
    return [("mul", {"X": ["x"], "Y": ["y"]}, {"Out": ["out"]}, {})]


def _mm_feeds():
    rng = np.random.RandomState(80)
    return {"x": _randn(rng, MM[0], MM[1]),
            "y": _randn(rng, MM[1], MM[2]) * 0.1}


def _cache_winners(key):
    jtune.WinnerCache().put(
        jtune.cache_key(jkind(), "matmul", jtune.signature(key)),
        {"block_m": 8, "block_n": 128, "block_k": 128})
    ttune.WinnerCache().put(
        ttune.cache_key(ttune.device_kind(), "matmul", ttune.signature(key)),
        {"block_m": 64, "block_n": 128, "block_k": 64})


def test_a_tuned_bfloat16_gemm_is_rounded_to_bfloat16_in_both_packages():
    """Under plain AMP an untuned gemm writes its float32 sum, while a
    tuned one is the kernel's bfloat16 output cast back to float32 (the
    JAX kernel writes ``x.dtype``; ROADMAP.md, faults of the reference).
    The port mirrors both, and both agree with the JAX package."""
    feeds = _mm_feeds()
    key = {"m": MM[0], "k": MM[1], "n": MM[2], "dtype": "bfloat16"}
    untuned = {pkg: _run_single(pkg, _mm_ops(), feeds, ["out"], False)[0]
               for pkg in ("jax", "port")}
    _cache_winners(key)
    tuned = {pkg: _run_single(pkg, _mm_ops(), feeds, ["out"], False)[0]
             for pkg in ("jax", "port")}
    assert jtune.counters()["tune_hits"] >= 1
    assert ttune.counters()["tune_hits"] >= 1
    for pkg in ("jax", "port"):
        u, t = untuned[pkg], tuned[pkg]
        assert u.dtype == t.dtype == np.float32
        # the tuned output is bfloat16-valued, the untuned one is not
        assert np.array_equal(t.astype(BF16).astype(np.float32), t), pkg
        assert not np.array_equal(u.astype(BF16).astype(np.float32), u), pkg
        _close(pkg, t, u.astype(BF16).astype(np.float32))
    _close("untuned", untuned["port"], untuned["jax"])
    # a float32 output that is bfloat16-valued: one bfloat16 ulp apart
    m = float(np.abs(tuned["jax"]).max())
    assert float(np.abs(tuned["port"] - tuned["jax"]).max()) <= bf16_ulp(m)


# -- three training steps in both packages ------------------------------------

RESNET = dict(variant="cifar", depth=8, image=16, class_dim=10, batch=4,
              samples=4, learning_rate=0.01)
LM = dict(vocab=32, seq=16, hidden=128, num_layers=2, num_heads=4)
LM_BATCH = 2
STEPS = 3


def _resnet_program(pkg, amp):
    """(main, startup, cost, feeds) of the CIFAR ResNet config in
    ``pkg``, under ``amp`` (False, True or "pure")."""
    if pkg == "jax":
        main, startup = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, startup):
            img = jlayers.data(name="img", shape=[3, 16, 16],
                               dtype="float32")
            label = jlayers.data(name="label", shape=[1], dtype="int64")
            pred = jmodels.resnet(img, class_dim=10, depth=RESNET["depth"],
                                  variant="cifar")
            cost = jlayers.mean(x=jlayers.cross_entropy(input=pred,
                                                        label=label))
            jlayers.accuracy(input=pred, label=label)
            jpt.optimizer.Momentum(learning_rate=RESNET["learning_rate"],
                                   momentum=0.9).minimize(cost)
        if amp:
            jamp.enable(main, pure=(amp == "pure"))
    else:
        main, startup = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, startup):
            spec = tcfg.model(amp=amp, **RESNET)
            spec["optimizer"].minimize(spec["cost"])
        cost = spec["cost"]
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(4, 3, 16, 16).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    return main, startup, cost, [feed] * STEPS


def _lm_program(pkg, amp):
    """(main, startup, cost, feeds) of a 128-wide transformer_lm with
    Adam in ``pkg``, under ``amp``."""
    jax = pkg == "jax"
    L = jlayers if jax else tlayers
    main, startup = (jpt.Program(), jpt.Program()) if jax else \
        (tir.Program(), tir.Program())
    with (jun if jax else tun).guard(), \
            (jpt if jax else tir).program_guard(main, startup):
        toks = L.data("toks", shape=[LM["seq"]], dtype="int64")
        toks.shape = (-1, LM["seq"])
        tgt = L.data("tgt", shape=[LM["seq"]], dtype="int64")
        tgt.shape = (-1, LM["seq"])
        logits = (jmodels if jax else ttransformer).transformer_lm(
            toks, vocab_size=LM["vocab"], hidden=LM["hidden"],
            num_layers=LM["num_layers"], num_heads=LM["num_heads"])
        flat = L.reshape(logits, shape=[-1, LM["vocab"]])
        cost = L.mean(L.softmax_with_cross_entropy(
            flat, L.reshape(tgt, shape=[-1, 1])))
        (jpt.optimizer if jax else topt).Adam(
            learning_rate=0.01).minimize(cost)
    if amp:
        (jamp if jax else tamp).enable(main, pure=(amp == "pure"))
    rng = np.random.RandomState(0)
    feeds = []
    for _ in range(STEPS):
        xs = rng.randint(0, LM["vocab"], (LM_BATCH, LM["seq"])).astype(
            np.int64)
        feeds.append({"toks": xs, "tgt": (xs + 1) % LM["vocab"]})
    return main, startup, cost, feeds


PROGRAMS = {"resnet": _resnet_program, "lm": _lm_program}


def _params(main):
    return sorted(p.name for p in main.all_parameters() if p.trainable)


def _flat(get, names):
    return np.concatenate([np.asarray(get(n), np.float64).ravel()
                           for n in names])


def _jax_train(kind, amp, out):
    """The JAX side: startup, then STEPS steps under AMP; pickles the
    state before each step, the losses and the parameters after each
    step to ``out``. Run in a process of its own (``__main__`` below)
    with XLA's excess precision off, so that XLA:CPU rounds every
    bfloat16 result as the program writes it."""
    import pickle
    jamp.force(True)
    main, startup, cost, feeds = PROGRAMS[kind]("jax", amp)
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    states, losses, params = [], [], []
    with jpt.scope_guard(scope):
        exe.run(startup)
        for f in feeds:
            states.append({n: np.asarray(scope.find_var(n)) for n in persist
                           if scope.find_var(n) is not None})
            losses.append(float(np.asarray(exe.run(
                main, feed=f, fetch_list=[cost])[0],
                dtype=np.float64).reshape(-1)[0]))
            params.append(_flat(scope.find_var, _params(main)))
    with open(out, "wb") as fh:
        pickle.dump({"states": states, "losses": losses, "params": params},
                    fh)


def _train_both(kind, amp, tmp_path):
    """STEPS steps of ``kind`` under ``amp`` in both packages from the
    JAX startup state, and each step again from the JAX state before it:
    {"jax": (losses, parameters after each step), "port" and "f32" (the
    port without AMP): the same of the port's own run, "port_step" and
    "f32_step": the same of its steps from the JAX states}."""
    import os
    import pickle
    import subprocess
    import sys
    out = str(tmp_path / "jax.pkl")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root,
               PADDLE_TPU_CONV_IMPL="pallas3x3",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, os.path.abspath(__file__), kind,
                    str(amp), out], check=True, env=env, timeout=600)
    with open(out, "rb") as fh:
        ref = pickle.load(fh)
    runs = {"jax": (np.array(ref["losses"]), ref["params"])}
    for label, amp_on in (("port", amp), ("f32", False)):
        main, _, cost, feeds = PROGRAMS[kind]("port", amp_on)
        exe = TExecutor("cpu")
        for stepwise in (False, True):
            losses, params = [], []
            for i, f in enumerate(feeds):
                if stepwise or i == 0:
                    scope = scope_from_numpy(ref["states"][i], device="cpu",
                                             scope=TScope())
                losses.append(float(np.asarray(exe.run(
                    main, feed=f, fetch_list=[cost], scope=scope)[0],
                    dtype=np.float64).reshape(-1)[0]))
                params.append(_flat(lambda n: scope.find_var(n).cpu(),
                                    _params(main)))
            runs[label + ("_step" if stepwise else "")] = (
                np.array(losses), params)
    return runs


def _assert_amp_reproduced(run, bf16_loss=False):
    """At every step the port under AMP is nearer the JAX package under
    AMP than its own float32 computation: the step's loss and the
    parameters after it, from the JAX state before the step; and the
    parameters of the port's own three steps. A loss that is a bfloat16
    value (pure AMP: the mean of the bfloat16 cross entropy) moves by
    whole ulps, 2^-7 near 1.6, more than AMP moves it: it is held to one
    ulp of the JAX loss instead."""
    jl, jp = run["jax"]
    for kind in ("_step", ""):
        tl, tp = run["port" + kind]
        fl, fp = run["f32" + kind]
        assert np.all(np.isfinite(tl)), tl
        for step in range(STEPS):
            gap_jax = float(np.linalg.norm(tp[step] - jp[step]))
            gap_f32 = float(np.linalg.norm(tp[step] - fp[step]))
            assert gap_jax < gap_f32, (kind, step, gap_jax, gap_f32)
    tl, fl = run["port_step"][0], run["f32_step"][0]
    gap_jax, gap_f32 = np.abs(tl - jl), np.abs(tl - fl)
    if bf16_loss:
        assert all(g <= bf16_ulp(abs(j)) for g, j in zip(gap_jax, jl)), \
            (jl.tolist(), tl.tolist())
    else:
        assert np.all(gap_jax < gap_f32), (jl.tolist(), tl.tolist(),
                                           fl.tolist())


@pytest.mark.parametrize("amp", [True, "pure"], ids=["plain", "pure"])
def test_resnet_trains_three_amp_steps_like_jax(amp, tmp_path):
    _assert_amp_reproduced(_train_both("resnet", amp, tmp_path),
                           bf16_loss=amp == "pure")


def test_lm_trains_three_plain_amp_steps_like_jax(tmp_path):
    _assert_amp_reproduced(_train_both("lm", True, tmp_path))


def test_tune_populations_of_an_amp_program_are_keyed_bfloat16():
    # the ops cast before the tune dispatch looks the key up, so the
    # tune verb keys an AMP program's gemms at bfloat16 in both packages
    from paddle_tpu import cli as jcli
    from paddle_tpu_torch import cli as tcli
    jmain = _lm_program("jax", True)[0]
    tmain = _lm_program("port", True)[0]
    jax_pops = [(k, jtune.signature(key))
                for k, key in jcli._tune_populations(jmain, LM_BATCH)
                if k == "matmul"]
    got, _ = tcli._tune_populations(tmain, LM_BATCH)
    got = [(k, ttune.signature(key)) for k, key in got]
    # the JAX package keys the attention output projection with m 0
    # (ROADMAP.md, faults of the reference); the port takes the batch
    assert got == [p for p in jax_pops if ",m=0," not in p[1]]
    assert len(got) == 3 and all("bfloat16" in sig for _, sig in got)
    plain, _ = tcli._tune_populations(_lm_program("port", False)[0],
                                      LM_BATCH)
    assert all(key["dtype"] == "float32" for _, key in plain)


# -- pure AMP on the LM, op by op ----------------------------------------------

def _generic_grad(fwd_type, ins, outs, attrs, diff):
    """A ``generic_grad`` op of ``fwd_type`` as the backward pass writes
    it: ``ins`` and ``outs`` {slot: [names]} of the forward op, the
    output gradients named ``<name>@GRAD``, gradients of the ``diff``
    slots ``d<name>``."""
    inputs = dict(ins, **outs)
    inputs.update({s + "@GRAD": [n + "@GRAD" if n else "" for n in ns]
                   for s, ns in outs.items()})
    outputs = {s + "@GRAD": ["d" + n for n in ins[s]] for s in diff}
    return ("generic_grad", inputs, outputs, dict(
        attrs, __fwd_type__=fwd_type, __fwd_input_slots__=list(ins),
        __fwd_output_slots__=list(outs),
        __diff_slots__={s: [True] * len(ins[s]) for s in diff}))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_and_its_grad_match_jax_under_pure_amp(causal):
    """Pure AMP hands the flash op the bfloat16 outputs of the q, k and v
    projections and its generic grad a bfloat16 output gradient: both
    packages compute in float32 and write out, dq, dk and dv in
    bfloat16. S 40 is not a multiple of the JAX kernel's 128-row
    blocks."""
    rng = np.random.RandomState(90 + causal)
    feeds = {n: _randn(rng, 2, 40, 2, 32).astype(BF16)
             for n in ("q", "k", "v", "out@GRAD")}
    ins = {"Q": ["q"], "K": ["k"], "V": ["v"]}
    ops = [("flash_attention", ins, {"Out": ["out"]}, {"causal": causal}),
           _generic_grad("flash_attention", ins, {"Out": ["out"]},
                         {"causal": causal}, ins)]
    got, _ = _assert_ops_match(ops, feeds, ["out", "dq", "dk", "dv"], True,
                               isolated=True)
    assert all(a.dtype == BF16 for a in got)


def test_layer_norm_of_a_bfloat16_input_and_its_grad_match_jax():
    """Pure AMP sends the LM's residual stream to layer_norm in bfloat16,
    with float32 Scale and Bias: the statistics and the normalisation in
    bfloat16 (Mean and Variance bfloat16), Y float32 once scaled, and
    the generic grad's dX bfloat16. The JAX side runs with excess
    precision off, or XLA:CPU drops the roundings of the bfloat16
    chain."""
    rng = np.random.RandomState(95)
    feeds = {"x": (_randn(rng, 6, 48) * 2 + 0.3).astype(BF16),
             "scale": _randn(rng, 48), "bias": _randn(rng, 48),
             "y@GRAD": _randn(rng, 6, 48)}
    ins = {"X": ["x"], "Scale": ["scale"], "Bias": ["bias"]}
    outs = {"Y": ["y"], "Mean": [""], "Variance": [""]}
    attrs = {"begin_norm_axis": 1, "epsilon": 1e-5}
    ops = [("layer_norm", ins, {"Y": ["y"], "Mean": ["mean"],
                                "Variance": ["var"]}, attrs),
           _generic_grad("layer_norm", ins, outs, attrs, ins)]
    ops[1][1].update(Mean=["mean"], Variance=["var"])
    got, _ = _assert_ops_match(
        ops, feeds, ["y", "mean", "var", "dx", "dscale", "dbias"], True,
        isolated=True)
    assert [a.dtype for a in got] == [np.float32, BF16, BF16, BF16,
                                      np.float32, np.float32]


def _walk_values(kind, amp):
    """The JAX side of :func:`test_pure_amp_lm_matches_jax_op_by_op`:
    startup, then one step of ``kind`` under ``amp`` that fetches every
    var an op reads or writes. Returns {"before" and "after": the
    persistables around the step, "vals": the fetched values}."""
    main, startup, _, feeds = PROGRAMS[kind]("jax", amp)
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    names = sorted({n for op in main.global_block().ops
                    for n in op.input_arg_names + op.output_arg_names
                    if n and n not in persist})
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()

    def state():
        return {n: np.asarray(scope.find_var(n)) for n in persist
                if scope.find_var(n) is not None}

    with jpt.scope_guard(scope):
        exe.run(startup)
        before = state()
        vals = exe.run(main, feed=feeds[0], fetch_list=names)
        after = state()
    return {"before": before, "after": after,
            "vals": dict(zip(names, (np.asarray(v) for v in vals)))}


def test_pure_amp_lm_matches_jax_op_by_op():
    """One step of the 128-wide LM under pure AMP, walked op by op: each
    op of the port's program runs alone on the inputs the JAX package's
    step gave it (the JAX side with excess precision off), and every
    output must have the JAX output's dtype and value within
    :func:`_close`: the embeddings, layer_norm and its generic grad, the
    bfloat16 projections and their grads, flash_attention and its
    generic grad, the residual and bias adds of bfloat16 and float32,
    relu, softmax_with_cross_entropy on bfloat16 logits, mean, reshape,
    the gradient sums and Adam on float32 parameters and gradients."""
    ref = _jax_isolated("_walk_values", "lm", "pure")
    main = _lm_program("port", "pure")[0]
    block = main.global_block()
    state = dict(ref["before"])
    seen = set()
    for op in block.ops:
        ins = [n for n in op.input_arg_names if n]
        outs = [n for n in op.output_arg_names if n]
        prog = tir.Program()
        for n in set(ins + outs):
            v = block.var(n)
            prog.global_block().create_var(name=n, shape=v.shape,
                                           dtype=v.dtype,
                                           lod_level=v.lod_level)
        prog.global_block().append_op(type=op.type, inputs=op.inputs,
                                      outputs=op.outputs,
                                      attrs=dict(op.attrs))
        tamp.enable(prog, pure=True)
        feeds = {n: state[n] if n in state else ref["vals"][n] for n in ins}
        got = TExecutor("cpu").run(prog, feed=feeds, fetch_list=outs,
                                   scope=TScope())
        for n, g in zip(outs, got):
            persistent = n in ref["after"]
            want = ref["after"][n] if persistent else ref["vals"][n]
            g = np.asarray(g)
            if want.dtype.kind in "iu":  # the JAX package's int32
                assert g.dtype.kind in "iu" and np.array_equal(g, want), n
            else:
                _close("%s %s" % (op.type, n), g, want)
            if persistent:
                state[n] = want
        seen.add(op.attr("__fwd_type__") or op.type)
    assert {"flash_attention", "layer_norm", "relu", "elementwise_add",
            "softmax_with_cross_entropy", "mean", "lookup_table", "reshape",
            "adam", "sum"} <= seen
    # Adam takes float32 parameters and float32 gradients
    for p in _params(main):
        assert ref["vals"][p + "@GRAD"].dtype == np.float32, p


def test_lm_trains_three_pure_amp_steps_like_jax(tmp_path):
    """The parameter gaps separate here: after each step from the JAX
    state the port's parameters are 0.435, 0.055 and 0.014 (norm) from
    the JAX package's, against 1.374, 0.151 and 0.064 from its own
    float32 step (parameter norm ~52); the losses, bfloat16 values, are
    the JAX losses bit for bit."""
    _assert_amp_reproduced(_train_both("lm", "pure", tmp_path),
                           bf16_loss=True)


if __name__ == "__main__":
    import pickle
    import sys
    if sys.argv[1] == "task":
        with open(sys.argv[2], "rb") as fh:
            task, args = pickle.load(fh)
        jamp.force(True)
        with open(sys.argv[3], "wb") as fh:
            pickle.dump(globals()[task](*args), fh)
    else:
        _jax_train(sys.argv[1], {"True": True, "pure": "pure"}[sys.argv[2]],
                   sys.argv[3])
