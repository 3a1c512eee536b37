"""The port's sequence training path against the JAX package's, on the
CPU: ``configs/text_rnn.py`` (``benchmark/rnn_bench.py``'s stacked-RNN
text classifier without peepholes) trained 4 Adam steps in both packages
from the same state, with LSTM and with GRU cells, then through the
port's CLI.

Both programs are built under each package's ``unique_name.guard()``;
the JAX startup state is carried across with ``scope_from_numpy`` (the
initializers draw from different generators). Both run the fused
recurrence: the JAX package its Pallas kernels in interpret mode under
``lstm_impl="pallas"``, the port its wrappers' plain versions (the CPU),
reached through the ``lstm_impl="pallas"`` attr the config puts on its
ops. Size: vocab 1000, hidden 128 (the kernels' lane width), 2 layers
(the second reversed), one fixed batch of 8 sequences of 3 to 24 words.
Tolerance: the losses agree to 2e-4 relative at every step, float32 on
both sides (XLA and PyTorch sum in other orders through 24 steps of two
recurrences and Adam's updates), and fall.

The bias-free LSTM classifier (``bias=False``) also trains under pure
AMP in both packages (``amp.force(True)``, ``amp.enable(program,
pure=True)``): its projections stay bfloat16 and reach the fused LSTM's
bfloat16 face (the port's plain version on the CPU, the JAX kernel in
interpret mode). The JAX side runs in a process of its own with XLA's
excess precision off, so that it rounds each bfloat16 result as the
program writes it. The losses, bfloat16 values, must lie within one
bfloat16 ulp of the JAX losses at every step: float32 noise may put a
value near a rounding boundary on the other side.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu.core import lod as jlod  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.configs import text_rnn as tcfg  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import lod as tlod  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope as TScope,  # noqa: E402
                                         scope_from_numpy)
from paddle_tpu_torch.flags import FLAGS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=1000, hidden=128, layers=2, batch=8, learning_rate=0.002)
STEPS = 4
LOSS_RTOL = 2e-4


def _jax_model(cell, bias=True):
    """The JAX twin of ``configs/text_rnn.model(cell, bias=bias,
    **SMALL)``."""
    vocab, hidden = SMALL["vocab"], SMALL["hidden"]
    bias_attr = None if bias else False
    words = jlayers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    label = jlayers.data(name="label", shape=[1], dtype="int64")
    inp = jlayers.embedding(input=words, size=[vocab, hidden])
    for i in range(SMALL["layers"]):
        if cell == "lstm":
            proj = jlayers.fc(input=inp, size=hidden * 4,
                              bias_attr=bias_attr)
            inp, _ = jlayers.dynamic_lstm(input=proj, size=hidden * 4,
                                          use_peepholes=False,
                                          bias_attr=bias_attr,
                                          is_reverse=(i % 2 == 1))
        else:
            proj = jlayers.fc(input=inp, size=hidden * 3)
            inp = jlayers.dynamic_gru(input=proj, size=hidden,
                                      is_reverse=(i % 2 == 1))
    pooled = jlayers.sequence_pool(input=inp, pool_type="max")
    pred = jlayers.fc(input=pooled, size=2, act="softmax")
    avg_cost = jlayers.mean(jlayers.cross_entropy(input=pred, label=label))
    jpt.optimizer.Adam(learning_rate=SMALL["learning_rate"]).minimize(
        avg_cost)
    return avg_cost


def _signature(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
            for op in program.global_block().ops]


def _batch():
    rng = np.random.RandomState(5)
    lengths = rng.randint(3, 25, SMALL["batch"])
    seqs = [rng.randint(0, SMALL["vocab"], (n, 1)).astype(np.int64)
            for n in lengths]
    labels = rng.randint(0, 2, (SMALL["batch"], 1)).astype(np.int64)
    return seqs, labels


@pytest.fixture(scope="module", params=["lstm", "gru"])
def slice_run(request):
    cell = request.param
    jmain, jstart = jpt.Program(), jpt.Program()
    with jun.guard(), jpt.program_guard(jmain, jstart):
        jcost = _jax_model(cell)
    tmain, tstart = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(tmain, tstart):
        spec = tcfg.model(cell=cell, **SMALL)
        spec["optimizer"].minimize(spec["cost"])
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    seqs, labels = _batch()
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope), jpt.flags_guard(lstm_impl="pallas"):
        jexe = jpt.Executor(jpt.CPUPlace())
        jexe.run(jstart)
        state = {n: np.asarray(jscope.find_var(n)) for n in persist
                 if jscope.find_var(n) is not None}
        feed = {"words": jlod.build_lod_tensor(seqs), "label": labels}
        jlosses = [float(np.asarray(jexe.run(jmain, feed=feed,
                                             fetch_list=[jcost])[0])
                         .reshape(-1)[0]) for _ in range(STEPS)]
    texe = TExecutor("cpu")
    tscope = scope_from_numpy(state, device="cpu", scope=TScope())
    feed = {"words": tlod.build_lod_tensor(seqs), "label": labels}
    kernels.reset_launches()
    tlosses = [float(texe.run(tmain, feed=feed, fetch_list=[spec["cost"]],
                              scope=tscope)[0].reshape(-1)[0])
               for _ in range(STEPS)]
    return dict(cell=cell, jmain=jmain, tmain=tmain, jlosses=jlosses,
                tlosses=tlosses, launches=kernels.launch_counts())


def test_programs_match_op_for_op(slice_run):
    jmain, tmain = slice_run["jmain"], slice_run["tmain"]
    assert _signature(tmain) == _signature(jmain)
    assert sorted(p.name for p in tmain.all_parameters()) == \
        sorted(p.name for p in jmain.all_parameters())
    cell = slice_run["cell"]
    rnn = [op for op in tmain.global_block().ops if op.type == cell]
    assert [op.attr("is_reverse") for op in rnn] == [False, True]
    # the config opts its own ops in; the process flag stays the default
    assert {op.attr("lstm_impl") for op in rnn} == {"pallas"}
    assert FLAGS.lstm_impl == "scan"


def test_adam_losses_match_jax_at_every_step_and_fall(slice_run):
    j, t = slice_run["jlosses"], slice_run["tlosses"]
    np.testing.assert_allclose(t, j, rtol=LOSS_RTOL, atol=0)
    assert all(np.isfinite(t)) and t[-1] < t[0]
    # the CPU takes the plain versions: no kernel launch is counted
    assert set(slice_run["launches"].values()) == {0}


def test_config_reader_draws_rnn_bench_batches():
    main, startup = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, startup):
        spec = tcfg.model(vocab=50, seq_len=7, batch=4, samples=6)
    batches = list(spec["reader"]())
    assert [len(b) for b in batches] == [4, 2]
    rng = np.random.RandomState(0)
    seqs = [rng.randint(0, 50, (7, 1)) for _ in range(4)]
    labels = rng.randint(0, 2, (4, 1))
    for (words, label), s, lab in zip(batches[0], seqs, labels):
        np.testing.assert_array_equal(words, s)
        np.testing.assert_array_equal(label, lab)
    with pytest.raises(ValueError, match="cell"):
        tcfg.model(cell="rnn")


def test_config_bias_false_is_for_the_lstm_only():
    # dynamic_gru always makes its bias, in both packages
    with tun.guard(), tir.program_guard(tir.Program(), tir.Program()):
        with pytest.raises(ValueError, match="bias=False"):
            tcfg.model(cell="gru", bias=False)
    main = tir.Program()
    with tun.guard(), tir.program_guard(main, tir.Program()):
        tcfg.model(cell="lstm", bias=False)
    ops = main.global_block().ops
    assert [op.type for op in ops if op.type in ("mul", "lstm")] == \
        ["mul", "lstm", "mul", "lstm", "mul"]
    assert all(not op.input("Bias") for op in ops if op.type == "lstm")
    # only the softmax fc keeps a bias
    assert sum(op.type == "elementwise_add" for op in ops) == 1


# -- pure AMP, no biases: the fused LSTM's bfloat16 face ----------------------

def _pure_programs(pkg, lstm_impl="pallas"):
    """(main, startup, cost, names of the lstm ops' Hidden) of the
    bias-free LSTM classifier in ``pkg`` under pure AMP."""
    if pkg == "jax":
        main, startup = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, startup):
            cost = _jax_model("lstm", bias=False)
        jamp.enable(main, pure=True)
    else:
        main, startup = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, startup):
            spec = tcfg.model(cell="lstm", bias=False, lstm_impl=lstm_impl,
                              **SMALL)
            spec["optimizer"].minimize(spec["cost"])
        cost = spec["cost"]
        tamp.enable(main, pure=True)
    hidden = [op.output("Hidden")[0] for op in main.global_block().ops
              if op.type == "lstm"]
    return main, startup, cost, hidden


def _jax_pure_amp_run(out):
    """The JAX side: startup, then STEPS steps under pure AMP with the
    fused kernel (interpret mode); pickles the startup state, the losses
    and the Hidden dtypes to ``out``. Run in a process of its own
    (``__main__`` below) with XLA's excess precision off."""
    import pickle
    jamp.force(True)
    main, startup, cost, hidden = _pure_programs("jax")
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    seqs, labels = _batch()
    feed = {"words": jlod.build_lod_tensor(seqs), "label": labels}
    scope = jpt.Scope()
    with jpt.scope_guard(scope), jpt.flags_guard(lstm_impl="pallas"):
        exe = jpt.Executor(jpt.CPUPlace())
        exe.run(startup)
        state = {n: np.asarray(scope.find_var(n)) for n in persist
                 if scope.find_var(n) is not None}
        losses, dtypes = [], []
        for _ in range(STEPS):
            outs = exe.run(main, feed=feed, fetch_list=[cost] + hidden)
            losses.append(float(np.asarray(outs[0], np.float64)
                                .reshape(-1)[0]))
            dtypes.append([str(np.asarray(o).dtype) for o in outs])
    with open(out, "wb") as fh:
        pickle.dump({"state": state, "losses": losses, "dtypes": dtypes},
                    fh)


@pytest.fixture
def amp_forced():
    jprev, tprev = jamp.force(True), tamp.force(True)
    yield
    jamp.force(jprev)
    tamp.force(tprev)


def test_pure_amp_bias_free_lstm_trains_like_jax(amp_forced, tmp_path):
    jmain = _pure_programs("jax")[0]
    tmain, _, tcost, hidden = _pure_programs("port")
    assert _signature(tmain) == _signature(jmain)
    out = str(tmp_path / "jax.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false").strip())
    subprocess.run([sys.executable, os.path.abspath(__file__), "pure_amp",
                    out], check=True, env=env, timeout=600)
    import pickle
    with open(out, "rb") as fh:
        ref = pickle.load(fh)
    seqs, labels = _batch()
    feed = {"words": tlod.build_lod_tensor(seqs), "label": labels}
    tscope = scope_from_numpy(ref["state"], device="cpu", scope=TScope())
    texe = TExecutor("cpu")
    kernels.reset_launches()
    losses, dtypes = [], []
    for _ in range(STEPS):
        outs = texe.run(tmain, feed=feed, fetch_list=[tcost] + hidden,
                        scope=tscope)
        losses.append(float(np.asarray(outs[0], np.float64).reshape(-1)[0]))
        dtypes.append([str(np.asarray(o).dtype) for o in outs])
    # the loss and both Hidden outputs are bfloat16 in both packages
    assert dtypes == ref["dtypes"] == [["bfloat16"] * 3] * STEPS
    for step, (t, j) in enumerate(zip(losses, ref["losses"])):
        ulp = 2.0 ** (math.floor(math.log2(abs(j))) - 7)
        assert abs(t - j) <= ulp, (step, losses, ref["losses"])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert set(kernels.launch_counts().values()) == {0}


def test_pure_amp_lstm_op_hands_the_fused_face_a_float32_mask(
        amp_forced, monkeypatch):
    from paddle_tpu_torch.ops import sequence_ops
    seen = []
    real = sequence_ops.fused_lstm

    def record(xs, w, h0, c0, mask):
        seen.append(tuple(t.dtype for t in (xs, w, h0, c0, mask)))
        return real(xs, w, h0, c0, mask)

    monkeypatch.setattr(sequence_ops, "fused_lstm", record)
    tmain, tstart, tcost, _ = _pure_programs("port")
    seqs, labels = _batch()
    TExecutor("cpu").run(tmain, feed={"words": tlod.build_lod_tensor(seqs),
                                      "label": labels},
                         fetch_list=[tcost], scope=_started(tstart))
    bf, f32 = torch.bfloat16, torch.float32
    # both layers' forwards, and their replays in the generic grads
    assert seen == [(bf, f32, bf, bf, f32)] * 4


def _started(startup):
    scope = TScope()
    TExecutor("cpu").run(startup, scope=scope)
    return scope


def test_pure_amp_bias_free_lstm_scan_route_raises_in_both_packages(
        amp_forced):
    # the reference's scan starts its carry in the data's dtype
    # (bfloat16) and each step returns float32 (float32 w); the port's
    # scan multiplies bfloat16 h by float32 w
    jmain, jstart, jcost, _ = _pure_programs("jax")
    seqs, labels = _batch()
    with jpt.scope_guard(jpt.Scope()), jpt.flags_guard(lstm_impl="scan"):
        jexe = jpt.Executor(jpt.CPUPlace())
        jexe.run(jstart)
        with pytest.raises(TypeError, match="carry"):
            jexe.run(jmain, feed={"words": jlod.build_lod_tensor(seqs),
                                  "label": labels}, fetch_list=[jcost])
    tmain, tstart, tcost, _ = _pure_programs("port", lstm_impl="scan")
    with pytest.raises(RuntimeError, match="dtype"):
        TExecutor("cpu").run(tmain, feed={"words":
                                          tlod.build_lod_tensor(seqs),
                                          "label": labels},
                             fetch_list=[tcost], scope=_started(tstart))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cli_trains_the_text_rnn_config_on_the_cpu(cell, tmp_path):
    # a config file of the CLI's contract that picks the cell
    cfg = tmp_path / ("text_%s.py" % cell)
    cfg.write_text("from paddle_tpu_torch.configs import text_rnn\n\n\n"
                   "def model():\n    return text_rnn.model(cell=%r)\n"
                   % cell)
    path = (os.path.join("paddle_tpu_torch", "configs", "text_rnn.py")
            if cell == "lstm" else str(cfg))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train", path,
         "--device", "cpu", "--log_period", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    costs = [float(ln.split(" cost ")[1]) for ln in out.stdout.splitlines()
             if ln.startswith("pass ") and " cost " in ln]
    assert len(costs) == 4                  # 32 samples in batches of 8
    assert all(np.isfinite(costs))
    assert any(" done: " in ln for ln in out.stdout.splitlines())


def test_cli_train_of_the_text_rnn_config_raises_without_a_card():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join("paddle_tpu_torch", "configs", "text_rnn.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "NoDeviceError" in out.stderr


if __name__ == "__main__":
    if sys.argv[1] == "pure_amp":
        _jax_pure_amp_run(sys.argv[2])
