"""The port's training path against the JAX package's, on the CPU, at
the widths of ``examples/configs/tiny_lm.py`` (2 layers, hidden 32, 4
heads, seq 32, batch 16, vocab 32).

Both packages build the config's program under ``unique_name.guard()``,
so every variable has the same name in both. The JAX package runs its
startup program, and its persistables (parameters, Adam moments, beta
powers, learning rate) are carried into the port's scope by
``scope_from_numpy``: the two initializers draw from different
generators. The JAX side runs the flash kernels of its program in Pallas
interpret mode, as its own tests do.

Tolerances, float32 on both sides, where XLA and PyTorch sum in other
orders (~1e-7 relative a value, through two layers):
- step-1 gradients of every parameter: max abs error <= 1e-5 x the
  largest magnitude of that parameter's JAX gradient;
- Adam losses at each of 5 steps: 1e-5 relative (Adam turns a gradient
  of ~0 into a step of ~lr with either sign, so parameters after Adam
  are not compared);
- parameters after 5 SGD steps (linear in the gradients): 1e-5 absolute.
"""
import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu_torch import inference as tinf  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.configs import tiny_lm as ttiny  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope as TScope,  # noqa: E402
                                         scope_from_numpy, scope_to_numpy)
from paddle_tpu_torch.serving import GenerationEngine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5
REL_TOL = 1e-5


def _jax_tiny():
    spec = importlib.util.spec_from_file_location(
        "jax_tiny_lm", os.path.join(ROOT, "examples", "configs",
                                    "tiny_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JTINY = _jax_tiny()


def _build(pkg, opt):
    """(main, startup, spec, params_grads) of tiny_lm with optimizer
    ``opt`` ("adam" or "sgd") in one package."""
    if pkg == "jax":
        main, startup = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, startup):
            spec = JTINY.model()
            o = spec["optimizer"] if opt == "adam" else \
                jpt.optimizer.SGD(learning_rate=0.05)
            _, pg = o.minimize(spec["cost"])
    else:
        main, startup = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, startup):
            spec = ttiny.model()
            o = spec["optimizer"] if opt == "adam" else \
                topt.SGD(learning_rate=0.05)
            _, pg = o.minimize(spec["cost"])
    return main, startup, spec, pg


def _batches(spec):
    """STEPS feed dicts cycling over the config reader's batches."""
    out = []
    while len(out) < STEPS:
        for b in spec["reader"]():
            out.append({"toks": np.stack([s[0] for s in b]),
                        "tgt": np.stack([s[1] for s in b])})
    return out[:STEPS]


def _train(opt):
    """Run STEPS steps in both packages from the JAX startup state.
    Returns (jax, port) dicts with losses, step-1 gradients, the final
    persistables and the port's scope."""
    jmain, jstart, jspec, jpg = _build("jax", opt)
    tmain, tstart, tspec, tpg = _build("port", opt)
    assert [p.name for p, _ in jpg] == [p.name for p, _ in tpg]
    grads = [g.name for _, g in jpg]
    batches = _batches(jspec)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    jexe = jpt.Executor(jpt.CPUPlace())
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jexe.run(jstart)
        state = {n: np.asarray(jscope.find_var(n)) for n in persist
                 if jscope.find_var(n) is not None}
        jlosses, jgrads = [], None
        for i, feed in enumerate(batches):
            outs = jexe.run(jmain, feed=feed,
                            fetch_list=[jspec["cost"]] + (grads if i == 0
                                                          else []))
            jlosses.append(float(np.asarray(outs[0]).reshape(-1)[0]))
            if i == 0:
                jgrads = [np.asarray(g) for g in outs[1:]]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in state}
    texe = TExecutor("cpu")
    tscope = TScope()
    texe.run(tstart, scope=tscope)
    scope_from_numpy(state, device="cpu", scope=tscope)
    tlosses, tgrads = [], None
    for i, feed in enumerate(batches):
        outs = texe.run(tmain, feed=feed, scope=tscope,
                        fetch_list=[tspec["cost"]] + (grads if i == 0
                                                      else []))
        tlosses.append(float(outs[0].reshape(-1)[0]))
        if i == 0:
            tgrads = outs[1:]
    tfinal = scope_to_numpy(tscope, names=state)
    return (dict(losses=jlosses, grads=dict(zip(grads, jgrads)),
                 final=jfinal),
            dict(losses=tlosses, grads=dict(zip(grads, tgrads)),
                 final=tfinal, scope=tscope))


@pytest.fixture(scope="module")
def adam_run():
    return _train("adam")


def test_step1_gradients_of_every_parameter_match_jax(adam_run):
    jax_run, port_run = adam_run
    assert len(jax_run["grads"]) == 27   # 12 a layer x 2 + 3, FFN biases too
    for name, want in jax_run["grads"].items():
        got = port_run["grads"][name]
        assert got.shape == want.shape, name
        err = float(np.abs(got - want).max())
        assert err <= REL_TOL * float(np.abs(want).max()), (name, err)


def test_adam_losses_match_jax_at_every_step(adam_run):
    jax_run, port_run = adam_run
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               rtol=REL_TOL, atol=0)
    assert port_run["losses"][-1] < port_run["losses"][0]
    # the beta powers advanced once a step in both
    b1 = [n for n in jax_run["final"] if n.startswith("beta1_pow_acc")]
    assert b1 and np.allclose(port_run["final"][b1[0]], 0.9 ** (STEPS + 1))


def test_sgd_parameters_match_jax_after_five_steps():
    jax_run, port_run = _train("sgd")
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               rtol=REL_TOL, atol=0)
    assert sorted(port_run["final"]) == sorted(jax_run["final"])
    for name, want in jax_run["final"].items():
        np.testing.assert_allclose(port_run["final"][name], want, rtol=0,
                                   atol=1e-5, err_msg=name)


def test_cli_trains_tiny_lm_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join("paddle_tpu_torch", "configs", "tiny_lm.py"),
         "--device", "cpu", "--num_passes", "2", "--log_period", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    costs = [ln for ln in lines if ln.startswith("pass ") and " cost " in ln]
    # 24 samples in batches of 16: two batches a pass, each logged
    assert [ln.split(" cost ")[0] for ln in costs] == [
        "pass 0 batch 0", "pass 0 batch 1", "pass 1 batch 0",
        "pass 1 batch 1"]
    assert all(np.isfinite(float(ln.split(" cost ")[1])) for ln in costs)
    assert sum(ln.endswith("}") and " done: " in ln for ln in lines) == 2


def test_cli_train_without_a_card_raises_for_cuda():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "train",
         os.path.join("paddle_tpu_torch", "configs", "tiny_lm.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "NoDeviceError" in out.stderr


def test_export_generative_takes_the_same_arguments_in_both_packages(
        tmp_path, adam_run):
    jax_run, port_run = adam_run
    cfg = JTINY.lm_config()
    jscope = jpt.Scope()
    for n, a in jax_run["final"].items():
        jscope.set_var(n, a)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    tscope = scope_from_numpy(jax_run["final"], device="cpu")
    # positional (dirname, config, scope) and keyword params= alike
    jinf.export_generative(jdir, cfg, jscope)
    tinf.export_generative(tdir, cfg.to_dict(), tscope)
    with open(os.path.join(jdir, jinf.GEN_PARAMS_FILE), "rb") as f:
        jp = pickle.load(f)
    with open(os.path.join(tdir, tinf.GEN_PARAMS_FILE), "rb") as f:
        tp = pickle.load(f)
    assert list(tp) == list(jp)
    for n in jp:
        assert np.array_equal(tp[n], jp[n]), n
    for fname in (jinf.GEN_CONFIG_FILE,):
        with open(os.path.join(jdir, fname)) as a, \
                open(os.path.join(tdir, fname)) as b:
            assert a.read() == b.read()
    kw = str(tmp_path / "kw")
    tinf.export_generative(kw, cfg.to_dict(), params=tp)
    assert tinf.validate_generative_artifact(kw) == []
    with pytest.raises(ValueError, match="missing transformer params"):
        tinf.export_generative(str(tmp_path / "bad"), cfg.to_dict(),
                               scope=TScope())


def test_trained_scope_exports_and_serves_jax_greedy_tokens(tmp_path,
                                                            adam_run):
    """train (port) -> export_generative(scope=) -> load_generative ->
    the port's engine: greedy tokens equal the JAX package's greedy
    decode over the same exported weights. The FFN-up bias of the
    Program is not exported (the JAX package's param_names leave it
    out), so the served model is the trained one minus that bias."""
    _, port_run = adam_run
    cfg = ttiny.lm_config()
    art = str(tmp_path / "trained")
    tinf.export_generative(art, cfg, scope=port_run["scope"])
    model = tinf.load_generative(art, device="cpu")
    for n, t in model.params.items():
        assert np.array_equal(t.numpy(), port_run["final"][n])
    jmodel = jinf.load_generative(art)
    prompts = [[1, 2, 3], list(range(5, 17))]
    with GenerationEngine(model, max_running=2, kv_pages=16, page_tokens=8,
                          queue_depth=8, warm=False) as eng:
        got = [h.wait(timeout=120).tokens
               for h in [eng.submit(p, max_new_tokens=6) for p in prompts]]
    # JAX's greedy decode of each prompt is its argmax at every position
    # of one forward over prompt + the port's tokens (teacher forcing
    # gives the same sequence, by induction over the steps)
    for p, toks in zip(prompts, got):
        logits = np.asarray(jmodel.forward(jnp.asarray([p + toks],
                                                       jnp.int32)))[0]
        assert toks == [int(t) for t in
                        np.argmax(logits[len(p) - 1:-1], axis=-1)]
