"""The host IO ops and ``io.py`` (``paddle_tpu_torch/ops/io_ops.py``,
``paddle_tpu_torch/io.py``) against the JAX package's, on the CPU, and
the Executor's hybrid path that runs them.

Files cross between the packages both ways and load bit for bit:
per-variable files (``save_persistables``, ``save_params``), one
combined file (``save_combine``), LoD payloads and bfloat16 values. A
program with a ``save`` between two runs of device ops takes the hybrid
path in both packages. Tolerance: none, every comparison is exact.
"""
import os
import pickle

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.core import lod as jlod  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu_torch import io as tio  # noqa: E402
from paddle_tpu_torch.configs import fit_a_line as tfit  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor, LoDValue  # noqa: E402
from paddle_tpu_torch.core.lod import LoDTensor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope, scope_guard,  # noqa: E402
                                         scope_to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_fit():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_fit", os.path.join(ROOT, "examples", "configs",
                                "fit_a_line.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    main, start = jpt.Program(), jpt.Program()
    with jun.guard(), jpt.program_guard(main, start):
        s = mod.model()
        s["optimizer"].minimize(s["cost"])
    return main, start, s


def _port_fit():
    main, start = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, start):
        s = tfit.model()
        s["optimizer"].minimize(s["cost"])
    return main, start, s


def _feeds(spec):
    return [{"x": np.stack([r[0] for r in b]),
             "y": np.stack([r[1] for r in b])} for b in spec["reader"]()]


def _port_trained(steps=3):
    main, start, s = _port_fit()
    exe, scope = Executor("cpu"), Scope()
    exe.run(start, scope=scope)
    for f in _feeds(s)[:steps]:
        exe.run(main, feed=f, fetch_list=[s["cost"]], scope=scope)
    return main, exe, scope


def _jax_trained(steps=3):
    main, start, s = _jax_fit()
    exe, scope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    with jpt.scope_guard(scope):
        exe.run(start)
        for f in _feeds(s)[:steps]:
            exe.run(main, feed=f, fetch_list=[s["cost"]])
    return main, exe, scope


def _persist(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


@pytest.mark.parametrize("how", ["persistables", "params", "combine"])
def test_port_files_load_in_jax_bit_for_bit(tmp_path, how):
    tmain, texe, tscope = _port_trained()
    d = str(tmp_path)
    with scope_guard(tscope):
        if how == "persistables":
            tio.save_persistables(texe, d, tmain)
        elif how == "params":
            tio.save_params(texe, d, tmain)
        else:
            tio.save_persistables(texe, d, tmain, filename="all.pkl")
    assert texe.stats["hybrid_runs"] == 1
    jmain, jstart, _ = _jax_fit()
    jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
    with jpt.scope_guard(jscope):
        if how == "persistables":
            jpt.io.load_persistables(jexe, d, jmain)
        elif how == "params":
            jpt.io.load_params(jexe, d, jmain)
        else:
            jpt.io.load_persistables(jexe, d, jmain, filename="all.pkl")
    names = ([p.name for p in tmain.all_parameters()] if how == "params"
             else _persist(tmain))
    want = scope_to_numpy(tscope, names)
    assert sorted(want) == sorted(names)
    for n in names:
        got = np.asarray(jscope.find_var(n))
        assert got.dtype == want[n].dtype and np.array_equal(got, want[n]), n


@pytest.mark.parametrize("how", ["persistables", "params", "combine"])
def test_jax_files_load_in_the_port_bit_for_bit(tmp_path, how):
    jmain, jexe, jscope = _jax_trained()
    d = str(tmp_path)
    with jpt.scope_guard(jscope):
        if how == "persistables":
            jpt.io.save_persistables(jexe, d, jmain)
        elif how == "params":
            jpt.io.save_params(jexe, d, jmain)
        else:
            jpt.io.save_persistables(jexe, d, jmain, filename="all.pkl")
    tmain, _, _ = _port_fit()
    exe, scope = Executor("cpu"), Scope()
    with scope_guard(scope):
        if how == "persistables":
            tio.load_persistables(exe, d, tmain)
        elif how == "params":
            tio.load_params(exe, d, tmain)
        else:
            tio.load_persistables(exe, d, tmain, filename="all.pkl")
    assert exe.stats["hybrid_runs"] == 1
    names = ([p.name for p in tmain.all_parameters()] if how == "params"
             else _persist(tmain))
    got = scope_to_numpy(scope, names)
    for n in names:
        want = np.asarray(jscope.find_var(n))
        assert np.array_equal(got[n], want), n


def _lod_program(pkg, op, dirname):
    ir_mod = jpt if pkg == "jax" else tir
    prog = ir_mod.Program()
    blk = prog.global_block()
    v = blk.create_var(name="seq", shape=(-1, 3), dtype="float32",
                       lod_level=1, persistable=True)
    path = os.path.join(dirname, "seq")
    if op == "save":
        blk.append_op("save", inputs={"X": [v]}, attrs={"file_path": path})
    else:
        blk.append_op("load", outputs={"Out": [v]},
                      attrs={"file_path": path})
    return prog


def test_lod_payloads_cross_both_ways(tmp_path):
    data = np.arange(15, dtype=np.float32).reshape(5, 3)
    offsets = [0, 2, 5]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jscope = jpt.Scope()
    jscope.set_var("seq", jlod.LoDTensor(data, [offsets]))
    with jpt.scope_guard(jscope):
        jpt.Executor(jpt.CPUPlace()).run(_lod_program("jax", "save", jdir))
    exe, scope = Executor("cpu"), Scope()
    exe.run(_lod_program("port", "load", jdir), scope=scope)
    v = scope.find_var("seq")
    assert isinstance(v, LoDValue)
    assert np.array_equal(v.data.numpy(), data)
    assert [l.tolist() for l in v.lod] == [offsets] and v.max_lens == (3,)
    exe.run(_lod_program("port", "save", tdir), scope=scope)
    with open(os.path.join(tdir, "seq"), "rb") as f:
        tp = pickle.load(f)
    with open(os.path.join(jdir, "seq"), "rb") as f:
        jp = pickle.load(f)
    assert tp["lod"] == jp["lod"] == [offsets]
    assert np.array_equal(tp["data"], jp["data"])
    back = jpt.Scope()
    with jpt.scope_guard(back):
        jpt.Executor(jpt.CPUPlace()).run(_lod_program("jax", "load", tdir))
    got = back.find_var("seq")
    assert got.lod() == [offsets]
    assert np.array_equal(np.asarray(got.numpy()), data)


def test_bfloat16_values_cross_bit_for_bit(tmp_path):
    bits = np.random.RandomState(0).randint(-2 ** 15, 2 ** 15, (4, 6),
                                            dtype=np.int64).astype(np.int16)
    want = bits.view(ml_dtypes.bfloat16)
    prog = tir.Program()
    blk = prog.global_block()
    w = blk.create_var(name="w", shape=(4, 6), dtype="bfloat16",
                       persistable=True)
    scope = Scope()
    scope.set_var("w", torch.from_numpy(bits.copy()).view(torch.bfloat16))
    with scope_guard(scope):
        tio.save_vars(Executor("cpu"), str(tmp_path), vars=[w])
    with open(str(tmp_path / "w"), "rb") as f:
        payload = pickle.load(f)
    assert payload["data"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(payload["data"].view(np.int16), bits)
    jprog = jpt.Program()
    jw = jprog.global_block().create_var(name="w", shape=(4, 6),
                                         dtype="bfloat16", persistable=True)
    jscope = jpt.Scope()
    with jpt.scope_guard(jscope):
        jpt.io.load_vars(jpt.Executor(jpt.CPUPlace()), str(tmp_path),
                         vars=[jw])
    got = np.asarray(jscope.find_var("w"))
    assert np.array_equal(got.view(np.int16), want.view(np.int16))
    # and back: the JAX package's file into the port
    with jpt.scope_guard(jscope):
        jpt.io.save_vars(jpt.Executor(jpt.CPUPlace()), str(tmp_path / "j"),
                         vars=[jw])
    back = Scope()
    with scope_guard(back):
        tio.load_vars(Executor("cpu"), str(tmp_path / "j"), vars=[w])
    t = back.find_var("w")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), bits)


def _hybrid_program(pkg, path):
    ir_mod = jpt if pkg == "jax" else tir
    prog = ir_mod.Program()
    blk = prog.global_block()
    x = blk.create_var(name="x", shape=(3, 4), dtype="float32")
    a = blk.create_var(name="a", shape=(3, 4), dtype="float32")
    b = blk.create_var(name="b", shape=(3, 4), dtype="float32")
    blk.append_op("scale", inputs={"X": [x]}, outputs={"Out": [a]},
                  attrs={"scale": 2.0, "bias": 1.0})
    blk.append_op("save", inputs={"X": [a]}, attrs={"file_path": path})
    blk.append_op("scale", inputs={"X": [a]}, outputs={"Out": [b]},
                  attrs={"scale": 3.0})
    return prog, b


def test_a_save_between_device_ops_takes_the_hybrid_path(tmp_path):
    xs = np.arange(12, dtype=np.float32).reshape(3, 4)
    files = {}
    for pkg in ("jax", "port", "port_eager"):
        path = str(tmp_path / pkg / "a")
        prog, b = _hybrid_program("jax" if pkg == "jax" else "port", path)
        if pkg == "jax":
            exe = jpt.Executor(jpt.CPUPlace())
            with jpt.scope_guard(jpt.Scope()):
                outs = [exe.run(prog, feed={"x": xs}, fetch_list=[b])
                        for _ in range(3)]
        else:
            exe, scope = Executor("cpu"), Scope()
            outs = [exe.run(prog, feed={"x": xs}, fetch_list=[b],
                            scope=scope, use_jit=pkg == "port")
                    for _ in range(3)]
        for o in outs:
            np.testing.assert_array_equal(np.asarray(o[0]), (2 * xs + 1) * 3)
        if pkg == "jax":
            assert exe.stats["hybrid_runs"] == 3
        elif pkg == "port":
            assert exe.stats["hybrid_runs"] == 3
            assert exe.stats["jit_runs"] == exe.stats["eager_runs"] == 0
            # two device segments, each warmed up, then set up and rerun
            assert len(exe._cache) == 2
            assert all(e.ready and e.runs == 3 for e in exe._cache.values())
        else:
            assert exe.stats["eager_runs"] == 3
        with open(path, "rb") as f:
            files[pkg] = pickle.load(f)
    for pkg in ("port", "port_eager"):
        assert files[pkg]["lod"] == files["jax"]["lod"] == []
        assert np.array_equal(files[pkg]["data"], files["jax"]["data"])


def test_print_is_a_host_op_that_prints(capsys):
    from paddle_tpu_torch.core import registry
    assert registry.op_is_host(registry.lookup_checked("print"), None)
    prog = tir.Program()
    blk = prog.global_block()
    x = blk.create_var(name="x", shape=(2, 2), dtype="float32")
    out = blk.create_var(name="x_printed", shape=(2, 2), dtype="float32")
    blk.append_op("print", inputs={"In": [x]}, outputs={"Out": [out]},
                  attrs={"message": "step", "first_n": 2})
    exe = Executor("cpu")
    for _ in range(3):
        got = exe.run(prog, feed={"x": np.eye(2, dtype=np.float32)},
                      fetch_list=[out], scope=Scope())
    np.testing.assert_array_equal(got[0], np.eye(2, dtype=np.float32))
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("step")]
    assert len(printed) == 2  # first_n
    assert printed[0].startswith("step  name: x_printed  dtype: float32  "
                                 "shape: (2, 2)")


def test_generic_grad_of_a_host_op_is_a_host_op():
    from paddle_tpu_torch.core import registry
    prog = tir.Program()
    op = prog.global_block().append_op(
        "generic_grad", attrs={"__fwd_type__": "print"})
    assert registry.op_is_host(registry.lookup_checked("generic_grad"), op)
    op2 = prog.global_block().append_op(
        "generic_grad", attrs={"__fwd_type__": "scale"})
    assert not registry.op_is_host(registry.lookup_checked("generic_grad"),
                                   op2)


def test_host_lod_tensor_saves_with_its_offsets(tmp_path):
    prog = tir.Program()
    blk = prog.global_block()
    v = blk.create_var(name="t", shape=(-1, 2), dtype="float32",
                       lod_level=1, persistable=True)
    blk.append_op("save_combine", inputs={"X": [v]},
                  attrs={"file_path": str(tmp_path / "c")})
    scope = Scope()
    scope.set_var("t", LoDTensor(np.ones((3, 2), np.float32), [[0, 1, 3]]))
    Executor("cpu").run(prog, scope=scope)
    with open(str(tmp_path / "c"), "rb") as f:
        payload = pickle.load(f)
    assert payload[0]["lod"] == [[0, 1, 3]]
