"""The port's Program IR, backward and op lowerings against the JAX
package's, on the CPU.

1. Structure: the ``transformer_lm`` + softmax-CE + Adam program, built
   in both packages under ``unique_name.guard()``, has the same ops
   (type, input and output names, in order), the same variables and
   parameters, and so the same ``@GRAD``/``@RENAME``/``@ACC`` structure
   after ``append_backward`` and ``minimize``; the startup programs
   match too.
2. Lowerings: every op of the slice in a one-op program, built and run
   by each package's Executor on the same numpy inputs. Where the op has
   a gradient, its grad op (the registered maker's, explicit or generic)
   is appended with a numpy cotangent fed for the output, and the input
   gradients are compared too. Tolerance: 1e-5 absolute on values of
   size ~1, float32 on both sides (XLA and PyTorch sum in other orders).
   The random initializers draw from different generators (threefry in
   JAX, a ``torch.Generator`` here) and are compared by their bounds and
   moments instead.
3. Test programs: ``Program.clone(for_test=True)`` and ``Program.prune``
   on each book config (``tests/torch_book.py``) keep the same ops, in
   the same order, as the JAX package's on its twin, with ``is_test``
   set on every ``batch_norm``; ``sub_block_read_names`` gives the JAX
   package's names on a program with nested sub-blocks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import layers as jl  # noqa: E402
from paddle_tpu import models as jm  # noqa: E402
from paddle_tpu.core import backward as jbackward  # noqa: E402
from paddle_tpu.core import registry as jregistry  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu_torch import layers as tl  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.core import backward as tbackward  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import registry as tregistry  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.models import transformer as tm  # noqa: E402

TOL = 1e-5
V, S = 16, 8


def _lm_program(pkg):
    """(main, startup) of transformer_lm + loss + Adam in one package."""
    if pkg == "jax":
        L, models, Program, guard, name_guard = \
            jl, jm, jpt.Program, jpt.program_guard, jun.guard
        adam = jpt.optimizer.Adam
    else:
        L, models, Program, guard, name_guard = \
            tl, tm, tir.Program, tir.program_guard, tun.guard
        adam = topt.Adam
    main, startup = Program(), Program()
    with name_guard(), guard(main, startup):
        toks = L.data("toks", shape=[S], dtype="int64")
        toks.shape = (-1, S)
        tgt = L.data("tgt", shape=[S], dtype="int64")
        tgt.shape = (-1, S)
        logits = models.transformer_lm(toks, vocab_size=V, hidden=16,
                                       num_layers=2, num_heads=2)
        flat = L.reshape(logits, shape=[-1, V])
        cost = L.mean(L.softmax_with_cross_entropy(
            flat, L.reshape(tgt, shape=[-1, 1])))
        adam(learning_rate=0.01).minimize(cost)
    return main, startup


def _op_descs(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
            for op in program.global_block().ops]


def test_lm_program_structure_matches_jax():
    jmain, jstart = _lm_program("jax")
    tmain, tstart = _lm_program("port")
    assert _op_descs(tmain) == _op_descs(jmain)
    assert _op_descs(tstart) == _op_descs(jstart)
    jvars, tvars = jmain.global_block().vars, tmain.global_block().vars
    assert sorted(tvars) == sorted(jvars)
    assert sorted(p.name for p in tmain.all_parameters()) == \
        sorted(p.name for p in jmain.all_parameters())
    for n, jv in jvars.items():
        tv = tvars[n]
        assert (tv.shape, tv.dtype, tv.persistable, tv.stop_gradient) == \
            (jv.shape, jv.dtype, jv.persistable, jv.stop_gradient), n
    marked = [n for n in tvars if "@RENAME" in n or "@ACC" in n]
    assert marked and all(n in jvars for n in marked)
    types = [op.type for op in tmain.global_block().ops]
    assert "generic_grad" in types and "mul_grad" in types
    assert types.count("adam") == len(tmain.all_parameters())
    assert types[-2:] == ["scale", "scale"]       # the beta-pow advance


# -- one-op programs -------------------------------------------------------

def _pkg(name):
    if name == "jax":
        return dict(L=jl, Program=jpt.Program, guard=jpt.program_guard,
                    registry=jregistry, backward=jbackward,
                    grad=jpt.grad_var_name)
    return dict(L=tl, Program=tir.Program, guard=tir.program_guard,
                registry=tregistry, backward=tbackward,
                grad=tir.grad_var_name)


def _run_one_op(pkg, spec, feeds):
    """Build ``spec``'s op (and its grad op) in one package, run it and
    return {fetch name: np.ndarray}."""
    P = _pkg(pkg)
    main = P["Program"]()
    with P["guard"](main, P["Program"]()):
        block = main.global_block()
        for name, (arr, diff) in spec["inputs"].items():
            block.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                             stop_gradient=not diff)
        for name, dtype in spec["outputs"].items():
            block.create_var(name=name, dtype=dtype)
        op = block.append_op(type=spec["type"], inputs=spec["slots_in"],
                             outputs=spec["slots_out"],
                             attrs=dict(spec.get("attrs", {})))
        fetch = list(spec["outputs"])
        grad_of = {}
        for out, cot in spec.get("cotangents", {}).items():
            g = P["grad"](out)
            block.create_var(name=g, shape=cot.shape, dtype="float32",
                             stop_gradient=True)
            grad_of[out] = g
        if grad_of:
            opdef = P["registry"].lookup(op.type)
            maker = opdef.grad_maker or P["backward"].default_grad_maker
            descs = maker(op, block, grad_of, set())
            for gtype, gin, gout, gattrs in descs:
                for names in gout.values():
                    for n in names:
                        if n and not block.has_var(n):
                            block.create_var(name=n, dtype="float32")
                block.append_op(type=gtype, inputs=gin, outputs=gout,
                                attrs=gattrs)
                fetch += [n for ns in gout.values() for n in ns if n]
    feed = dict(feeds)
    feed.update({P["grad"](o): c
                 for o, c in spec.get("cotangents", {}).items()})
    if pkg == "jax":
        exe = jpt.Executor(jpt.CPUPlace())
        with jpt.scope_guard(jpt.Scope()):
            outs = exe.run(main, feed=feed, fetch_list=fetch)
        outs = [np.asarray(o) for o in outs]
    else:
        outs = TExecutor("cpu").run(main, feed=feed, fetch_list=fetch,
                                    scope=TScope())
    return dict(zip(fetch, outs))


def _f(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _op_cases():
    rng = np.random.RandomState(0)
    x3, y2 = _f(rng, 2, 3, 4), _f(rng, 4, 5)
    ids = rng.randint(0, 7, (3, 5)).astype(np.int64)
    w = _f(rng, 7, 4)
    lab = rng.randint(0, 6, (5, 1)).astype(np.int64)
    q, k, v = _f(rng, 2, 9, 2, 8), _f(rng, 2, 9, 2, 8), _f(rng, 2, 9, 2, 8)
    p, g = _f(rng, 3, 4), _f(rng, 3, 4)
    m2 = np.abs(_f(rng, 3, 4))
    one = np.ones((1,), np.float32)

    def case(type, ins, slots_in, outs, slots_out, attrs=None, cots=None):
        return dict(type=type, inputs=ins, slots_in=slots_in, outputs=outs,
                    slots_out=slots_out, attrs=attrs or {},
                    cotangents=cots or {})

    f32 = "float32"
    return {
        "fill_constant": case(
            "fill_constant", {}, {}, {"out": f32}, {"Out": ["out"]},
            {"shape": [2, 3], "value": 1.5, "dtype": "float32"}),
        "fill_constant_batch_size_like": case(
            "fill_constant_batch_size_like", {"ref": (ids, False)},
            {"Input": ["ref"]}, {"out": f32}, {"Out": ["out"]},
            {"shape": [-1, 6], "value": 2.0, "dtype": "float32",
             "input_dim_idx": 0, "output_dim_idx": 0}),
        "assign": case("assign", {"x": (x3, True)}, {"X": ["x"]},
                       {"out": f32}, {"Out": ["out"]},
                       cots={"out": _f(rng, 2, 3, 4)}),
        "cast": case("cast", {"x": (x3 * 3, False)}, {"X": ["x"]},
                     {"out": "int32"}, {"Out": ["out"]},
                     {"in_dtype": "float32", "out_dtype": "int32"}),
        "reshape": case("reshape", {"x": (x3, True)}, {"X": ["x"]},
                        {"out": f32}, {"Out": ["out"]}, {"shape": [0, -1]},
                        cots={"out": _f(rng, 2, 12)}),
        "lookup_table": case(
            "lookup_table", {"ids": (ids, False), "w": (w, True)},
            {"Ids": ["ids"], "W": ["w"]}, {"out": f32}, {"Out": ["out"]},
            {"padding_idx": -1}, cots={"out": _f(rng, 3, 5, 4)}),
        "mul": case("mul", {"x": (x3, True), "y": (y2, True)},
                    {"X": ["x"], "Y": ["y"]}, {"out": f32}, {"Out": ["out"]},
                    {"x_num_col_dims": 2, "y_num_col_dims": 1},
                    cots={"out": _f(rng, 2, 3, 5)}),
        "elementwise_add": case(
            "elementwise_add", {"x": (x3, True), "y": (_f(rng, 3, 4), True)},
            {"X": ["x"], "Y": ["y"]}, {"out": f32}, {"Out": ["out"]},
            {"axis": -1}, cots={"out": _f(rng, 2, 3, 4)}),
        "elementwise_add_bias": case(
            "elementwise_add", {"x": (x3, True), "y": (_f(rng, 4), True)},
            {"X": ["x"], "Y": ["y"]}, {"out": f32}, {"Out": ["out"]},
            {"axis": 2}, cots={"out": _f(rng, 2, 3, 4)}),
        "sum": case("sum", {"a": (x3, True), "b": (_f(rng, 2, 3, 4), True)},
                    {"X": ["a", "b"]}, {"out": f32}, {"Out": ["out"]},
                    cots={"out": _f(rng, 2, 3, 4)}),
        "scale": case("scale", {"x": (x3, True)}, {"X": ["x"]}, {"out": f32},
                      {"Out": ["out"]}, {"scale": 2.5, "bias": -1.0},
                      cots={"out": _f(rng, 2, 3, 4)}),
        "cumsum": case("cumsum", {"x": (x3, True)}, {"X": ["x"]},
                       {"out": f32}, {"Out": ["out"]}, {"axis": 1},
                       cots={"out": _f(rng, 2, 3, 4)}),
        "mean": case("mean", {"x": (x3, True)}, {"X": ["x"]}, {"out": f32},
                     {"Out": ["out"]}, cots={"out": np.array([0.7],
                                                             np.float32)}),
        "relu": case("relu", {"x": (x3, True)}, {"X": ["x"]}, {"out": f32},
                     {"Out": ["out"]}, cots={"out": _f(rng, 2, 3, 4)}),
        "layer_norm": case(
            "layer_norm", {"x": (x3, True), "s": (_f(rng, 4), True),
                           "b": (_f(rng, 4), True)},
            {"X": ["x"], "Scale": ["s"], "Bias": ["b"]},
            {"y": f32, "mu": f32, "var": f32},
            {"Y": ["y"], "Mean": ["mu"], "Variance": ["var"]},
            {"epsilon": 1e-5, "begin_norm_axis": 2},
            cots={"y": _f(rng, 2, 3, 4)}),
        "softmax_with_cross_entropy": case(
            "softmax_with_cross_entropy",
            {"logits": (_f(rng, 5, 6), True), "label": (lab, False)},
            {"Logits": ["logits"], "Label": ["label"]},
            {"sm": f32, "loss": f32}, {"Softmax": ["sm"], "Loss": ["loss"]},
            {"soft_label": False}, cots={"loss": _f(rng, 5, 1)}),
        "flash_attention": case(
            "flash_attention", {"q": (q, True), "k": (k, True),
                                "v": (v, True)},
            {"Q": ["q"], "K": ["k"], "V": ["v"]}, {"out": f32},
            {"Out": ["out"]}, {"causal": True},
            cots={"out": _f(rng, 2, 9, 2, 8)}),
        "sgd": case("sgd", {"p": (p, False), "g": (g, False),
                            "lr": (np.array([0.1], np.float32), False)},
                    {"Param": ["p"], "Grad": ["g"], "LearningRate": ["lr"]},
                    {"p_out": f32}, {"ParamOut": ["p_out"]}),
        "adam": case(
            "adam", {"p": (p, False), "g": (g, False),
                     "m1": (_f(rng, 3, 4), False), "m2": (m2, False),
                     "b1p": (one * 0.81, False), "b2p": (one * 0.998, False),
                     "lr": (one * 0.01, False)},
            {"Param": ["p"], "Grad": ["g"], "Moment1": ["m1"],
             "Moment2": ["m2"], "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"],
             "LearningRate": ["lr"]},
            {"p_out": f32, "m1_out": f32, "m2_out": f32},
            {"ParamOut": ["p_out"], "Moment1Out": ["m1_out"],
             "Moment2Out": ["m2_out"]},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    }


_CASES = _op_cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_op_lowering_and_gradient_match_jax(name):
    spec = _CASES[name]
    feeds = {n: a for n, (a, _) in spec["inputs"].items()}
    want = _run_one_op("jax", spec, feeds)
    got = _run_one_op("port", spec, feeds)
    assert sorted(got) == sorted(want)
    if spec["cotangents"]:
        assert any(n.endswith("@GRAD") for n in got)
    for n in want:
        w, g = np.asarray(want[n]), np.asarray(got[n])
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=0, atol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize("op_type,attrs", [
    ("uniform_random", {"min": -0.5, "max": 1.5}),
    ("gaussian_random", {"mean": 0.25, "std": 2.0}),
])
def test_random_initializer_matches_jax_in_distribution(op_type, attrs):
    """Same op, 40000 draws each: bounds and the first two moments agree
    within 3% of the spread (different generators, same law)."""
    spec = dict(type=op_type, inputs={}, slots_in={},
                outputs={"out": "float32"}, slots_out={"Out": ["out"]},
                attrs=dict(attrs, shape=[200, 200], dtype="float32",
                           seed=0))
    want = _run_one_op("jax", spec, {})["out"]
    got = _run_one_op("port", spec, {})["out"]
    assert got.shape == want.shape == (200, 200)
    spread = float(want.std())
    assert abs(float(got.mean()) - float(want.mean())) < 0.03 * spread
    assert abs(float(got.std()) - spread) < 0.03 * spread
    if op_type == "uniform_random":
        assert got.min() >= attrs["min"] and got.max() <= attrs["max"]


# -- 3. test programs ----------------------------------------------------------

import torch_book as book  # noqa: E402


def _kept(program):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             op.attrs.get("is_test"))
            for op in program.global_block().ops]


@pytest.mark.parametrize("kind", book.KINDS)
def test_prune_keeps_the_jax_ops_in_order(kind):
    jmain, _, jspec = book.build("jax", kind)
    tmain, _, tspec = book.build("port", kind)
    feeds = [v.name for v in tspec["feed_list"]]
    for fetch in ([tspec["prediction_name"]], [tspec["cost"].name]):
        want = jmain.prune(feeds=feeds, fetches=fetch)
        got = tmain.prune(feeds=feeds, fetches=fetch)
        assert _kept(got) == _kept(want)
        types = [op.type for op in got.global_block().ops]
        assert not any(t.endswith("_grad") or t in ("sgd", "adam",
                                                    "momentum")
                       for t in types), types
        assert len(types) < len(tmain.global_block().ops)
        # every variable stays; the source is untouched
        assert set(got.global_block().vars) == set(tmain.global_block().vars)
        assert got._uid != tmain._uid
    bns = [op for op in got.global_block().ops if op.type == "batch_norm"]
    assert all(op.attrs["is_test"] is True for op in bns)
    assert all(not op.attrs.get("is_test") for op in
               tmain.global_block().ops if op.type == "batch_norm")
    if kind == "resnet_cifar":
        assert len(bns) == 9


def test_clone_for_test_flips_is_test_only():
    jmain, _, _ = book.build("jax", "resnet_cifar")
    tmain, _, _ = book.build("port", "resnet_cifar")
    for for_test in (False, True):
        got, want = tmain.clone(for_test), jmain.clone(for_test)
        assert _kept(got) == _kept(want)
        assert got._uid != tmain._uid
        n_bn = sum(op.type == "batch_norm" for op in got.global_block().ops)
        n_test = sum(bool(op.attrs.get("is_test"))
                     for op in got.global_block().ops)
        assert n_test == (n_bn if for_test else 0)
        # the grad ops keep their own attrs
        assert len(got.global_block().ops) == len(tmain.global_block().ops)
    assert not any(op.attrs.get("is_test")
                   for op in tmain.global_block().ops)


def _nested(pkg):
    """An op whose BLOCK attr holds a block whose op's int ``sub_block``
    names a third block that points back (a cycle)."""
    program = jpt.Program() if pkg == "jax" else tir.Program()
    gb = program.global_block()
    b1 = (program.create_block() if pkg == "jax"
          else _add_block(program, 0))
    if pkg == "jax":
        program.rollback()
    b2 = program.create_block() if pkg == "jax" else _add_block(program, 0)
    if pkg == "jax":
        program.rollback()
    b1.ops.append(_op(pkg, b1, "scale", {"X": ["a", "b"]}, {"Out": ["c"]},
                      {"sub_block": b2.idx}))
    b2.ops.append(_op(pkg, b2, "scale", {"X": ["d"]}, {"Out": ["e"]},
                      {"block": b1}))
    top = _op(pkg, gb, "while", {"X": ["x"]}, {"Out": ["y"]},
              {"body": b1, "flag": True, "sub_block": 7})
    return top, program


def _add_block(program, parent):
    blk = tir.Block(program, len(program.blocks), parent)
    program.blocks.append(blk)
    return blk


def _op(pkg, block, type_, inputs, outputs, attrs):
    cls = jpt.core.ir.Operator if pkg == "jax" else tir.Operator
    return cls(block, type_, inputs, outputs, attrs)


def test_sub_block_read_names_match_jax():
    from paddle_tpu.core import ir as jir
    jtop, jprog = _nested("jax")
    ttop, tprog = _nested("port")
    want = jir.sub_block_read_names(jtop, jprog)
    got = tir.sub_block_read_names(ttop, tprog)
    assert got == want == {"a", "b", "d"}
