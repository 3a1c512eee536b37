"""The port's program verifier (``paddle_tpu_torch.analysis``) against the
JAX package's (``paddle_tpu.analysis``).

Every defect program of ``tests/test_analysis.py`` (PT001-PT017) is built
alike in both packages and verified by both: the findings must agree in
(code, severity, block, op, var) and render to the same text; a shape
failure is a ``concat`` on an axis out of range, as in the JAX test.
Then: no diagnostic on the port's configs and the tiny
LM; the Executor's verify hook (flag, environment, once per program
version); ``append_backward``'s post-pass; ``calc_gradient`` against the
JAX package's on a non-parameter input.
"""
import types
import warnings

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import analysis as janalysis
from paddle_tpu import layers as jlayers
from paddle_tpu.core import ir as jir
from paddle_tpu_torch import analysis as tanalysis
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.flags import flags_guard as tflags_guard

import torch_book

JAX = types.SimpleNamespace(
    name="jax", ir=jir, analysis=janalysis, layers=jlayers,
    Program=jpt.Program, program_guard=jpt.program_guard,
    append_backward=jpt.append_backward, calc_gradient=jpt.calc_gradient)
PORT = types.SimpleNamespace(
    name="port", ir=tir, analysis=tanalysis, layers=tlayers,
    Program=tir.Program, program_guard=tir.program_guard,
    append_backward=__import__("paddle_tpu_torch").append_backward,
    calc_gradient=__import__("paddle_tpu_torch").calc_gradient)

def _bad_concat(blk, out):
    """A ``concat`` whose shape inference raises (axis 5 of 2-D inputs),
    as ``tests/test_analysis.py:224`` makes it."""
    a = blk.create_var(name="a", shape=(2, 3), dtype="float32")
    b = blk.create_var(name="b", shape=(2, 3), dtype="float32")
    blk.append_op("concat", inputs={"X": [a, b]}, outputs={"Out": out},
                  attrs={"axis": 5})


def codes(diags):
    return sorted({d.code for d in diags})


def _var(blk, name, shape=(2, 3), dtype="float32"):
    return blk.create_var(name=name, shape=shape, dtype=dtype)


def _fresh(P):
    prog = P.Program()
    return prog, prog.global_block()


# ---------------------------------------------------------------------------
# the defect programs: builder(P) -> (program, verify kwargs)


def d_pt001(P):
    prog, blk = _fresh(P)
    _var(blk, "a")
    out = _var(blk, "out")
    blk.append_op("elementwise_add", inputs={"X": "a", "Y": "ghost"},
                  outputs={"Out": out})
    return prog, {"rules": ["PT001"]}


def _use_before_def(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    mid = _var(blk, "mid")
    out = _var(blk, "out")
    blk.append_op("elementwise_add", inputs={"X": a, "Y": mid},
                  outputs={"Out": out})
    blk.append_op("scale", inputs={"X": a}, outputs={"Out": mid},
                  attrs={"scale": 2.0})
    return prog


def d_pt002(P):
    return _use_before_def(P), {"rules": ["PT002"]}


def d_pt002_all_rules(P):
    return _use_before_def(P), {}


def d_pt003(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    out = _var(blk, "out")
    blk.append_op("definitely_not_an_op", inputs={"X": a},
                  outputs={"Out": out})
    return prog, {"rules": ["PT003"]}


def d_pt004(P):
    prog, blk = _fresh(P)
    _bad_concat(blk, blk.create_var(name="out", dtype="float32"))
    return prog, {"rules": ["PT004"]}


def d_pt005(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a", shape=(4, 8))
    out = blk.create_var(name="out", dtype="float32")
    blk.append_op("scale", inputs={"X": a}, outputs={"Out": out},
                  attrs={"scale": 1.0})
    assert P.analysis.verify(prog) == []
    out.shape = (99, 99)  # the stale annotation a broken pass would leave
    return prog, {"rules": ["PT005"]}


def _fill(blk, out, value):
    blk.append_op("fill_constant", outputs={"Out": out},
                  attrs={"shape": [2, 3], "value": value,
                         "dtype": "float32"})


def d_pt006(P):
    prog, blk = _fresh(P)
    out = _var(blk, "out")
    _fill(blk, out, 0.0)
    _fill(blk, out, 1.0)
    return prog, {"rules": ["PT006"]}


def d_pt006_read_between(P):
    prog, blk = _fresh(P)
    out = _var(blk, "out")
    other = _var(blk, "other")
    _fill(blk, out, 0.0)
    blk.append_op("scale", inputs={"X": out}, outputs={"Out": other},
                  attrs={"scale": 1.0})
    _fill(blk, out, 1.0)
    return prog, {"rules": ["PT006"]}


def d_pt006_sub_block_read(P):
    prog = P.Program()
    blk = prog.global_block()
    x = _var(blk, "x")
    sub = prog.create_block()
    sub_out = sub.create_var(name="sub_out", shape=(2, 3), dtype="float32")
    _fill(blk, x, 0.0)
    sub.append_op("scale", inputs={"X": x}, outputs={"Out": sub_out},
                  attrs={"scale": 1.0})
    cond = _var(blk, "cond")
    blk.append_op("fill_constant", outputs={"Out": cond},
                  attrs={"shape": [1], "value": 1.0, "dtype": "float32"})
    blk.append_op("while", inputs={"Cond": cond}, outputs={"Out": sub_out},
                  attrs={"sub_block": sub.idx})
    _fill(blk, x, 1.0)
    return prog, {"rules": ["PT006"]}


def d_self_referential_sub_block(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    out = _var(blk, "out")
    blk.append_op("scale", inputs={"X": a}, outputs={"Out": out},
                  attrs={"scale": 1.0, "sub_block": 0})
    return prog, {"fetches": ["out"]}


def d_pt007(P):
    prog, blk = _fresh(P)
    _var(blk, "x@GRAD")
    return prog, {"rules": ["PT007"]}


def d_pt008(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    out = _var(blk, "out")
    _var(blk, "never_touched")
    blk.append_op("scale", inputs={"X": a}, outputs={"Out": out},
                  attrs={"scale": 1.0})
    return prog, {"rules": ["PT008"]}


def d_pt009(P):
    prog, blk = _fresh(P)
    blk.create_parameter(name="w_unused", shape=[4, 4], dtype="float32")
    return prog, {"rules": ["PT009"]}


def d_pt010_index(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    blk.append_op("while", inputs={"Cond": a}, outputs={},
                  attrs={"sub_block": 99})
    return prog, {"rules": ["PT010"]}


def d_pt010_cycle(P):
    prog = P.Program()
    b1 = prog.create_block()
    b1.parent_idx = 1  # self-cycle
    return prog, {"rules": ["PT010"]}


def _sharded(P, spec):
    prog, blk = _fresh(P)
    a = _var(blk, "a", shape=(4, 8))
    out = _var(blk, "out")
    blk.append_op("scale", inputs={"X": a}, outputs={"Out": out},
                  attrs={"scale": 1.0})
    prog._shardings = dict(spec)
    return prog, {"rules": ["PT011"]}


def d_pt011_missing(P):
    return _sharded(P, {"nonexistent": ("dp",)})


def d_pt011_rank(P):
    return _sharded(P, {"a": ("dp", None, "tp")})


def d_pt011_fine(P):
    return _sharded(P, {"a": ("dp",)})


def d_pt012(P):
    prog, blk = _fresh(P)
    blk.create_var(name="v", shape=[2, 3], dtype="float32")
    with pytest.warns(RuntimeWarning, match="create_var"):
        v = blk.create_var(name="v", shape=[4, 5], dtype="float32")
    assert tuple(v.shape) == (2, 3)  # the existing var, unchanged
    with pytest.warns(RuntimeWarning, match="dtype"):
        blk.create_var(name="v", dtype="int64")
    return prog, {"rules": ["PT012"]}


def d_pt013(P):
    prog, blk = _fresh(P)
    for i in range(P.ir.SHAPE_INFER_FAILURE_CAP + 10):
        _bad_concat(blk, blk.create_var(name="out%d" % i, dtype="float32"))
    assert len(prog._shape_infer_failures) == P.ir.SHAPE_INFER_FAILURE_CAP
    assert prog._shape_infer_dropped == 10
    return prog, {"rules": ["PT013"]}


def _dead_op_prog(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    used = _var(blk, "used")
    stray = _var(blk, "stray")
    blk.append_op("scale", inputs={"X": a}, outputs={"Out": used},
                  attrs={"scale": 1.0})
    blk.append_op("scale", inputs={"X": a}, outputs={"Out": stray},
                  attrs={"scale": 3.0})
    return prog


def d_pt014(P):
    return _dead_op_prog(P), {"fetches": ["used"], "rules": ["PT014"]}


def d_pt014_no_fetches(P):
    return _dead_op_prog(P), {"rules": ["PT014"]}


def d_pt015(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    b = _var(blk, "b", dtype="bfloat16")
    out = _var(blk, "out")
    blk.append_op("elementwise_add", inputs={"X": a, "Y": b},
                  outputs={"Out": out})
    return prog, {"rules": ["PT015"]}


def d_pt015_cast(P):
    prog, blk = _fresh(P)
    a = _var(blk, "a")
    b = _var(blk, "b", dtype="bfloat16")
    b32 = _var(blk, "b32")
    out = _var(blk, "out")
    blk.append_op("cast", inputs={"X": b}, outputs={"Out": b32},
                  attrs={"out_dtype": "float32"})
    blk.append_op("elementwise_add", inputs={"X": a, "Y": b32},
                  outputs={"Out": out})
    return prog, {"rules": ["PT015"]}


def d_pt015_sgd(P):
    prog, blk = _fresh(P)
    p = blk.create_parameter(name="w", shape=(4,), dtype="float32")
    g = _var(blk, "w@GRAD", shape=(4,), dtype="bfloat16")
    lr = _var(blk, "lr", shape=(1,))
    blk.append_op("sgd", inputs={"Param": p, "Grad": g, "LearningRate": lr},
                  outputs={"ParamOut": p})
    return prog, {"rules": ["PT015"]}


def _seq_pool_prog(P, level):
    prog, blk = _fresh(P)
    x = blk.create_var(name="x", shape=(6, 4), dtype="float32",
                       lod_level=level)
    out = _var(blk, "out", shape=(2, 4))
    blk.append_op("sequence_pool", inputs={"X": x}, outputs={"Out": out},
                  attrs={"pooltype": "SUM"})
    return prog, {"rules": ["PT016"]}


def d_pt016(P):
    return _seq_pool_prog(P, 0)


def d_pt016_declared(P):
    return _seq_pool_prog(P, 1)


def d_pt016_chain_break(P):
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        words = P.layers.data(name="w", shape=[1], dtype="int64",
                              lod_level=1)
        emb = P.layers.embedding(words, size=[50, 8], dtype="float32")
        pooled = P.layers.sequence_pool(emb, pool_type="max")
        blk = main.global_block()
        out = blk.create_var(name="softmax_out", shape=pooled.shape,
                             dtype="float32")
        # sequence_softmax, its layer unported: the op appended as the
        # JAX layer appends it
        blk.append_op("sequence_softmax", inputs={"X": [pooled]},
                      outputs={"Out": [out]})
    return main, {"rules": ["PT016"]}


def _staged(P):
    prog, blk = _fresh(P)
    for n in ("x", "h1", "h2", "out"):
        _var(blk, n)
    for a, b in (("x", "h1"), ("h1", "h2"), ("h2", "out")):
        blk.append_op("scale", inputs={"X": a}, outputs={"Out": b},
                      attrs={"scale": 1.0})
    return prog, blk


def d_pt017_clean(P):
    prog, _ = _staged(P)
    P.analysis.mark_pipeline_stages(prog, [(0, 1), (1, 2), (2, 3)])
    return prog, {"rules": ["PT017"]}


def d_pt017_back_edge(P):
    prog, blk = _staged(P)
    blk.ops[0].inputs["Y"] = ["h2"]
    blk.ops[0].type = "elementwise_add"
    P.analysis.mark_pipeline_stages(prog, [(0, 1), (1, 3)])
    return prog, {"rules": ["PT017"]}


def d_pt017_gap(P):
    prog, _ = _staged(P)
    P.analysis.mark_pipeline_stages(prog, [(0, 1), (2, 3)])
    return prog, {"rules": ["PT017"]}


def d_pt017_trailing(P):
    prog, _ = _staged(P)
    P.analysis.mark_pipeline_stages(prog, [(0, 2)])
    return prog, {"rules": ["PT017"]}


def d_pt017_skip(P):
    prog, blk = _staged(P)
    out2 = _var(blk, "out2")
    blk.append_op("elementwise_add", inputs={"X": "out", "Y": "h1"},
                  outputs={"Out": out2})
    P.analysis.mark_pipeline_stages(prog, [(0, 1), (1, 2), (2, 4)])
    return prog, {"rules": ["PT017"]}


def d_pt017_inert(P):
    prog, _ = _staged(P)
    return prog, {"rules": ["PT017"]}


# defect -> the codes both packages must report (empty: a clean program)
DEFECTS = {
    "pt001": (d_pt001, ["PT001"]),
    "pt002": (d_pt002, ["PT002"]),
    "pt002_all_rules": (d_pt002_all_rules, ["PT002"]),
    "pt003": (d_pt003, ["PT003"]),
    "pt004": (d_pt004, ["PT004"]),
    "pt005": (d_pt005, ["PT005"]),
    "pt006": (d_pt006, ["PT006"]),
    "pt006_read_between": (d_pt006_read_between, []),
    "pt006_sub_block_read": (d_pt006_sub_block_read, []),
    "self_referential_sub_block": (d_self_referential_sub_block, None),
    "pt007": (d_pt007, ["PT007"]),
    "pt008": (d_pt008, ["PT008"]),
    "pt009": (d_pt009, ["PT009"]),
    "pt010_index": (d_pt010_index, ["PT010"]),
    "pt010_cycle": (d_pt010_cycle, ["PT010"]),
    "pt011_missing": (d_pt011_missing, ["PT011"]),
    "pt011_rank": (d_pt011_rank, ["PT011"]),
    "pt011_fine": (d_pt011_fine, []),
    "pt012": (d_pt012, ["PT012"]),
    "pt013": (d_pt013, ["PT013"]),
    "pt014": (d_pt014, ["PT014"]),
    "pt014_no_fetches": (d_pt014_no_fetches, []),
    "pt015": (d_pt015, ["PT015"]),
    "pt015_cast": (d_pt015_cast, []),
    "pt015_sgd": (d_pt015_sgd, []),
    "pt016": (d_pt016, ["PT016"]),
    "pt016_declared": (d_pt016_declared, []),
    "pt016_chain_break": (d_pt016_chain_break, ["PT016"]),
    "pt017_clean": (d_pt017_clean, []),
    "pt017_back_edge": (d_pt017_back_edge, ["PT017"]),
    "pt017_gap": (d_pt017_gap, ["PT017"]),
    "pt017_trailing": (d_pt017_trailing, ["PT017"]),
    "pt017_skip": (d_pt017_skip, ["PT017"]),
    "pt017_inert": (d_pt017_inert, []),
}


def _findings(diags):
    return [(d.code, d.severity, d.block_idx, d.op_idx, d.var, d.message,
             d.hint) for d in diags]


@pytest.mark.parametrize("name", sorted(DEFECTS))
def test_defect_diagnostics_match_the_jax_package(name):
    build, want = DEFECTS[name]
    got = {}
    for P in (JAX, PORT):
        prog, kw = build(P)
        got[P.name] = P.analysis.verify(prog, **kw)
    j, t = got["jax"], got["port"]
    assert _findings(t) == _findings(j)
    assert tanalysis.render_diagnostics(t) == \
        janalysis.render_diagnostics(j)
    if want is None:
        assert "PT010" in codes(t)
    else:
        assert codes(t) == want


def test_pt002_strict_raises_in_both():
    for P in (JAX, PORT):
        with pytest.raises(P.analysis.ProgramVerifyError):
            P.analysis.verify(_use_before_def(P), strict=True)


def test_every_code_has_one_rule_as_in_the_jax_package():
    def emitted(a):
        return sorted(c for cls in a.registered_rules()
                      for c in getattr(cls, "emits", (cls.code,)))
    assert emitted(tanalysis) == emitted(janalysis)
    assert len(set(emitted(tanalysis))) == len(emitted(tanalysis)) == 17


def test_rule_selection_and_render_shape():
    from paddle_tpu_torch.analysis.rules import UnregisteredOpRule
    prog, blk = _fresh(PORT)
    a = _var(blk, "a")
    blk.append_op("bogus_op", inputs={"X": a}, outputs={})
    for sel in (["PT003"], ["unregistered-op"], [UnregisteredOpRule],
                [UnregisteredOpRule()]):
        assert codes(tanalysis.verify(prog, rules=sel)) == ["PT003"]
    with pytest.raises(ValueError):
        tanalysis.verify(prog, rules=["PT999"])
    args = [("PT001", "error", "boom", 0, 3, "x", "fix it"),
            ("PT006", "warning", "meh", None, None, None, None)]
    for pkg in (tanalysis, janalysis):
        ds = [pkg.Diagnostic(c, s, m, block_idx=b, op_idx=o, var=v, hint=h)
              for c, s, m, b, o, v, h in args]
        text = pkg.render_diagnostics(ds[::-1])
        assert text.index("PT001") < text.index("PT006")
        err = pkg.ProgramVerifyError(ds, context="unit-test")
        assert "unit-test" in str(err) and len(err.errors) == 1
    assert str(tanalysis.ProgramVerifyError(ds)) == \
        str(janalysis.ProgramVerifyError(
            [janalysis.Diagnostic(c, s, m, block_idx=b, op_idx=o, var=v,
                                  hint=h) for c, s, m, b, o, v, h in args]))


def test_create_var_without_conflict_and_numel():
    prog, blk = _fresh(PORT)
    blk.create_var(name="v", shape=[-1, 3], dtype="float32")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        blk.create_var(name="v", shape=[16, 3], dtype="float32")
        blk.create_var(name="v")
    assert not getattr(prog, "_var_def_conflicts", [])
    assert blk.create_var(name="s", shape=[4, -1, 3]).numel() == 12
    assert blk.create_var(name="u").numel() is None


def test_debug_shapes_warns_at_the_failing_op(monkeypatch):
    prog, blk = _fresh(PORT)
    out = blk.create_var(name="out", dtype="float32")
    with tflags_guard(debug_shapes=True):
        with pytest.warns(RuntimeWarning, match="shape inference failed"):
            _bad_concat(blk, out)
    monkeypatch.setenv("PADDLE_TPU_DEBUG_SHAPES", "1")
    with pytest.warns(RuntimeWarning, match="shape inference failed"):
        _bad_concat(blk, out)


# ---------------------------------------------------------------------------
# no false positives


@pytest.mark.parametrize("kind", torch_book.KINDS)
def test_configs_verify_clean_like_the_jax_package(kind):
    """Every port config (the tiny LM among them) and its JAX twin,
    training step built: no diagnostic in either, on the main and the
    startup program. One deliberate difference (ROADMAP.md Queue 3 #23):
    the JAX package's ``fc`` drops its input's lod_level at the mul, so
    its verifier reports PT016 on the lstm that reads the fc (a false
    positive of the reference, pinned here); the port's keeps it. The
    same holds for the stacked-LSTM sentiment net. The semantic role
    tagger's ``sums`` declare no lod_level in either package, so both
    verifiers report PT016 on each lstm that reads one (a false positive
    of the reference that the port mirrors op for op, pinned here)."""
    for pkg, a in (("port", tanalysis), ("jax", janalysis)):
        main, start, spec = torch_book.build(pkg, kind)
        diags = a.verify(main)
        if pkg == "jax" and kind == "text_rnn":
            assert [(d.code, d.op_idx, d.var) for d in diags] == [
                ("PT016", 3, "fc_0.tmp_1"), ("PT016", 6, "fc_1.tmp_1"),
                ("PT016", 7, "lstm_1.tmp_0")]
            diags = []
        if pkg == "jax" and kind == "understand_sentiment_lstm":
            assert [(d.code, d.op_idx, d.var) for d in diags] == [
                ("PT016", 3, "fc_0.tmp_1"), ("PT016", 8, "fc_1.tmp_3"),
                ("PT016", 13, "fc_2.tmp_3"), ("PT016", 14, "fc_2.tmp_3"),
                ("PT016", 15, "lstm_2.tmp_0")]
            diags = []
        if kind == "label_semantic_roles":
            assert [(d.code, d.op_idx, d.var) for d in diags] == [
                ("PT016", 25 + 6 * i, "sum_%d.tmp_0" % i) for i in range(4)]
            diags = []
        assert diags == [], "%s %s: %s" % (pkg, kind,
                                           a.render_diagnostics(diags))
        diags = a.verify(start)
        assert diags == [], "%s %s startup: %s" % (
            pkg, kind, a.render_diagnostics(diags))
        if pkg == "port":
            fetches = [spec["cost"]] + list(spec.get("metrics", ()))
            errors = [d.code for d in a.verify(main, fetches=fetches)
                      if d.is_error]
            assert errors == (["PT016"] * 4 if kind == "label_semantic_roles"
                              else []), errors


def _nmt_decode(pkg):
    from paddle_tpu_torch.models import machine_translation as tmt
    return list(tmt.nmt_decode(pkg.layers, pkg.ParamAttr))


@pytest.mark.parametrize("kind", torch_book.CF_KINDS + ("nmt_decode",))
def test_control_flow_programs_verify_like_the_jax_package(kind):
    """The two DynamicRNN book models' training steps and the beam-search
    decode (a While whose body the verifier walks): the port reports what
    the JAX package reports, but the PT016 the JAX package's ``fc`` gives
    an lstm that reads it (Queue 3 #23, above). Both report PT016 on the
    ``concat`` of the two encoder directions and on the decode's read of
    the scores array (neither declares a lod_level), and PT006 on the
    DynamicRNN's condition, which the block writes after a read: false
    positives of the reference, mirrored and pinned here. The startups
    verify clean."""
    from torch_optim import PKGS, build
    got = {}
    for p in PKGS:
        a = tanalysis if p.name == "port" else janalysis
        if kind == "nmt_decode":
            main, start, _ = build(p, _nmt_decode)
        else:
            main, start, _ = torch_book.build(p.name, kind)
        got[p.name] = [(d.code, d.op_idx, d.var, str(d.severity))
                       for d in a.verify(main)]
        assert a.verify(start) == []
    fc_reads = {"rnn_encoder_decoder": ["fc_0.tmp_0", "fc_1.tmp_0"]}.get(
        kind, ["fc_0.tmp_2", "lstm_0.tmp_0"])
    want = [d for d in got["jax"]
            if not (d[0] == "PT016" and d[2] in fc_reads)]
    assert got["port"] == want
    assert {d[0] for d in want} <= {"PT016", "PT006"}


def test_tiny_lm_deepcopies_so_shapes_repropagate():
    """PT004/PT005 re-run shape inference on a deep copy: a program
    that does not deep-copy would turn both into an INFO line."""
    main, _, _ = torch_book.build("port", "tiny_lm")
    diags = tanalysis.verify(main, rules=["PT004"])
    assert not [d for d in diags if d.severity == "info"]


# ---------------------------------------------------------------------------
# the Executor's verify hook


def test_verify_hook_via_flag():
    exe = TExecutor("cpu")
    with tflags_guard(verify=True):
        with pytest.raises(tanalysis.ProgramVerifyError) as ei:
            exe.run(_use_before_def(PORT),
                    feed={"a": np.zeros((2, 3), np.float32)},
                    fetch_list=["out"])
    assert "PT002" in str(ei.value) and "pre-run verify" in str(ei.value)
    assert exe.stats["jit_runs"] == exe.stats["eager_runs"] == 0


def test_verify_hook_via_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VERIFY", "1")
    with pytest.raises(tanalysis.ProgramVerifyError):
        TExecutor("cpu").run(_use_before_def(PORT),
                             feed={"a": np.zeros((2, 3), np.float32)},
                             fetch_list=["out"])


def test_verify_hook_off_by_default():
    # without the hook the lowering meets the unset name itself
    with pytest.raises(KeyError):
        TExecutor("cpu").run(_use_before_def(PORT),
                             feed={"a": np.zeros((2, 3), np.float32)},
                             fetch_list=["out"], use_jit=False)


def test_verify_hook_passes_clean_program_once(monkeypatch):
    from paddle_tpu_torch.analysis import runner
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        x = tlayers.data("x", shape=[4], dtype="float32")
        out = tlayers.scale(x, scale=2.0)
    exe = TExecutor("cpu")
    calls = []
    real = runner.verify

    def counting(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(runner, "verify", counting)
    with tflags_guard(verify=True):
        exe.run(startup)
        for _ in range(3):
            got, = exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                           fetch_list=[out])
    np.testing.assert_allclose(np.asarray(got), 2 * np.ones((2, 4)))
    assert (main._uid, main._version) in exe._verified
    assert calls.count(main) == 1


# ---------------------------------------------------------------------------
# append_backward's post-pass and calc_gradient


def _regression(P):
    x = P.layers.data(name="x", shape=[4], dtype="float32")
    y = P.layers.data(name="y", shape=[1], dtype="float32")
    pred = P.layers.fc(input=x, size=1, act=None)
    return P.layers.mean(P.layers.square_error_cost(input=pred, label=y))


@pytest.mark.parametrize("orphan", [True, False])
def test_append_backward_post_pass(orphan):
    for P in (JAX, PORT):
        main, startup = P.Program(), P.Program()
        with P.program_guard(main, startup):
            cost = _regression(P)
            if orphan:
                main.global_block().create_var(name="nobody@GRAD",
                                               shape=(2,), dtype="float32")
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                P.append_backward(cost)
        msgs = [str(r.message) for r in rec if "PT007" in str(r.message)]
        if orphan:
            assert len(msgs) == 1 and "orphan" in msgs[0]
        else:
            assert msgs == []


def test_append_backward_post_pass_raises_on_broken_dataflow():
    main, startup = tir.Program(), tir.Program()
    with tir.program_guard(main, startup):
        cost = _regression(PORT)
        blk = main.global_block()
        blk.append_op("scale", inputs={"X": "ghost"},
                      outputs={"Out": blk.create_var(name="junk")},
                      attrs={"scale": 1.0})
        with pytest.raises(tanalysis.ProgramVerifyError,
                           match="after pass 'append_backward'"):
            PORT.append_backward(cost)


def _calc_gradient_run(P):
    """d mean(tanh(fc(x)) * x) / dx for a fed, non-parameter x, with one
    parameter set shared through numpy."""
    rng = np.random.RandomState(0)
    xv = rng.randn(3, 5).astype(np.float32)
    wv = rng.randn(5, 5).astype(np.float32)
    bv = rng.randn(5).astype(np.float32)
    main, startup = P.Program(), P.Program()
    with P.program_guard(main, startup):
        x = P.layers.data(name="x", shape=[5], dtype="float32")
        x.stop_gradient = False
        h = P.layers.fc(input=x, size=5, act="tanh",
                        param_attr="cg_w", bias_attr="cg_b")
        loss = P.layers.mean(P.layers.elementwise_mul(h, x))
        grads = P.calc_gradient(loss, [x])
    assert grads[0] is not None and grads[0].name == "x@GRAD"
    if P is JAX:
        scope = jpt.Scope()
        exe = jpt.Executor(jpt.CPUPlace())
        with jpt.scope_guard(scope):
            exe.run(startup)
            scope.set_var("cg_w", wv)
            scope.set_var("cg_b", bv)
            g, = exe.run(main, feed={"x": xv}, fetch_list=[grads[0]])
    else:
        import torch
        from paddle_tpu_torch.core.scope import Scope
        scope = Scope()
        exe = TExecutor("cpu")
        exe.run(startup, scope=scope)
        scope.set_var("cg_w", torch.from_numpy(wv))
        scope.set_var("cg_b", torch.from_numpy(bv))
        g, = exe.run(main, feed={"x": xv}, fetch_list=[grads[0]],
                     scope=scope)
    return np.asarray(g)


def test_calc_gradient_matches_the_jax_package():
    want = _calc_gradient_run(JAX)
    got = _calc_gradient_run(PORT)
    assert got.shape == want.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
