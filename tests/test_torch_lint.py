"""The port's ``lint`` verb (``python -m paddle_tpu_torch lint``) and
``debugger.py`` against the JAX package's, on the CPU: the exit codes
(0 clean or warnings only, 1 on an error or any finding under
``--strict``, 2 when the config fails to build), ``--dot`` with the
failing ops highlighted, ``--memory``'s residency table and its PT030,
and the passes that need a mesh (``--comm``, ``--sharding``, ``--spec``,
``--all``), which exit 2 naming where they wait.
"""
import os

import pytest

from paddle_tpu import debugger as jdebugger
from paddle_tpu.cli import main as jcli
from paddle_tpu.core import ir as jir
from paddle_tpu_torch import debugger as tdebugger
from paddle_tpu_torch.cli import main as tcli
from paddle_tpu_torch.core import ir as tir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "paddle_tpu_torch", "configs")

GOOD = ("import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import layers\n\n"
        "def model():\n"
        "    x = layers.data(name='x', shape=[8], dtype='float32')\n"
        "    y = layers.data(name='y', shape=[1], dtype='float32')\n"
        "    pred = layers.fc(input=x, size=1)\n"
        "    avg = layers.mean(layers.square_error_cost(pred, y))\n"
        "    return {'cost': avg, 'feed_list': [x, y], 'reader': None}\n")

BAD = ("from paddle_tpu_torch.core import ir\n\n"
       "def model():\n"
       "    blk = ir.default_main_program().global_block()\n"
       "    a = blk.create_var(name='a', shape=[2], dtype='float32')\n"
       "    mid = blk.create_var(name='mid', shape=[2], dtype='float32')\n"
       "    out = blk.create_var(name='out', shape=[2], dtype='float32')\n"
       "    blk.append_op('elementwise_add', inputs={'X': a, 'Y': mid},"
       " outputs={'Out': out})\n"
       "    blk.append_op('scale', inputs={'X': a}, outputs={'Out': mid},"
       " attrs={'scale': 2.0})\n"
       "    return {'cost': out, 'feed_list': [a], 'reader': None}\n")

WARNY = ("from paddle_tpu_torch import layers\n"
         "from paddle_tpu_torch.core import ir\n\n"
         "def model():\n"
         "    x = layers.data(name='x', shape=[8], dtype='float32')\n"
         "    out = layers.scale(x, scale=1.0)\n"
         "    blk = ir.default_main_program().global_block()\n"
         "    blk.create_var(name='dead_weight', shape=[2],"
         " dtype='float32')\n"
         "    return {'cost': out, 'feed_list': [x], 'reader': None}\n")


def _cfg(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_lint_exit_codes(tmp_path, capsys):
    good = _cfg(tmp_path, "good.py", GOOD)
    assert tcli(["lint", good]) == 0
    out = capsys.readouterr().out
    assert "main program: clean" in out and "startup program: clean" in out
    bad = _cfg(tmp_path, "bad.py", BAD)
    assert tcli(["lint", bad]) == 1
    assert "PT002 error [block0:op0 var 'mid']" in capsys.readouterr().out
    broken = _cfg(tmp_path, "broken.py",
                  "def model():\n    raise RuntimeError('nope')\n")
    assert tcli(["lint", broken]) == 2
    assert "failed to build: RuntimeError: nope" in capsys.readouterr().out


def test_lint_strict_fails_on_warnings(tmp_path, capsys):
    cfg = _cfg(tmp_path, "warny.py", WARNY)
    assert tcli(["lint", cfg]) == 0
    assert "PT008 warning" in capsys.readouterr().out
    assert tcli(["lint", cfg, "--strict"]) == 1


def test_lint_dot_highlights_the_failing_op(tmp_path, capsys):
    dot = str(tmp_path / "g.dot")
    assert tcli(["lint", _cfg(tmp_path, "bad.py", BAD), "--dot", dot]) == 1
    text = open(dot).read()
    assert "digraph" in text
    assert 'op_0 [label="elementwise_add", shape=ellipse, style=filled, ' \
        'fillcolor="#ff6188"]' in text
    assert 'op_1 [label="scale", shape=ellipse, style=filled, ' \
        'fillcolor="#a9dcdf"]' in text
    assert "(1 op(s) highlighted)" in capsys.readouterr().out
    assert tcli(["lint", _cfg(tmp_path, "good.py", GOOD), "--dot",
                 dot]) == 0


@pytest.mark.parametrize("flag", [["--comm"], ["--sharding"], ["--all"],
                                  ["--spec", "x=dp"]])
def test_lint_mesh_passes_exit_2(tmp_path, capsys, flag):
    assert tcli(["lint", _cfg(tmp_path, "good.py", GOOD)] + flag) == 2
    assert "Queue 1 item 6" in capsys.readouterr().out


def test_lint_memory_table_and_budget(capsys):
    cfg = os.path.join(CONFIGS, "fit_a_line.py")
    assert tcli(["lint", cfg, "--memory", "--budget-gb", "64"]) == 0
    out = capsys.readouterr().out
    assert "memory pass (train-step program)" in out
    assert "predicted per-device HBM residency (batch=16, dp=1)" in out
    rc = tcli(["lint", cfg, "--memory", "--budget-gb", "1e-7"])
    out = capsys.readouterr().out
    assert rc == 1 and "PT030" in out and "high-water op" in out
    assert tcli(["lint", cfg, "--memory", "--mesh", "dp=0"]) == 2


def test_lint_memory_table_matches_the_jax_package(capsys):
    """fit_a_line's config in both packages, its training step at batch
    32 over dp=2: the same residency table."""
    jcfg = os.path.join(ROOT, "examples", "configs", "fit_a_line.py")
    tcfg = os.path.join(CONFIGS, "fit_a_line.py")
    from paddle_tpu.core import unique_name as jun
    from paddle_tpu_torch.core import unique_name as tun
    tables = []
    for cli, cfg, un in ((jcli, jcfg, jun), (tcli, tcfg, tun)):
        with un.guard():  # the same var names in both
            assert cli(["lint", cfg, "--memory", "--batch", "32", "--mesh",
                         "dp=2"]) == 0
        out = capsys.readouterr().out
        tables.append(out[out.index("predicted per-device"):
                          out.index("main program:")])
    assert tables[0] == tables[1]


@pytest.mark.parametrize("cfg", sorted(
    f for f in os.listdir(CONFIGS) if f.endswith(".py") and f != "__init__.py"))
def test_every_port_config_lints_clean(cfg, capsys):
    assert tcli(["lint", os.path.join(CONFIGS, cfg), "--strict"]) == 0
    out = capsys.readouterr().out
    assert "main program: clean" in out


def _printer_program(ir_mod):
    prog = ir_mod.Program()
    blk = prog.global_block()
    blk.create_parameter(name="w", shape=[3, 4], dtype="float32")
    blk.create_var(name="x", shape=[-1, 3], dtype="float32")
    blk.create_var(name="h", shape=[-1, 4], dtype="float32")
    blk.create_var(name="h@GRAD", shape=[-1, 4], dtype="float32")
    blk.append_op("mul", inputs={"X": ["x"], "Y": ["w"]},
                  outputs={"Out": ["h"]},
                  attrs={"x_num_col_dims": 1, "y_num_col_dims": 1})
    blk.append_op("scale_grad", inputs={"X": ["h"]},
                  outputs={"Out": ["h@GRAD"]}, attrs={"scale": 0.5})
    return prog


def test_debugger_output_equals_the_jax_package(tmp_path):
    tp, jp = _printer_program(tir), _printer_program(jir)
    for show in (False, True):
        assert tdebugger.pprint_program_codes(tp, show) == \
            jdebugger.pprint_program_codes(jp, show)
    t = tdebugger.draw_block_graphviz(tp.global_block(), highlights={"h"},
                                      op_highlights={0},
                                      path=str(tmp_path / "t.dot"))
    j = jdebugger.draw_block_graphviz(jp.global_block(), highlights={"h"},
                                      op_highlights={0},
                                      path=str(tmp_path / "j.dot"))
    assert t == j and '#ff6188' in t and '#ffd866' in t
    assert open(str(tmp_path / "t.dot")).read() == t + "\n"
