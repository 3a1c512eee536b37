"""The port stands alone: nothing in ``paddle_tpu_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package, and importing every
module of the port leaves both out of ``sys.modules``. The tests that
run on the card (``tests/test_torch_*_cuda.py``) import neither either,
so that they collect where JAX is not installed."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "paddle_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module):
    return module.split(".")[0] in FORBIDDEN


def _forbidden_imports(files):
    """``path:line module`` of every import of JAX or the JAX package."""
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and \
                    getattr(node.func, "attr", getattr(node.func, "id", "")) \
                    in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            else:
                continue
            bad += ["%s:%d %s" % (os.path.relpath(path, ROOT), node.lineno,
                                  n) for n in names if _forbidden(n)]
    return bad


def test_no_source_file_of_the_port_imports_jax_or_paddle_tpu():
    files = _port_files()
    assert len(files) > 10
    bad = _forbidden_imports(files)
    assert not bad, bad


def test_no_card_test_imports_jax_or_paddle_tpu():
    files = sorted(glob.glob(os.path.join(ROOT, "tests",
                                          "test_torch_*_cuda.py")))
    assert len(files) >= 6
    bad = _forbidden_imports(files)
    assert not bad, bad


_PROBE = """
import importlib, json, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
import chip_smoke
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))))
"""


def test_importing_every_port_module_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


# Collects the card tests in a fresh interpreter where importing JAX or the
# JAX package fails, as on a machine without them. tests/conftest.py pins
# JAX's CPU platform at import, so it is left out (--noconftest): the card
# tests need none of its fixtures.
_CARD_PROBE = """
import glob, importlib.abc, os, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"):
            raise ImportError("no module named %s here" % name)
        return None
sys.meta_path.insert(0, _Block())
sys.path.insert(0, os.getcwd())
import pytest
sys.exit(pytest.main(["--noconftest", "-p", "no:cacheprovider",
                      "--collect-only", "-q", "-m", "cuda",
                      *sorted(glob.glob("tests/test_torch_*_cuda.py"))]))
"""


def test_card_tests_collect_without_jax():
    out = subprocess.run([sys.executable, "-c", _CARD_PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    items = [ln for ln in out.stdout.splitlines()
             if ln.startswith("tests/test_torch_") and "_cuda.py::" in ln]
    assert len(items) >= 30, out.stdout

