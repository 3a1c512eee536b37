"""The kernels' build keys (``paddle_tpu_torch/kernels/_build.py``): a
library's file name carries a hash of its source, of every shared
``csrc/*.cuh`` header and of the flags, so that an edited header
rebuilds every library that may include it. CPU only: nothing is
compiled.
"""
import os
import shutil

import pytest

from paddle_tpu_torch.kernels import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, dst)
    monkeypatch.setattr(_build, "CSRC_DIR", str(dst))
    return dst


def _paths():
    return {name: _build.library_path(name) for name in _build.sources()}


def _reached_headers(name):
    """The shared headers ``csrc/<name>.cu`` includes, directly or through
    another header."""
    seen, todo = set(), [name + ".cu"]
    while todo:
        with open(os.path.join(_build.CSRC_DIR, todo.pop())) as f:
            for line in f:
                if line.startswith('#include "'):
                    header = line.split('"')[1]
                    if header not in seen:
                        seen.add(header)
                        todo.append(header)
    return seen


def test_the_kernels_share_the_3xtf32_header():
    assert {"tf32x3.cuh", "recurrence.cuh"} <= set(_build.headers())
    for name in ("flash_attention_fwd", "flash_attention_bwd", "matmul",
                 "fused_gru", "fused_lstm"):
        assert "tf32x3.cuh" in _reached_headers(name), name
    # the two recurrences share their step's helpers
    for name in ("fused_gru", "fused_lstm"):
        assert "recurrence.cuh" in _reached_headers(name), name


def test_library_paths_follow_the_source_and_flags(csrc_copy):
    before = _paths()
    assert before == _paths()  # the key is a pure function of the files
    assert len(set(before.values())) == len(before)
    with open(csrc_copy / "matmul.cu", "a") as f:
        f.write("\n// edited\n")
    after = _paths()
    assert after["matmul"] != before["matmul"]
    assert {n: p for n, p in after.items() if n != "matmul"} == \
        {n: p for n, p in before.items() if n != "matmul"}


def test_editing_a_header_changes_every_library_path(csrc_copy):
    before = _paths()
    with open(csrc_copy / "tf32x3.cuh", "a") as f:
        f.write("\n// edited\n")
    after = _paths()
    assert set(after) == set(before)
    assert all(after[n] != before[n] for n in before)


def test_adding_a_header_changes_every_library_path(csrc_copy):
    before = _paths()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    after = _paths()
    assert all(after[n] != before[n] for n in before)
