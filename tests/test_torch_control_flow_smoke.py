"""``chip_smoke.py`` phase 20's helpers rehearsed on the CPU at narrow
widths (the card runs them at the book's): the control flow op sweep
(every op of the slice and its grad, each case's program and feed, the
CPU against itself), the decode check (the beam-search translator from
a seeded state, its spy on ``beam_search``, the edge gaps and the path
``DECODE_PATH``), and the edge gaps of a hand-made candidate list."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke as smoke  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setattr(smoke, "CF_WIDTH", 16)
    monkeypatch.setattr(smoke, "CF_LENGTHS", (1, 5, 5, 3, 4, 2))
    for k, v in dict(dict_size=300, word_dim=16, hidden=16, batch=8,
                     min_len=3, max_len=8).items():
        monkeypatch.setitem(smoke.ENCDEC_BOOK, k, v)
    for k, v in dict(sources=4, max_length=6).items():
        monkeypatch.setitem(smoke.DECODE_BOOK, k, v)
    monkeypatch.setattr(smoke, "DECODE_RUNS", 2)
    monkeypatch.setattr(smoke, "_sync", lambda dev: None)


def test_the_op_sweep_covers_the_slice(narrow):
    per_op = smoke._control_flow_ops_check(CPU)
    from paddle_tpu_torch.core import registry
    slice_ops = [n for n in registry.registered_ops()
                 if registry.lookup(n).lower.__module__.endswith(
                     ".control_flow_ops")]
    assert len(slice_ops) == 24 and set(slice_ops) <= set(per_op)
    for rec in per_op.values():
        assert rec["max_rel_err"] == 0.0


def test_the_decode_check_runs_on_the_cpu(narrow):
    rec = smoke._decode_check(CPU, {})
    assert rec["steps"] == 6 and rec["diverged_at_step"] is None
    assert rec["sentences"] == 4 * smoke.DECODE_BOOK["beam_size"]
    assert rec["path"] == smoke.DECODE_PATH


def test_edge_gaps():
    scores = np.array([[0.5, 0.3, 0.1], [0.5 + 1e-7, 0.2, 0.1]], np.float32)
    gaps = smoke._edge_gaps(scores, np.array([4, 5]), [0, 2], 3, 1)
    assert len(gaps) == 1 and gaps[0] <= 1e-6
    # an ended prefix offers its first score alone: 0.5, 0.4, 0.2, 0.1
    scores[1, 0] = 0.4
    gaps = smoke._edge_gaps(scores, np.array([1, 5]), [0, 2], 3, 1)
    assert gaps[0] > 0.1
