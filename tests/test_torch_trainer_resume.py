"""The Trainer's checkpoints, preemption and ``test``
(``paddle_tpu_torch/trainer.py``) against the JAX package's
(``paddle_tpu/trainer.py:109-235``, ``:483-620``), on the CPU.

- Preempt and resume: tiny_lm and fit_a_line, preempted at batch 2 of 6
  by a real ``SIGTERM`` (``signal.raise_signal``, as
  ``tests/test_resilience.py`` delivers it) or by ``request_preempt``,
  synchronous and pipelined, then resumed by a new Trainer in a new
  scope on the same directory over batches 3-5: the losses equal the
  port's uninterrupted run bit for bit and the JAX package's own
  preempt-and-resume run within tolerance; one ``preempt_checkpoint``
  event with the pass and batch; the SIGTERM handler restored; a later
  ``train`` starts fresh.
- ``preempt_truncated`` under a zero grace window, durable in
  ``events.jsonl``.
- Newest-wins resume across the three layouts (a manifest checkpoint, a
  retention root, flat persistables), each as the JAX package resumes
  from the same directory.
- ``Trainer.test`` against the JAX package's on tiny_lm, resnet_cifar
  (``batch_norm`` on its running statistics) and recognize_digits_conv,
  synchronous and pipelined, between training calls.
- The book config recognize_digits_conv trains like the JAX one.
- ``python -m paddle_tpu_torch train --checkpoint_dir`` as a CPU
  subprocess: a SIGTERM after its first logged batch exits 0 with a
  checkpoint that loads.

Tolerance: losses within 1e-5 relative (float32 on both sides, sums in
other orders); within the port, exact.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.resilience import clear_events as jclear_events  # noqa: E402,E501
from paddle_tpu_torch import checkpoint, io  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope, global_scope,  # noqa: E402
                                         scope_guard, scope_to_numpy)
from paddle_tpu_torch.resilience import events  # noqa: E402
from paddle_tpu_torch.trainer import EndIteration  # noqa: E402

import torch_book as book  # noqa: E402

N_BATCHES = 6
PREEMPT_AT = 2


@pytest.fixture(autouse=True)
def _clean_events():
    events.clear_events()
    jclear_events()
    yield
    events.clear_events()


def _state(kind):
    jmain, jstart, _ = book.build("jax", kind)
    return book.jax_startup_state(jmain, jstart)


def _scope(pkg):
    return jpt.scope_guard(jpt.Scope()) if pkg == "jax" \
        else scope_guard(Scope())


def _persistables(pkg, tr):
    names = book.persist_names(tr.main_program)
    if pkg == "jax":
        return {n: np.asarray(jpt.global_scope().find_var(n)) for n in names}
    return scope_to_numpy(global_scope(), names)


def _end_iteration(pkg):
    return jpt.EndIteration if pkg == "jax" else EndIteration


def _run(pkg, kind, state, batches, ckpt=None, preempt=None,
         pipeline=False):
    """One Trainer in a fresh scope over ``batches``: from ``state``
    (None: resume from ``ckpt``); ``preempt`` ('signal' or 'request')
    at batch PREEMPT_AT. (losses, persistables, trainer)."""
    with _scope(pkg):
        tr, _ = book.make_trainer(pkg, kind, checkpoint_dir=ckpt)
        if state is not None:
            book.init_from(tr, pkg, state)
        losses = []

        def handler(e):
            if isinstance(e, _end_iteration(pkg)):
                losses.append(e.cost)
                if preempt and e.batch_id == PREEMPT_AT:
                    if preempt == "signal":
                        signal.raise_signal(signal.SIGTERM)
                    else:
                        tr.request_preempt()

        tr.train(book.reader_of(batches), num_passes=1,
                 event_handler=handler, pipeline=pipeline)
        return [float(c) for c in losses], _persistables(pkg, tr), tr


CASES = [("tiny_lm", "signal", False), ("tiny_lm", "request", False),
         ("fit_a_line", "signal", False), ("fit_a_line", "request", True),
         ("tiny_lm", "request", True)]


@pytest.mark.parametrize("kind,how,pipeline", CASES)
def test_preempt_and_resume_equals_the_uninterrupted_run(tmp_path, kind,
                                                         how, pipeline):
    state = _state(kind)
    batches = book.batches(kind, N_BATCHES)
    full, full_state, _ = _run("port", kind, state, batches,
                               pipeline=pipeline)
    ck = str(tmp_path / "port")
    old = signal.getsignal(signal.SIGTERM)
    first, _, tr = _run("port", kind, state, batches, ckpt=ck, preempt=how,
                        pipeline=pipeline)
    assert tr.preempted and len(first) == PREEMPT_AT + 1
    assert signal.getsignal(signal.SIGTERM) == old
    evs = events.events(kind="preempt_checkpoint")
    assert len(evs) == 1
    assert (evs[0]["pass_id"], evs[0]["batch_id"]) == (0, PREEMPT_AT)
    assert evs[0]["dirname"] == ck and os.listdir(ck)
    rest, rest_state, _ = _run("port", kind, None, batches[PREEMPT_AT + 1:],
                               ckpt=ck, pipeline=pipeline)
    assert first + rest == full
    for n, v in full_state.items():
        assert np.array_equal(rest_state[n], v), n
    # the JAX package's own preempt and resume
    jck = str(tmp_path / "jax")
    jfirst, _, _ = _run("jax", kind, state, batches, ckpt=jck, preempt=how,
                        pipeline=pipeline)
    jrest, jrest_state, _ = _run("jax", kind, None,
                                 batches[PREEMPT_AT + 1:], ckpt=jck,
                                 pipeline=pipeline)
    assert len(jfirst + jrest) == N_BATCHES
    assert book.loss_rel(first + rest, jfirst + jrest) <= book.REL_TOL
    for n, v in jrest_state.items():
        assert book.rel(rest_state[n], v) <= book.REL_TOL, n


def test_a_later_train_starts_fresh(tmp_path):
    state = _state("fit_a_line")
    batches = book.batches("fit_a_line", N_BATCHES)
    with scope_guard(Scope()):
        tr, _ = book.make_trainer("port", "fit_a_line",
                                  checkpoint_dir=str(tmp_path / "ck"))
        book.init_from(tr, "port", state)
        seen = []

        def handler(e):
            if isinstance(e, EndIteration):
                seen.append(e.batch_id)
                if e.batch_id == 1:
                    tr.request_preempt()

        tr.train(book.reader_of(batches), event_handler=handler,
                 pipeline=False)
        assert tr.preempted and seen == [0, 1]
        ran = []
        tr.train(book.reader_of(batches), num_passes=2,
                 event_handler=lambda e: ran.append(e), pipeline=False)
        assert not tr.preempted
        assert sum(isinstance(e, EndIteration) for e in ran) == \
            2 * N_BATCHES


def test_zero_grace_window_records_preempt_truncated(tmp_path, monkeypatch):
    state_dir = tmp_path / "state"
    monkeypatch.setenv("PADDLE_TPU_GRACE_SEC", "0")
    monkeypatch.setenv("PADDLE_TPU_ELASTIC_STATE", str(state_dir))
    ck = str(tmp_path / "ck")
    _, _, tr = _run("port", "fit_a_line", _state("fit_a_line"),
                    book.batches("fit_a_line", N_BATCHES), ckpt=ck,
                    preempt="signal")
    truncated = events.events(kind="preempt_truncated")
    assert len(truncated) == 1 and truncated[0]["phase"] == "pre"
    assert truncated[0]["batch_id"] == PREEMPT_AT
    assert truncated[0]["remaining_sec"] <= 0
    # durable: the line is on disk, strict JSON
    with open(os.path.join(str(state_dir), "events.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["kind"] for ln in lines] == ["preempt_truncated"]
    # the save is still made
    assert len(events.events(kind="preempt_checkpoint")) == 1
    assert os.listdir(ck)


def test_no_grace_window_records_nothing_truncated(tmp_path, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_GRACE_SEC", raising=False)
    _run("port", "fit_a_line", _state("fit_a_line"),
         book.batches("fit_a_line", N_BATCHES), ckpt=str(tmp_path / "ck"),
         preempt="request")
    assert events.events(kind="preempt_truncated") == []


def _set_state(pkg, state, scale):
    """Install ``state`` times ``scale`` in the current global scope."""
    for n, v in state.items():
        v = np.asarray(v * scale, dtype=v.dtype)
        if pkg == "jax":
            jpt.global_scope().set_var(n, v)
        else:
            global_scope().set_var(n, torch.from_numpy(v.copy()))


@pytest.mark.parametrize("layout", ["manifest", "retention_newer",
                                    "flat_newer"])
def test_newest_wins_resume_across_the_layouts(tmp_path, layout):
    """A manifest checkpoint in the directory itself wins; otherwise the
    newest of the retention root's entries and the flat persistables
    files. The JAX package resumes the same state from the directory."""
    kind = "fit_a_line"
    state = _state(kind)
    ck = str(tmp_path / "ck")
    with scope_guard(Scope()):
        tr, _ = book.make_trainer("port", kind, checkpoint_dir=ck)
        book.init_from(tr, "port", state)
        if layout == "manifest":
            _set_state("port", state, 2.0)
            tr.save_checkpoint(sharded=True, step=4)
            want = 2.0
        else:
            _set_state("port", state, 2.0)
            tr.save_checkpoint()  # flat files
            _set_state("port", state, 3.0)
            d = checkpoint.save_checkpoint(ck, tr.main_program, keep_last=2)
            old, new = (d, [os.path.join(ck, f) for f in os.listdir(ck)
                            if os.path.isfile(os.path.join(ck, f))])
            if layout == "retention_newer":
                old, new = new, [d]
                want = 3.0
            else:
                old = [d]
                want = 2.0
            for p in old:
                os.utime(p, (1e9, 1e9))
            for p in new:
                os.utime(p, (2e9, 2e9))
    for pkg in ("port", "jax"):
        with _scope(pkg):
            tr, _ = book.make_trainer(pkg, kind, checkpoint_dir=ck)
            tr._maybe_init()
            got = _persistables(pkg, tr)
        for n, v in state.items():
            assert np.array_equal(got[n], np.asarray(v * want, v.dtype)), \
                (pkg, n)


# -- Trainer.test ---------------------------------------------------------------

def _train_test(pkg, kind, state, pipeline):
    """Train 2 batches, test on 2, train 2 more, test again: the two
    test results and the training losses."""
    batches = book.batches(kind, 6)
    with _scope(pkg):
        tr, _ = book.make_trainer(pkg, kind)
        book.init_from(tr, pkg, state)
        losses = []

        def handler(e):
            if isinstance(e, _end_iteration(pkg)):
                losses.append(float(e.cost))

        tests = []
        for k in range(2):
            tr.train(book.reader_of(batches[2 * k:2 * k + 2]),
                     event_handler=handler, pipeline=False)
            tests.append(tr.test(book.reader_of(batches[4:6]),
                                 pipeline=pipeline))
        return tests, losses, tr


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("kind", ["tiny_lm", "resnet_cifar",
                                  "recognize_digits_conv"])
def test_trainer_test_matches_jax(kind, pipeline):
    state = _state(kind)
    got, losses, tr = _train_test("port", kind, state, pipeline)
    want, jlosses, _ = _train_test("jax", kind, state, pipeline)
    assert book.loss_rel(losses, jlosses) <= book.REL_TOL
    assert len(got[0]) == len(want[0]) == len(tr.fetch_list)
    for g, w in zip(got, want):
        assert book.loss_rel(g, w) <= book.REL_TOL
    # the second test saw the updated parameters
    assert got[0][0] != got[1][0]
    test_prog = tr._test_program(tr.fetch_list)
    types = [op.type for op in test_prog.global_block().ops]
    assert not any(t.endswith("_grad") for t in types)
    if kind == "resnet_cifar":
        assert all(op.attrs["is_test"] for op in test_prog.global_block().ops
                   if op.type == "batch_norm")
    # the test program is one compiled key: each test a warm-up or a
    # replay, and the trainer's two test calls hit the same program
    assert tr._test_program(tr.fetch_list) is test_prog
    if pipeline:
        assert tr.exe.stats["lazy_fetches"] > 0


def test_book_config_trains_like_jax():
    kind = "recognize_digits_conv"
    state = _state(kind)
    batches = book.batches(kind, 4)
    got, got_state, _ = _run("port", kind, state, batches)
    want, want_state, _ = _run("jax", kind, state, batches)
    assert len(got) == 4
    assert book.loss_rel(got, want) <= book.REL_TOL
    for n, v in want_state.items():
        assert book.rel(got_state[n], v) <= book.REL_TOL, n


def test_cli_sigterm_drains_and_saves(tmp_path):
    """``train --checkpoint_dir`` in a subprocess on the CPU: SIGTERM
    after the first logged batch exits 0, and the directory holds a
    checkpoint that loads into the config's program."""
    ck = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=book.ROOT)
    cfg = os.path.join(book.ROOT, "paddle_tpu_torch", "configs",
                       "text_rnn.py")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "train", cfg,
         "--device", "cpu", "--checkpoint_dir", ck, "--num_passes", "10000",
         "--log_period", "1"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert first.startswith("pass 0 batch 0 cost"), \
            first + proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "preempted at pass" in out and ck in out
    from paddle_tpu_torch.configs import text_rnn
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.optimizer import Adam
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        spec = text_rnn.model()
        Adam(learning_rate=0.002).minimize(spec["cost"])
    scope = Scope()
    with scope_guard(scope):
        exe = Executor("cpu")
        io.load_persistables(exe, ck, main)
    names = book.persist_names(main)
    got = scope_to_numpy(scope, names)
    assert sorted(got) == names
    assert all(np.isfinite(v).all() for v in got.values())
    assert float(got["beta1_pow_acc_0"].reshape(-1)[0]) < 0.9
