"""The control flow slice on the card, where the CPU tests cannot reach:

- every op of the slice and its grad on the card against the CPU on the
  same inputs (``chip_smoke._control_flow_ops_check`` at narrow widths:
  ids, offsets and selections bit-identical, floats within
  ``SEQ_OP_TOL``);
- the RNN encoder-decoder's training step (at narrow widths) captured
  once and replayed, each of its two encoder LSTMs launching row 7
  twice a step (its forward and the generic grad's replay of it), no
  eager run, its losses within 1e-6 relative of the per-op path's;
- a persistable counter that a captured step increments: it enters
  each replay as a tensor and counts on (no host value baked in);
- a While on fed data: the warm-up reads the condition back, warns, and
  the program runs per-op from its first run, as in the JAX package.

JAX-free, so that it runs where the card is.
"""
import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_*_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _smoke():
    return importlib.import_module("chip_smoke")


@pytest.mark.cuda
def test_every_op_and_grad_matches_the_cpu(cuda_device, monkeypatch):
    smoke = _smoke()
    monkeypatch.setattr(smoke, "CF_WIDTH", 64)
    monkeypatch.setattr(smoke, "CF_LENGTHS", (1, 7, 7, 3, 5, 2, 6, 4))
    per_op = smoke._control_flow_ops_check(cuda_device)
    for op in ("while", "while_grad", "recurrent", "beam_search",
               "beam_search_decode", "split_lod_tensor_grad",
               "conditional_block"):
        assert op in per_op, op
    for op, rec in per_op.items():
        assert rec["max_rel_err"] <= smoke.SEQ_OP_TOL, op


def _encdec(device):
    from paddle_tpu_torch.models import machine_translation as tmt
    from paddle_tpu_torch.core import ir, unique_name
    from paddle_tpu_torch.trainer import Trainer
    main, start = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, start):
        # hidden 128: row 7 takes a multiple of 128 units
        spec = tmt.encoder_decoder(dict_size=500, word_dim=64, hidden=128,
                                   lstm_impl="pallas")
        trainer = Trainer(spec["cost"], spec["optimizer"],
                          spec["feed_list"], device=device,
                          main_program=main, startup_program=start)
    return trainer, spec, tmt.wmt14_pairs(8, 500, seed=3, min_len=3,
                                          max_len=9)


@pytest.mark.cuda
def test_encdec_step_is_captured_with_row7(cuda_device):
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.core.scope import Scope, scope_guard
    steps = 4
    losses = {}
    for use_jit in (True, False):
        trainer, spec, batch = _encdec(cuda_device)
        with scope_guard(Scope()):
            trainer._maybe_init()
            before = dict(trainer.exe.stats)
            kernels.reset_launches()
            feed = trainer.feeder.feed(batch)
            losses[use_jit] = [float(np.asarray(trainer.exe.run(
                trainer.main_program, feed=feed,
                fetch_list=[spec["cost"]], use_jit=use_jit)[0])
                .reshape(-1)[0]) for _ in range(steps)]
            launches = kernels.launch_counts().get("fused_lstm", 0)
            delta = {k: trainer.exe.stats[k] - before[k] for k in (
                "jit_runs", "eager_runs", "graph_captures",
                "graph_replays")}
        trainer.exe.close()
        assert launches == 2 * 2 * steps, (use_jit, launches)
        if use_jit:
            assert delta == {"jit_runs": steps, "eager_runs": 0,
                             "graph_captures": 1,
                             "graph_replays": steps - 1}, delta
    got, want = np.asarray(losses[True]), np.asarray(losses[False])
    assert np.all(np.abs(got - want) <= 1e-6 * np.abs(want)), (got, want)
    assert got[-1] < got[0]


@pytest.mark.cuda
def test_persistable_counter_counts_across_replays(cuda_device):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    main, start = ir.Program(), ir.Program()
    with ir.program_guard(main, start):
        step = layers.create_global_var(shape=[1], value=0, dtype="int64",
                                        persistable=True, name="counter")
        layers.increment(x=step, value=1.0, in_place=True)
        out = layers.scale(layers.cast(step, "float32"), scale=2.0)
    exe, scope = Executor(cuda_device), Scope()
    exe.run(start, scope=scope)
    got = [float(np.asarray(exe.run(main, fetch_list=[out], scope=scope)[0])
                 .reshape(-1)[0]) for _ in range(5)]
    assert got == [2.0, 4.0, 6.0, 8.0, 10.0]
    assert exe.stats["graph_captures"] == 1
    assert exe.stats["graph_replays"] == 4
    v = scope.find_var("counter")
    assert type(v) is torch.Tensor and int(v.reshape(-1)[0]) == 5


@pytest.mark.cuda
def test_data_dependent_while_runs_per_op(cuda_device):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    main, start = ir.Program(), ir.Program()
    with ir.program_guard(main, start):
        n = layers.data("n", shape=[1], dtype="int64",
                        append_batch_size=False)
        i = layers.zeros(shape=[1], dtype="int64")
        total = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = layers.less_than(x=i, y=n)
        w = layers.While(cond=cond)
        with w.block():
            layers.increment(x=total, value=1.0, in_place=True)
            i = layers.increment(x=i, in_place=True)
            layers.less_than(x=i, y=n, cond=cond)
    exe, scope = Executor(cuda_device), Scope()
    exe.run(start, scope=scope)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [float(np.asarray(exe.run(
            main, feed={"n": np.asarray([k], np.int64)}, fetch_list=[total],
            scope=scope)[0]).reshape(-1)[0]) for k in (5, 3, 4)]
    assert got == [5.0, 3.0, 4.0]
    assert any("per-op path" in str(w.message) for w in caught)
    assert exe.stats["eager_runs"] == 3 and exe.stats["graph_captures"] == 0
