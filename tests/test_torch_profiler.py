"""The port's profiler (``paddle_tpu_torch/profiler.py``) and its
counters at every site the JAX package bumps them, against
``paddle_tpu/profiler.py``, on the CPU: the cases of
``tests/test_aux.py:149-216``, ``tests/test_aux2.py:179-200``,
``tests/test_async_pipeline.py:340-350``,
``tests/test_generation.py:419-428,818-833`` and
``tests/test_memory_analysis.py:316-317``.

- ``profiler(...)`` prints the per-program table; ``timeline_path``
  writes an artifact of schema ``paddle_tpu.timeline.v1`` with the same
  top-level sections as the JAX package's, program and per-op spans, the
  host table and a ``programs`` entry of the compiled step (on the CPU:
  its feed shapes and launches; no graph, so no kernel nodes).
- The same training steps and serving requests give the same counter
  names and values in both packages: the pipeline section of a
  pipelined pass, the generation section of an engine's requests
  (plain and device-sampled), the trainer section, the memory
  preflight's predicted peak, the tune section (dispatch counters and
  the ``tune`` verb's loops).
- The max-keyed counters, the derived speculation and prefix sections,
  the stat timer tree and ``BarrierStat`` agree with the JAX package's.
- ``cuda_profiler(output_file)`` writes a ``torch.profiler`` chrome
  trace.

Tolerance: exact for counts; the memory preflight's predicted peak is
the same integer in both packages.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu import profiler as jprof  # noqa: E402
from paddle_tpu import tune as jtune  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu.models import transformer as jtm  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu_torch import cli as tcli  # noqa: E402
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import profiler as tprof  # noqa: E402
from paddle_tpu_torch import tune as ttune  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope, scope_from_numpy,  # noqa: E402,E501
                                         scope_guard)
from paddle_tpu_torch.flags import flags_guard  # noqa: E402
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402
from paddle_tpu_torch.serving import GenerationEngine  # noqa: E402

import torch_book as book  # noqa: E402

PROFS = (jprof, tprof)


@pytest.fixture(autouse=True)
def _clean_profilers():
    for p in PROFS:
        p.reset_profiler()
        p.reset_stats()
    yield
    for p in PROFS:
        p.reset_profiler()
        p.reset_stats()


def _classifier(pkg):
    """The JAX test's program: fc 16 relu, fc 4 softmax, SGD 0.1:
    (main, startup, loss name)."""
    if pkg == "jax":
        main, start = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, start):
            x = jlayers.data("x", shape=[8])
            y = jlayers.data("y", shape=[1], dtype="int64")
            pred = jlayers.fc(jlayers.fc(x, size=16, act="relu"), size=4,
                              act="softmax")
            loss = jlayers.mean(jlayers.cross_entropy(pred, y))
            jpt.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return main, start, loss.name
    main, start = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, start):
        x = tlayers.data("x", shape=[8])
        y = tlayers.data("y", shape=[1], dtype="int64")
        pred = tlayers.fc(tlayers.fc(x, size=16, act="relu"), size=4,
                          act="softmax")
        loss = tlayers.mean(tlayers.cross_entropy(pred, y))
        topt.SGD(learning_rate=0.1).minimize(loss)
    return main, start, loss.name


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.rand(4, 8).astype("float32"),
            "y": rng.randint(0, 4, (4, 1)).astype("int64")}


def _profiled_runs(pkg, tmp_path, profile=True):
    """Three compiled runs and one per-op run of the classifier from the
    JAX startup state, under ``profiler(timeline_path=...)``: the
    artifact."""
    jmain, jstart, _ = _classifier("jax")
    state = book.jax_startup_state(jmain, jstart)
    main, _, loss = _classifier(pkg)
    path = str(tmp_path / ("%s_timeline.json" % pkg))
    prof = jprof if pkg == "jax" else tprof
    if pkg == "jax":
        scope = jpt.Scope()
        for n, v in state.items():
            scope.set_var(n, v)
        exe = jpt.Executor(jpt.CPUPlace())
        run = lambda **kw: exe.run(main, feed=_feed(), fetch_list=[loss],  # noqa: E731,E501
                                   scope=scope, **kw)
    else:
        scope = Scope()
        scope_from_numpy(state, device="cpu", scope=scope)
        exe = Executor("cpu")
        run = lambda **kw: exe.run(main, feed=_feed(), fetch_list=[loss],  # noqa: E731,E501
                                   scope=scope, **kw)
    with prof.profiler(timeline_path=path,
                       profile_path=str(tmp_path / ("%s_table.txt" % pkg))):
        for _ in range(3):
            run()
        run(use_jit=False)
    with open(path) as f:
        return json.load(f), main


def test_profiler_prints_the_program_table(capsys, tmp_path):
    art, _ = _profiled_runs("port", tmp_path)
    out = capsys.readouterr().out
    assert "program_" in out and "Calls" in out
    assert "program_" in (tmp_path / "port_table.txt").read_text()


def test_timeline_artifact_has_the_jax_sections(tmp_path):
    art, main = _profiled_runs("port", tmp_path)
    jart, _ = _profiled_runs("jax", tmp_path)
    assert sorted(art) == sorted(jart)
    assert art["schema"] == jart["schema"] == "paddle_tpu.timeline.v1"
    # the host table has the program timer: 4 runs of one program
    label = "program_%d_run" % main._uid
    row = next(r for r in art["host_events"] if r["name"] == label)
    assert row["calls"] == 4
    assert sorted(row) == sorted(jart["host_events"][0])
    # chrome-trace spans: program runs and per-op spans, eager-phase ones
    cats = {e["cat"] for e in art["trace_events"]}
    assert {"program", "op"} <= cats
    op_ev = [e for e in art["trace_events"] if e["cat"] == "op"]
    assert any(e["args"]["phase"] == "eager" for e in op_ev)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in op_ev)
    n_ops = len(main.global_block().ops)
    # the warm-up, the capture's stand-in, the CPU's stand-in for a
    # replay (the step function; on the card a replay runs no op) and the
    # per-op run
    assert len(op_ev) == 4 * n_ops
    assert [e["args"]["phase"] for e in op_ev].count("trace") == n_ops
    # the compiled step's programs entry (what a CUDA graph lets the port
    # know; no flops or collective census on a graph)
    entry = art["programs"]["program_%d" % main._uid]
    assert entry["feed_shapes"] == {"x": [4, 8], "y": [4, 1]}
    assert entry["kernel_nodes"] == {} and entry["kernel_nodes_total"] == 0
    assert entry["launches"] == {} and entry["pool_bytes"] == 0
    assert entry["mesh_devices"] == 1


def test_the_programs_entry_survives_a_reset_between_sessions(tmp_path):
    main, start, loss = _classifier("port")
    exe, scope = Executor("cpu"), Scope()
    with scope_guard(scope):
        exe.run(start)
    with tprof.profiler():
        for _ in range(3):
            exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    path = str(tmp_path / "t.json")
    with tprof.profiler(timeline_path=path):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    art = json.load(open(path))
    assert "program_%d" % main._uid in art["programs"]


def test_stat_timer_tree_and_print(capsys):
    import time as _t
    for prof in PROFS:
        with prof.timer("pass"):
            for _ in range(3):
                with prof.timer("batch"):
                    _t.sleep(0.001)
    snap, jsnap = tprof.stat_summary(), jprof.stat_summary()
    assert sorted(snap) == sorted(jsnap) == ["pass", "pass.batch"]
    assert snap["pass"][0] == 1 and snap["pass.batch"][0] == 3
    assert snap["pass"][1] >= snap["pass.batch"][1]
    tprof.print_stats()
    out = capsys.readouterr().out
    assert "batch" in out and "count" in out


def test_barrier_stat_straggler_as_in_jax():
    out = []
    for prof in PROFS:
        bs = prof.BarrierStat(4)
        for r in range(5):
            for m in range(4):
                bs.observe(m, t=r * 1.0 + (0.01 if m == 2 else 0.0))
        out.append(bs.summary())
    assert out[0] == out[1]
    assert out[1]["worst_member"] == 2 and out[1]["rounds"] == 5


def test_pipeline_counters_of_a_pipelined_pass_as_in_jax():
    got = {}
    jmain, jstart, _ = book.build("jax", "fit_a_line")
    state = book.jax_startup_state(jmain, jstart)
    for pkg, prof in (("jax", jprof), ("port", tprof)):
        scope = jpt.scope_guard(jpt.Scope()) if pkg == "jax" \
            else scope_guard(Scope())
        with scope:
            tr, spec = book.make_trainer(pkg, "fit_a_line")
            book.init_from(tr, pkg, state)
            prof.reset_pipeline_counters()
            tr.train(book.reader_of(book.batches("fit_a_line", 6)),
                     num_passes=1, pipeline=True, pipeline_depth=2)
            got[pkg] = prof.pipeline_counters()
    port, jax = got["port"], got["jax"]
    assert sorted(port) == sorted(jax)
    for k in ("pipeline_batches", "slot_reuse", "fallback_sync",
              "fetch_sync_count"):
        assert port[k] == jax[k], k
    assert port["pipeline_batches"] == 6 and port["fetch_sync_count"] == 6
    assert port["dispatch_depth"] >= 1


VOCAB, MAX_SEQ = 29, 48


@pytest.fixture(scope="module")
def lm_pair():
    cfg = jtm.TransformerConfig(vocab_size=VOCAB, hidden=16, num_layers=2,
                                num_heads=2, max_seq=MAX_SEQ)
    jmodel = jtm.TransformerLM(jtm.init_params(cfg, seed=3), cfg)
    params = {n: np.asarray(jmodel.params[n]) for n in jtm.param_names(cfg)}
    return jmodel, ttm.TransformerLM.from_numpy(params, cfg.to_dict(),
                                                device="cpu")


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11]]


@pytest.mark.parametrize("device_sample", [False, True],
                         ids=["host_sample", "device_sample"])
def test_generation_counters_equal_the_jax_engines(lm_pair, device_sample):
    jmodel, model = lm_pair
    kw = dict(max_running=4, kv_pages=64, page_tokens=8, queue_depth=64,
              device_sample=device_sample)
    got = {}
    for pkg, prof in (("jax", jprof), ("port", tprof)):
        prof.reset_generation_counters()
        eng = JaxEngine(jmodel, warm=False, **kw) if pkg == "jax" \
            else GenerationEngine(model, **kw)
        with eng:
            for p in PROMPTS:
                eng.generate(p, max_new_tokens=5, timeout=300)
        got[pkg] = prof.generation_counters()
    assert got["port"] == got["jax"]
    c = got["port"]
    assert c["gen_requests"] == 3 and c["gen_completed"] == 3
    assert c["gen_tokens"] == 15 and c["gen_prefills"] == 3
    assert c["gen_decode_steps"] == 12
    assert 0 < c["gen_page_util_max"] <= 1.0
    if device_sample:
        # the token counters flush once a step: every step sampled on
        # the device, no logits row read on the host
        assert c["gen_device_sample_steps"] == 12
        assert c.get("gen_host_logit_syncs", 0) == 0
    else:
        assert c["gen_host_logit_syncs"] == 15
    assert c.get("gen_kernel_hits", 0) == 0   # the CPU's plain version


def test_max_keyed_counters_and_derived_sections_as_in_jax():
    for prof in PROFS:
        prof.update_generation_counters(gen_max_running=3, gen_tokens=5,
                                        gen_draft_tokens=8,
                                        gen_accepted_tokens=6,
                                        gen_prefix_hits=2,
                                        gen_prefix_published=6)
        prof.update_generation_counters(gen_max_running=2, gen_tokens=1)
        prof.update_memory_counters(mem_preflights=1,
                                    mem_predicted_peak_bytes=10,
                                    mem_measured_live_bytes=7)
        prof.update_memory_counters(mem_preflights=1,
                                    mem_predicted_peak_bytes=4,
                                    mem_measured_live_bytes=9)
        prof.update_pipeline_counters(dispatch_depth=2, feed_wait_ms=1.5)
        prof.update_pipeline_counters(dispatch_depth=1, feed_wait_ms=1.0)
        prof.update_router_counters(router_peak_load=3.0, router_requests=1)
        prof.update_router_counters(router_peak_load=1.0, router_requests=1)
        prof.update_autoscale_counters(autoscale_replicas=4)
        prof.update_autoscale_counters(autoscale_replicas=2)
        prof.update_comm_counters(comm_quant_fallbacks=3, comm_bytes=1)
        prof.update_comm_counters(comm_quant_fallbacks=1, comm_bytes=1)
        prof.update_serving_counters(max_occupancy=5, requests=2)
        prof.update_serving_counters(max_occupancy=3, requests=2)
        prof.update_elastic_counters(elastic_resizes=1)
        prof.update_grayfail_counters(gray_suspected=1)
    for name in ("generation_counters", "speculation_counters",
                 "prefix_counters", "memory_counters", "pipeline_counters",
                 "router_counters", "autoscale_counters", "comm_counters",
                 "serving_counters", "elastic_counters",
                 "grayfail_counters"):
        assert getattr(tprof, name)() == getattr(jprof, name)(), name
    assert tprof.generation_counters()["gen_max_running"] == 3.0
    assert tprof.speculation_counters()["acceptance_rate"] == 0.75
    assert tprof.prefix_counters()["hit_rate"] == 0.25
    assert tprof.memory_counters() == {"mem_preflights": 2.0,
                                       "mem_predicted_peak_bytes": 10.0,
                                       "mem_measured_live_bytes": 9.0}
    for name in ("generation", "memory", "pipeline", "router", "autoscale",
                 "comm", "serving", "elastic", "grayfail", "trainer"):
        getattr(tprof, "reset_%s_counters" % name)()
        assert getattr(tprof, "%s_counters" % name)() == {}


def test_memory_preflight_counts_in_both_packages():
    jmain, jstart, jloss = _classifier("jax")
    state = book.jax_startup_state(jmain, jstart)
    feed = _feed()
    jprof.reset_memory_counters()
    tprof.reset_memory_counters()
    from paddle_tpu.flags import flags_guard as jflags_guard
    jscope, jexe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
    for n, v in state.items():
        jscope.set_var(n, v)
    with jflags_guard(verify=True, memory_budget_gb=64.0):
        jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
    main, _, loss = _classifier("port")
    exe, scope = Executor("cpu"), Scope()
    scope_from_numpy(state, device="cpu", scope=scope)
    with flags_guard(verify=True, memory_budget_gb=64.0):
        for _ in range(3):   # the preflight runs once a step key
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    got, want = tprof.memory_counters(), jprof.memory_counters()
    assert got["mem_preflights"] == want["mem_preflights"] == 1.0
    assert got["mem_predicted_peak_bytes"] == \
        want["mem_predicted_peak_bytes"] == \
        exe.stats["mem_predicted_peak_bytes"]
    # on the CPU the measured half is the bytes of the scope's tensors
    assert got["mem_measured_live_bytes"] == sum(
        v.size * v.itemsize for v in state.values())


def test_tune_dispatch_counters_mirror_into_the_profiler():
    for tune_mod, prof in ((jtune, jprof), (ttune, tprof)):
        tune_mod.reset_counters()
        assert prof.tune_counters() == {}
        tune_mod.record_fallback("matmul")
        tune_mod.record_fallback("conv3x3")
        assert prof.tune_counters() == {"tune_fallbacks": 2.0}
        assert tune_mod.counters()["tune_fallbacks"] == 2
        tune_mod.reset_counters()
        assert prof.tune_counters() == {}


CONV_CONFIG = """\
from paddle_tpu_torch import layers


def model():
    img = layers.data(name="img", shape=[16, 8, 8], dtype="float32")
    out = layers.conv2d(input=img, num_filters=32, filter_size=3,
                        padding=1)
    return {"cost": layers.mean(out), "feed_list": [img], "reader": None}
"""


def test_the_tune_verb_counts_its_loops(tmp_path, capsys):
    cfg = tmp_path / "conv_config.py"
    cfg.write_text(CONV_CONFIG)
    with flags_guard(tune_cache_dir=str(tmp_path / "tune"), tune=True):
        ttune.clear_memory_cache()
        tprof.reset_tune_counters()
        assert tcli.main(["tune", str(cfg), "--device", "cpu", "--batch",
                          "2", "--timer", "model"]) == 0
        ttune.clear_memory_cache()
    c = tprof.tune_counters()
    assert c["tune_loops"] == 1.0 and c["tune_candidates"] == 2.0
    capsys.readouterr()


def test_cuda_profiler_writes_a_chrome_trace(tmp_path):
    path = str(tmp_path / "trace.json")
    main, start, loss = _classifier("port")
    exe, scope = Executor("cpu"), Scope()
    with scope_guard(scope):
        exe.run(start)
    with tprof.cuda_profiler(output_file=path):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    trace = json.load(open(path))
    assert trace["traceEvents"]
    # a directory gets trace.json
    with tprof.xla_trace(str(tmp_path / "logdir")):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert os.path.exists(tmp_path / "logdir" / "trace.json")
    # no output file: nothing is traced
    with tprof.cuda_profiler():
        pass


def test_kernel_symbols_are_read_from_mangled_names():
    sym = tprof._kernel_symbol
    assert sym("_Z16flash_fwd_kernelILi64EEvPKfS1_") == "flash_fwd_kernel"
    assert sym("_ZN7cutlass6KernelINS_4gemmEEEvT_") == "cutlass::Kernel"
    assert sym("_ZN12_GLOBAL__N_120flash_bwd_dkv_kernelILi64EEEvPKf") == \
        "flash_bwd_dkv_kernel"
    assert sym("ampere_sgemm_128x64_nn") == "ampere_sgemm_128x64_nn"


def test_record_run_and_op_events_only_while_profiling():
    main, start, loss = _classifier("port")
    exe, scope = Executor("cpu"), Scope()
    with scope_guard(scope):
        exe.run(start)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope,
            use_jit=False)
    art = tprof.write_timeline(os.devnull)
    assert art["trace_events"] == [] and art["host_events"] == []
