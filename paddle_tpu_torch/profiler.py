"""Profiling: host timers, counters of every subsystem, the timeline
artifact and a device trace (counterpart of ``paddle_tpu/profiler.py``,
same public names).

- ``start_profiler`` / ``stop_profiler`` / ``profiler(...)``: while on,
  the Executor records each program run's wall time (``record_run``),
  each op's span on the per-op path (``record_op_event``) and, at a
  compiled step's capture, what the port knows of the CUDA graph it
  captured (``record_program_analysis``: the graph's kernel nodes by
  symbol, its pool's bytes, the step key's feed shapes). A CUDA graph
  has no XLA cost analysis, so that ``programs`` entry holds no flops,
  bytes accessed or collective census (ROADMAP.md Queue 3 #24).
- The counters (``update_*`` / ``*_counters`` / ``reset_*``) are always
  on: a few dict adds per pass, batch, engine step or preflight, never
  per op. Keys kept as a maximum, not a sum, are listed in
  ``_GEN_MAX_KEYS``, ``_MEM_MAX_KEYS``, ``_ROUTER_MAX_KEYS`` and
  ``_AUTOSCALE_MAX_KEYS`` and in each updater's docstring.
- ``write_timeline(path)``: one JSON artifact of schema
  ``paddle_tpu.timeline.v1``: chrome-trace spans (Perfetto), the host
  table, the ``programs`` entries and every counter section.
- ``cuda_profiler(output_file)`` / ``xla_trace(logdir)``: a
  ``torch.profiler`` trace of the card's kernels (CUPTI), written as a
  chrome trace that Perfetto loads; the counterpart of the JAX
  package's xplane trace and of the reference's nvprof wrapper.
- ``timer`` / ``stat_summary`` / ``print_stats`` / ``reset_stats``: the
  hierarchical stat timers, and ``BarrierStat`` for stragglers.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict

__all__ = ["timer", "stat_summary", "print_stats", "reset_stats",
           "BarrierStat",
           "start_profiler", "stop_profiler", "reset_profiler", "profiler",
           "cuda_profiler", "xla_trace", "profiler_enabled", "record_run",
           "record_op_event", "record_program_analysis", "write_timeline",
           "update_pipeline_counters", "pipeline_counters",
           "reset_pipeline_counters",
           "update_serving_counters", "serving_counters",
           "reset_serving_counters",
           "update_comm_counters", "comm_counters", "reset_comm_counters",
           "update_tune_counters", "tune_counters", "reset_tune_counters",
           "update_elastic_counters", "elastic_counters",
           "reset_elastic_counters",
           "update_generation_counters", "generation_counters",
           "reset_generation_counters", "speculation_counters",
           "prefix_counters",
           "update_router_counters", "router_counters",
           "reset_router_counters",
           "update_autoscale_counters", "autoscale_counters",
           "reset_autoscale_counters",
           "update_memory_counters", "memory_counters",
           "reset_memory_counters",
           "update_trainer_counters", "trainer_counters",
           "reset_trainer_counters",
           "update_grayfail_counters", "grayfail_counters",
           "reset_grayfail_counters"]

_enabled = False
_records = defaultdict(list)  # label -> [seconds]
_op_events = []               # chrome-trace X events (eager per-op spans)
_program_analyses = {}        # label -> {flops, bytes, collectives, ...}
_pipeline_counters = defaultdict(float)  # async-pipeline observability
_serving_counters = defaultdict(float)   # online-serving observability
_comm_counters = defaultdict(float)      # gradient-communication observability
_tune_counters = defaultdict(float)      # kernel-autotuning observability
_elastic_counters = defaultdict(float)   # elasticity observability
_generation_counters = defaultdict(float)  # autoregressive-serving observability
_router_counters = defaultdict(float)     # multi-replica-router observability
_autoscale_counters = defaultdict(float)  # closed-loop-autoscaler observability
_memory_counters = defaultdict(float)     # static-memory-planner observability
_trainer_counters = defaultdict(float)    # trainer-loop failure-policy observability
_grayfail_counters = defaultdict(float)   # gray-failure-detection observability
_T0 = time.perf_counter()


def profiler_enabled():
    return _enabled


_phase = "eager"


def set_phase(phase):
    """'eager' = per-op spans are real run time; 'trace' = spans measure
    trace/lowering cost (the jit path runs as one fused program)."""
    global _phase
    _phase = phase


def record_run(label, seconds):
    """Called by Executor.run while profiling is on."""
    if _enabled:
        _records[label].append(seconds)
        t_end = time.perf_counter()
        _op_events.append({
            "name": label, "cat": "program", "ph": "X",
            "ts": (t_end - seconds - _T0) * 1e6, "dur": seconds * 1e6,
            "pid": 0, "tid": 1, "args": {}})


def start_profiler(state="All"):
    """reference: profiler.py start_profiler (state CPU/GPU/All: moot
    here, the device timeline comes from :func:`cuda_profiler`)."""
    global _enabled
    _enabled = True


def reset_profiler():
    _records.clear()
    del _op_events[:]
    _program_analyses.clear()
    _pipeline_counters.clear()
    _serving_counters.clear()
    _comm_counters.clear()
    _tune_counters.clear()
    _elastic_counters.clear()
    _generation_counters.clear()
    _router_counters.clear()
    _autoscale_counters.clear()
    _memory_counters.clear()
    _trainer_counters.clear()
    _grayfail_counters.clear()


def update_pipeline_counters(**counters):
    """Accumulate async-pipeline observability counters (always on — a
    few dict adds per pass/materialisation, not per op). Keys in use:
    ``feed_wait_ms``, ``dispatch_depth`` (kept as a max, not a sum),
    ``fetch_sync_count``, ``compile_cache_hits``, ``pipeline_batches``,
    ``slot_reuse``, ``fallback_sync``."""
    for k, v in counters.items():
        if k == "dispatch_depth":
            _pipeline_counters[k] = max(_pipeline_counters[k], float(v))
        else:
            _pipeline_counters[k] += float(v)


def pipeline_counters():
    """Snapshot {counter: value} of the async-pipeline counters."""
    return dict(_pipeline_counters)


def reset_pipeline_counters():
    _pipeline_counters.clear()


def update_serving_counters(**counters):
    """Accumulate online-serving observability counters (always on — a
    few dict adds per BATCH, not per request-row). Keys in use:
    ``requests``, ``batches``, ``padded_rows``, ``queue_wait_ms``,
    ``shed_overload``, ``shed_deadline``, ``failed``;
    ``max_occupancy`` is kept as a max, not a sum."""
    for k, v in counters.items():
        if k == "max_occupancy":
            _serving_counters[k] = max(_serving_counters[k], float(v))
        else:
            _serving_counters[k] += float(v)


def serving_counters():
    """Snapshot {counter: value} of the online-serving counters."""
    return dict(_serving_counters)


def reset_serving_counters():
    _serving_counters.clear()


def update_comm_counters(**counters):
    """Accumulate gradient-communication observability counters
    (paddle_tpu.comm; a few dict adds per step-BUILD or per recorded
    step, never per collective). Keys in use: ``comm_bytes`` (modelled
    per-chip wire bytes per step), ``comm_payload_bytes``,
    ``comm_buckets``, ``comm_dispatches``, ``comm_builds``; the overlap
    step (comm.overlap) adds ``comm_overlap_builds``,
    ``comm_overlap_buckets_early`` (buckets issued before the final
    one — each data-independent of the remaining backward chain) and
    ``comm_overlap_hidden_bytes_est`` (wire bytes of those early
    buckets — the estimate of what the latency-hiding scheduler can
    hide; an estimate, CPU CI cannot time a real fabric);
    ``comm_quant_fallbacks`` is a cumulative gauge kept as a max, not a
    sum (the comm state already accumulates it across steps)."""
    for k, v in counters.items():
        if k == "comm_quant_fallbacks":
            _comm_counters[k] = max(_comm_counters[k], float(v))
        else:
            _comm_counters[k] += float(v)


def comm_counters():
    """Snapshot {counter: value} of the gradient-communication counters."""
    return dict(_comm_counters)


def reset_comm_counters():
    _comm_counters.clear()


def update_tune_counters(**counters):
    """Accumulate kernel-autotuning observability counters
    (paddle_tpu_torch.tune; a few dict adds per kernel DISPATCH, which
    happens at a step key's first lowering pass, never per replay). Keys
    in use: ``tune_hits`` (cached winner applied), ``tune_misses``
    (kernel ran its default config), ``tune_fallbacks`` (the stock
    PyTorch lowering),
    ``tune_loops`` / ``tune_candidates`` (autotune-loop activity from
    the CLI / smoke gate)."""
    for k, v in counters.items():
        _tune_counters[k] += float(v)


def tune_counters():
    """Snapshot {counter: value} of the kernel-autotuning counters."""
    return dict(_tune_counters)


def reset_tune_counters():
    _tune_counters.clear()


def update_elastic_counters(**counters):
    """Accumulate elasticity observability counters (paddle_tpu.elastic;
    a few dict adds per RESIZE/RESUME — rare, operator-visible events,
    never per step). Keys in use: ``elastic_resizes`` (world shrinks),
    ``elastic_lost_ranks``, ``elastic_restarts`` (transient full-world
    relaunches), ``elastic_requeued_tasks`` (the dead worker's leased
    dataset tasks re-queued through the task master),
    ``elastic_resumes`` and ``elastic_resume_ms`` (cross-world
    checkpoint-restore latency), ``elastic_heartbeat_failures``."""
    for k, v in counters.items():
        _elastic_counters[k] += float(v)


def elastic_counters():
    """Snapshot {counter: value} of the elasticity counters."""
    return dict(_elastic_counters)


def reset_elastic_counters():
    _elastic_counters.clear()


def update_trainer_counters(**counters):
    """Accumulate trainer-loop failure-policy observability counters
    (the elastic-worker/watchdog/guardrail machinery; a few dict adds
    per SKIP/REWIND/HANG — operator-visible events, never per step).
    Keys in use: ``batches_skipped`` (numeric-guardrail skips),
    ``guard_rewinds`` (budget-exhaustion checkpoint rewinds),
    ``steps_hung`` (watchdog firings — normally the last counter the
    process ever bumps), ``elastic_tasks_committed`` and
    ``elastic_task_failures`` (lease accounting of the elastic Trainer
    worker), ``preempts_truncated`` (SIGTERM drains that could not fit
    a final checkpoint inside the grace window)."""
    for k, v in counters.items():
        _trainer_counters[k] += float(v)


def trainer_counters():
    """Snapshot {counter: value} of the trainer-loop counters."""
    return dict(_trainer_counters)


def reset_trainer_counters():
    _trainer_counters.clear()


_GEN_MAX_KEYS = frozenset(("gen_max_running", "gen_page_util_max"))


def update_generation_counters(**counters):
    """Accumulate autoregressive-serving observability counters
    (paddle_tpu_torch.serving.generator; a few dict adds per engine STEP or
    per retired request, never per token-row). Keys in use:
    ``gen_requests``, ``gen_completed``, ``gen_prefills``,
    ``gen_decode_steps``, ``gen_tokens`` (generated, prompt excluded),
    ``gen_shed_overload`` / ``gen_shed_deadline`` / ``gen_shed_pool``,
    ``gen_preemptions``, ``gen_failed``;
    ``gen_device_sample_steps`` (decode steps whose sampling ran on the
    device inside the step), ``gen_host_logit_syncs`` (device edges
    that materialized a full logits row/batch on the host to sample — 0
    on the fused path), ``gen_kernel_hits`` (decode steps routed through
    the paged-attention kernel); ``gen_max_running`` and
    ``gen_page_util_max`` are kept as maxima, not sums.

    Speculative decoding adds ``gen_spec_steps`` (decode steps that ran
    as draft-propose / fused-verify rounds), ``gen_draft_tokens``
    (tokens the draft proposed), ``gen_accepted_tokens`` (proposals the
    target's verify accepted — acceptance rate is their ratio, surfaced
    by :func:`speculation_counters`), and ``gen_spec_degraded``
    (speculation dropped to plain decode; fault site
    ``serving.speculate``).

    Prefix sharing and disaggregation add ``gen_prefix_hits`` (prefill
    pages satisfied from the shared cache instead of recomputed),
    ``gen_prefix_published`` (pages a prefill published for reuse),
    ``gen_cow_copies`` (copy-on-write page splits on first divergent
    write), ``gen_prefix_degraded`` (sharing dropped to private pages;
    fault site ``serving.prefix``), ``gen_handoff_installs`` (prefill
    artifacts installed on a decode replica), and ``gen_handoff_failed``
    (handoffs that fell back to re-prefill; fault site
    ``serving.ship``) — surfaced by :func:`prefix_counters`."""
    for k, v in counters.items():
        if k in _GEN_MAX_KEYS:
            _generation_counters[k] = max(_generation_counters[k], float(v))
        else:
            _generation_counters[k] += float(v)


def generation_counters():
    """Snapshot {counter: value} of the autoregressive-serving counters."""
    return dict(_generation_counters)


def speculation_counters():
    """The speculative-decoding slice of the generation counters, plus
    the derived ``acceptance_rate`` (accepted / drafted; 0.0 before any
    speculative round). This is the timeline artifact's ``speculation``
    section — all zeros on a non-speculative engine."""
    g = _generation_counters
    drafted = g.get("gen_draft_tokens", 0.0)
    return {
        "spec_steps": g.get("gen_spec_steps", 0.0),
        "draft_tokens": drafted,
        "accepted_tokens": g.get("gen_accepted_tokens", 0.0),
        "acceptance_rate": (g.get("gen_accepted_tokens", 0.0) / drafted
                            if drafted else 0.0),
        "spec_degraded": g.get("gen_spec_degraded", 0.0),
    }


def prefix_counters():
    """The prefix-sharing / disaggregation slice of the generation
    counters, plus the derived ``hit_rate`` (cache-hit pages over pages
    published + hit; 0.0 before any shared prefill). This is the
    timeline artifact's ``prefix`` section — all zeros on an engine
    without sharing or handoffs."""
    g = _generation_counters
    hits = g.get("gen_prefix_hits", 0.0)
    published = g.get("gen_prefix_published", 0.0)
    return {
        "prefix_hits": hits,
        "prefix_published": published,
        "hit_rate": (hits / (hits + published) if hits + published
                     else 0.0),
        "cow_copies": g.get("gen_cow_copies", 0.0),
        "prefix_degraded": g.get("gen_prefix_degraded", 0.0),
        "handoff_installs": g.get("gen_handoff_installs", 0.0),
        "handoff_failed": g.get("gen_handoff_failed", 0.0),
    }


def reset_generation_counters():
    _generation_counters.clear()


_MEM_MAX_KEYS = frozenset(("mem_predicted_peak_bytes",
                           "mem_measured_live_bytes"))


def update_memory_counters(**counters):
    """Accumulate static-memory-planner observability counters
    (paddle_tpu_torch.analysis.memory; a few dict adds per PREFLIGHT/plan
    build — once per new step key, never per step). Keys in use:
    ``mem_preflights`` (executor pre-compile checks run),
    ``mem_plans`` (lint/accounting/elastic plan builds),
    ``mem_predicted_peak_bytes`` and ``mem_measured_live_bytes``
    (``torch.cuda.memory_allocated`` at the preflight on the card, the
    scope's live tensors' bytes on the CPU) — both kept as maxima, so the
    timeline's ``memory`` section reads as the run's high-water
    predicted-vs-actual pair."""
    for k, v in counters.items():
        if k in _MEM_MAX_KEYS:
            _memory_counters[k] = max(_memory_counters[k], float(v))
        else:
            _memory_counters[k] += float(v)


def memory_counters():
    """Snapshot {counter: value} of the static-memory-planner counters."""
    return dict(_memory_counters)


def reset_memory_counters():
    _memory_counters.clear()


_ROUTER_MAX_KEYS = frozenset(("router_peak_load", "router_replicas"))


def update_router_counters(**counters):
    """Accumulate multi-replica-router observability counters
    (paddle_tpu.serving.router/pool; a few dict adds per routed request
    or per supervision event, recorded in the ROUTER process — each
    replica keeps its own serving/generation counters). Keys in use:
    ``router_requests`` (proxied attempts), ``router_failovers``,
    ``router_no_replica`` (503s: no healthy replica),
    ``router_proxy_failed`` (503s: replicas were routable but both
    failover attempts died on transport), ``router_ejects``
    / ``router_readmits`` (health state transitions),
    ``router_reloads`` / ``router_reload_rollbacks`` (rolling hot
    reload outcomes), ``router_replica_restarts`` /
    ``router_replica_lost`` (pool supervision), ``router_gray_ejects``
    / ``router_gray_readmits`` (latency-skew ejections — replica
    answered /healthz 200 but the SkewDetector condemned its proxied
    latency EWMA), ``router_hedges`` / ``router_hedge_wins`` (hedged
    ``:predict`` attempts fired past the p99 deadline, and how many
    answered before the primary); ``router_peak_load``
    (largest per-replica load score observed by the poller) and
    ``router_replicas`` (configured pool size) are kept as maxima."""
    for k, v in counters.items():
        if k in _ROUTER_MAX_KEYS:
            _router_counters[k] = max(_router_counters[k], float(v))
        else:
            _router_counters[k] += float(v)


def router_counters():
    """Snapshot {counter: value} of the multi-replica-router counters."""
    return dict(_router_counters)


def reset_router_counters():
    _router_counters.clear()


_AUTOSCALE_MAX_KEYS = frozenset(("autoscale_replicas",
                                 "autoscale_pressure_max"))


def update_autoscale_counters(**counters):
    """Accumulate closed-loop-autoscaler observability counters
    (paddle_tpu.serving.autoscale; a few dict adds per control tick
    and per decision). Keys in use: ``autoscale_ticks`` (control-loop
    iterations), ``autoscale_ups`` / ``autoscale_downs`` (fleet
    resizes), ``autoscale_breaker_opens`` /
    ``autoscale_breaker_half_opens`` / ``autoscale_breaker_closes``
    (crash-loop circuit-breaker transitions),
    ``autoscale_breaker_refused`` (scale-ups the open breaker vetoed),
    ``autoscale_degraded`` (controller failures degraded to a fixed
    fleet); ``autoscale_replicas`` (largest fleet size reached) and
    ``autoscale_pressure_max`` (largest smoothed pressure observed)
    are kept as maxima."""
    for k, v in counters.items():
        if k in _AUTOSCALE_MAX_KEYS:
            _autoscale_counters[k] = max(_autoscale_counters[k],
                                         float(v))
        else:
            _autoscale_counters[k] += float(v)


def autoscale_counters():
    """Snapshot {counter: value} of the autoscaler counters."""
    return dict(_autoscale_counters)


def reset_autoscale_counters():
    _autoscale_counters.clear()


def update_grayfail_counters(**counters):
    """Accumulate gray-failure-detection observability counters
    (paddle_tpu.resilience.grayfail consumers — the elastic supervisor
    and the serving router; a few dict adds per detector verdict
    change or hedged request). Keys in use: ``gray_suspected`` (verdict
    escalations recorded at either tier), ``gray_mitigated_restarts``
    / ``gray_mitigated_resizes`` (the supervisor's budgeted
    mitigations of a condemned rank), ``gray_ejects`` /
    ``gray_readmits`` (the router's latency-only replica ejections and
    their probation returns), ``router_hedges`` (hedged :predict
    attempts fired past the p99 deadline) and ``router_hedge_wins``
    (hedges whose answer beat the primary)."""
    for k, v in counters.items():
        _grayfail_counters[k] += float(v)


def grayfail_counters():
    """Snapshot {counter: value} of the gray-failure counters."""
    return dict(_grayfail_counters)


def reset_grayfail_counters():
    _grayfail_counters.clear()


def record_op_event(op_type, name, t_start, t_end):
    """Per-op span from the per-op path (a compiled step's replay runs no
    op at all — op granularity comes from the ``programs`` entry and the
    :func:`cuda_profiler` trace instead)."""
    _op_events.append({
        "name": "%s:%s" % (op_type, name), "cat": "op", "ph": "X",
        "ts": (t_start - _T0) * 1e6, "dur": (t_end - t_start) * 1e6,
        "pid": 0, "tid": 0,
        "args": {"op_type": op_type, "phase": _phase}})


def _kernel_symbol(name):
    """The function name of a kernel from its (Itanium-mangled) symbol:
    ``_Z16flash_fwd_kernelILi64EEv...`` -> ``flash_fwd_kernel``, a nested
    name joined with ``::`` (an anonymous or internal namespace left
    out); an unmangled name as it is."""
    if not name.startswith("_Z"):
        return name
    i, parts = 2, []
    if name[i:i + 1] == "N":
        i += 1
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        n = int(name[i:j])
        part = name[j:j + n]
        if not part.startswith(("_GLOBAL__N", "_INTERNAL")):
            parts.append(part)
        i = j + n
    return "::".join(parts) or name


def graph_kernel_names(graph):
    """The function symbol of every kernel node of a captured
    ``torch.cuda.CUDAGraph`` that kept its graph (``keep_graph=True``),
    read from the driver (``cuGraphGetNodes``, ``cuFuncGetName``)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = (ctypes.c_char * 256)()  # CUDA_KERNEL_NODE_PARAMS_v2
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params):
            raise RuntimeError("cuGraphKernelNodeGetParams_v2 failed")
        func = ctypes.c_void_p.from_buffer(params).value
        name = ctypes.c_char_p()
        if cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)):
            raise RuntimeError("cuFuncGetName failed")
        names.append(name.value.decode())
    return names


def graph_pool_bytes(pool):
    """Bytes the caching allocator holds in a graph memory pool."""
    if pool is None:
        return 0
    import torch
    return sum(seg["total_size"] for seg in
               torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def record_program_analysis(label, graph=None, pool=None, feed_shapes=None,
                            launches=None, mesh_devices=1):
    """What the port knows of a compiled step, recorded at its capture
    while profiling is on (the counterpart of the JAX package's XLA cost
    analysis of a compiled program, which a CUDA graph does not have):
    ``kernel_nodes`` {kernel symbol: nodes} of the captured ``graph``
    (one replay launches each node once) and ``kernel_nodes_total``,
    ``pool_bytes`` of its memory ``pool``, the step key's
    ``feed_shapes`` {name: [dims]}, and ``launches`` {counter: launches
    a replay} as the kernel wrappers counted them at the capture. On the
    CPU there is no graph: no nodes, no pool."""
    entry = {"mesh_devices": int(mesh_devices),
             "feed_shapes": {k: list(v) for k, v in
                             sorted((feed_shapes or {}).items())},
             "launches": dict(launches or {}),
             "kernel_nodes": {}, "kernel_nodes_total": 0, "pool_bytes": 0}
    if graph is not None:
        try:
            names = graph_kernel_names(graph)
            nodes = defaultdict(int)
            for nm in names:
                nodes[_kernel_symbol(nm)] += 1
            entry["kernel_nodes"] = dict(nodes)
            entry["kernel_nodes_total"] = len(names)
        except Exception as e:
            entry["kernel_nodes_error"] = repr(e)
        try:
            entry["pool_bytes"] = int(graph_pool_bytes(pool))
        except Exception as e:
            entry["pool_bytes_error"] = repr(e)
    _program_analyses[label] = entry
    return entry


def put_program_analysis(label, entry):
    if entry is not None:
        _program_analyses[label] = entry


def write_timeline(path):
    """Write the structured timeline artifact (JSON):

    - ``trace_events``: chrome-trace (catapult) spans — per-op eager spans
      and per-program run spans; loadable in chrome://tracing / Perfetto —
      the device_tracer.proto analog
      (reference: paddle/fluid/platform/device_tracer.h:30-60).
    - ``host_events``: aggregated wall-time table (profiler.h role).
    - ``programs``: per compiled step, what the port knows of its CUDA
      graph (``record_program_analysis``): kernel nodes by symbol, pool
      bytes, feed shapes, launches a replay; no XLA cost analysis.
    - ``pipeline``: async-execution-pipeline counters (feed-wait ms,
      dispatch depth, fetch syncs, compile-cache hits) — the overlap
      evidence for paddle_tpu_torch.pipeline.
    - ``serving``: online-serving counters (requests, batches, padded
      rows, queue-wait ms, shed counts, max batch occupancy) — the
      coalescing evidence for paddle_tpu_torch.serving.
    - ``comm``, ``elastic``, ``router``, ``autoscale``, ``grayfail``: the
      sections of subsystems the port has not yet (collectives,
      elasticity, the router and autoscaler, gray failures); empty until
      a caller updates them.
    - ``comm``: gradient-communication counters (modelled wire bytes,
      bucket/dispatch counts, cumulative quant fallbacks).
    - ``tune``: kernel-autotuning counters (winner-cache hits/misses/
      stock-lowering fallbacks at dispatch, autotune-loop activity) —
      the adoption evidence for paddle_tpu_torch.tune.
    - ``elastic``: elasticity counters (resizes, lost ranks, requeued
      tasks, resume latency).
    - ``generation``: autoregressive-serving counters (prefills, fused
      decode steps, generated tokens, running-batch/page-utilization
      maxima, sheds/preemptions) — the continuous-batching evidence for
      paddle_tpu_torch.serving.generator.
    - ``router``: multi-replica-router counters (proxied requests,
      failovers, health ejects/readmits, rolling-reload outcomes,
      replica restarts, peak load score).
    - ``autoscale``: closed-loop-autoscaler counters (control ticks,
      scale-ups/downs, breaker transitions, degraded falls, max fleet
      size and max smoothed pressure).
    - ``memory``: static-memory-planner counters (preflights/plans run,
      predicted peak vs the measured live bytes' high-water — the
      predicted-vs-actual evidence for paddle_tpu_torch.analysis.memory).
    - ``trainer``: trainer-loop failure-policy counters (guardrail
      batch skips and rewinds, watchdog step_hung firings, elastic
      lease commits, truncated preemptions — the survival evidence
      for the elastic Trainer worker).
    """
    rows = []
    for label, times in _records.items():
        n = len(times)
        total = sum(times)
        rows.append({"name": label, "calls": n, "total_ms": total * 1e3,
                     "avg_ms": total / n * 1e3,
                     "min_ms": min(times) * 1e3,
                     "max_ms": max(times) * 1e3})
    artifact = {
        "schema": "paddle_tpu.timeline.v1",
        "trace_events": list(_op_events),
        "host_events": rows,
        "programs": dict(_program_analyses),
        "pipeline": dict(_pipeline_counters),
        "serving": dict(_serving_counters),
        "comm": dict(_comm_counters),
        "tune": dict(_tune_counters),
        "elastic": dict(_elastic_counters),
        "generation": dict(_generation_counters),
        "speculation": speculation_counters(),
        "prefix": prefix_counters(),
        "router": dict(_router_counters),
        "autoscale": dict(_autoscale_counters),
        "memory": dict(_memory_counters),
        "trainer": dict(_trainer_counters),
        "grayfail": dict(_grayfail_counters),
    }
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return artifact


def stop_profiler(sorted_key=None, profile_path=None):
    """Print the aggregated per-program table
    (reference: platform/profiler.h:138-151 PrintProfiler)."""
    global _enabled
    _enabled = False
    rows = []
    for label, times in _records.items():
        n = len(times)
        total = sum(times)
        rows.append((label, n, total, total / n, min(times), max(times)))
    key = {None: lambda r: 0, "default": lambda r: 0,
           "calls": lambda r: -r[1], "total": lambda r: -r[2],
           "ave": lambda r: -r[3], "min": lambda r: -r[4],
           "max": lambda r: -r[5]}.get(sorted_key, lambda r: 0)
    rows.sort(key=key)
    lines = ["%-40s %8s %12s %12s %12s %12s" %
             ("Event", "Calls", "Total(ms)", "Avg(ms)", "Min(ms)", "Max(ms)")]
    for label, n, total, avg, mn, mx in rows:
        lines.append("%-40s %8d %12.3f %12.3f %12.3f %12.3f" %
                     (label, n, total * 1e3, avg * 1e3, mn * 1e3, mx * 1e3))
    report = "\n".join(lines)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(report + "\n")
    print(report)
    return rows


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             timeline_path=None):
    """reference: profiler.py:125 profiler context manager. Pass
    ``timeline_path`` to also write the structured JSON timeline artifact
    (see write_timeline)."""
    start_profiler(state)
    reset_profiler()
    try:
        yield
    finally:
        try:
            if timeline_path:
                write_timeline(timeline_path)
        finally:
            stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """Device-timeline capture. The reference wraps nvprof
    (profiler.py:20-60); here a ``torch.profiler`` trace of the host and
    the card's kernels is written to ``output_file`` (a chrome trace,
    loadable in Perfetto). No ``output_file``: nothing is traced."""
    if output_file:
        with xla_trace(output_file):
            yield
    else:
        yield


@contextlib.contextmanager
def xla_trace(logdir):
    """A ``torch.profiler`` trace with CUDA activity (CUPTI): kernel
    spans, memcpys, the host's ranges. The name is the JAX package's
    (its xplane trace); ``logdir`` is a file path ending in ``.json``,
    or a directory, which gets ``trace.json``. The trace is written when
    the block ends."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = str(logdir)
    if not path.endswith(".json"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def record_event(name):
    """Host-side RAII timer (reference: platform/profiler.h RecordEvent)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_run(name, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Hierarchical stats: the REGISTER_TIMER role (reference: paddle/utils/Stat.h
# — per-name accumulated timers printed as a tree every log period, plus
# BarrierStat for straggler analysis across trainers). Here: nested `timer`
# scopes accumulate (count/total/max) per dotted path; `print_stats` renders
# the tree; `BarrierStat.observe` records per-member arrival times of a
# collective/barrier and reports the straggler gap.

_stat_state = threading.local()


class _StatNode(object):
    __slots__ = ("count", "total", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def add(self, dt):
        self.count += 1
        self.total += dt
        self.max = max(self.max, dt)


_stats = {}
_stats_lock = threading.Lock()


@contextlib.contextmanager
def timer(name):
    """Accumulating hierarchical timer: nesting builds dotted paths.

    >>> with profiler.timer("forward"):
    ...     with profiler.timer("conv"):   # recorded as "forward.conv"
    ...         ...
    """
    stack = getattr(_stat_state, "stack", None)
    if stack is None:
        stack = _stat_state.stack = []
    stack.append(name)
    path = ".".join(stack)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
        with _stats_lock:
            _stats.setdefault(path, _StatNode()).add(dt)


def stat_summary():
    """{path: (count, total_s, avg_s, max_s)} snapshot."""
    with _stats_lock:
        return {p: (n.count, n.total, n.total / n.count, n.max)
                for p, n in _stats.items() if n.count}


def print_stats(file=None):
    """Render the timer tree (REGISTER_TIMER print analog)."""
    import sys as _sys
    out = file or _sys.stdout
    snap = stat_summary()
    if not snap:
        print("(no stats recorded)", file=out)
        return
    print("%-40s %8s %12s %12s %12s" %
          ("timer", "count", "total_ms", "avg_ms", "max_ms"), file=out)
    for path in sorted(snap):
        cnt, tot, avg, mx = snap[path]
        depth = path.count(".")
        label = "  " * depth + path.rsplit(".", 1)[-1]
        print("%-40s %8d %12.3f %12.3f %12.3f" %
              (label, cnt, 1e3 * tot, 1e3 * avg, 1e3 * mx), file=out)


def reset_stats():
    with _stats_lock:
        _stats.clear()


class BarrierStat(object):
    """Straggler analysis for an N-member barrier (reference:
    paddle/pserver/ParameterServer2 BarrierStat / utils/Stat.h): feed each
    member's arrival timestamp per round; report the slowest-minus-fastest
    gap and which member lags most often."""

    def __init__(self, n_members, name="barrier"):
        self.n = n_members
        self.name = name
        self._round = {}
        self._gaps = []
        self._slowest = {}  # member id (any hashable) -> lag-round count
        self._lock = threading.Lock()

    def observe(self, member, t=None):
        t = time.perf_counter() if t is None else t
        with self._lock:
            self._round[member] = t
            if len(self._round) == self.n:
                ts = self._round
                fastest = min(ts, key=ts.get)
                slowest = max(ts, key=ts.get)
                self._gaps.append(ts[slowest] - ts[fastest])
                self._slowest[slowest] = self._slowest.get(slowest, 0) + 1
                self._round = {}

    def summary(self):
        with self._lock:
            if not self._gaps:
                return {"rounds": 0}
            worst = max(self._slowest, key=self._slowest.get)
            return {
                "rounds": len(self._gaps),
                "mean_gap_s": sum(self._gaps) / len(self._gaps),
                "max_gap_s": max(self._gaps),
                "worst_member": worst,
                "worst_member_lag_rounds": self._slowest[worst],
            }
