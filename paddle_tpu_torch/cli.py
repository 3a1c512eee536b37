"""Command line of the port: the ``train``, ``serve``, ``tune`` and
``lint`` verbs (counterparts of ``paddle_tpu/cli.py:cmd_train``, of
``cmd_serve``, of ``cmd_tune`` for train configs and of ``cmd_lint``
without its mesh passes).

    python -m paddle_tpu_torch train <config.py> [--device cuda|cpu]
        [--num_passes N] [--log_period K] [--learning_rate LR]
        [--checkpoint_dir DIR]

loads the config file, calls its ``model()`` (a dict with ``cost``,
``feed_list``, ``reader`` and optionally ``optimizer`` and
``num_passes``), trains it with the port's Trainer on the device and
prints ``pass P batch B cost C`` for every K-th batch and a line at the
end of each pass. With ``--checkpoint_dir`` the run resumes from the
newest state in DIR, saves there at the end of each pass, and a SIGTERM
lets the running batch finish, saves, prints ``preempted at pass P
batch B: checkpoint in DIR`` and exits 0. ``PADDLE_TPU_FLAGS=
step_timeout_s=S`` arms the step watchdog (a step wedged past S
seconds writes a durable ``step_hung`` line to
``$PADDLE_TPU_ELASTIC_STATE/events.jsonl`` and the profiler's timeline
beside it, and exits 75); ``loss_skip_budget=B`` (and
``loss_spike_factor=F``) the numeric guardrails;
``PADDLE_TPU_FAULT_SPEC=trainer.step:delay:nth=3,delay=3600`` seeds a
wedged third step.

    python -m paddle_tpu_torch serve <artifact_dir> --port 0 [--device cuda]
        [--max_batch B] [--batch_timeout_ms T] [--extra_model NAME=DIR]
        [--draft_dir DIR] [--spec_k K] [--prefix_sharing]
        [--tier prefill|decode]

serves a compiled artifact (``inference.export_compiled``) behind
``POST /v1/models/<name>:predict`` and ``:reload`` (the registry warms
and captures the one-request step, which every batch up to
``--max_batch`` replays, before the readiness line),
or a generative one. It validates each artifact (exit 1 with the
problems on a bad one, a JAX package artifact among them; a
``--draft_dir`` that is not a generative artifact is refused too; and
``--device cuda`` with no card), with the PT034 check of the pool the run would allocate (``--kv_pages`` x
``--page_tokens``) plus the weights against the card's memory or
``FLAGS.memory_budget_gb``, each model alone and the target and its
``--draft_dir`` draft together, loads
it onto the device (a speculative pairing with its draft; ``--draft_dir``
pairs the artifact with that draft, at ``--spec_k`` or
``FLAGS.serve_spec_k``), warms the engine, prints one JSON readiness line
``{"serving": {"host", "port", ...}}`` (``--port 0`` binds a free port
and this line names it; ``tier`` when ``--tier`` is set), and serves
``POST /v1/models/<name>:generate``, ``:prefill`` and ``:decode`` (a
generative model) or ``:predict`` (a compiled one), each
``--extra_model`` beside it, until SIGTERM or SIGINT. Then it fails the
queued ``:predict`` requests, drains in-flight generations, prints
``{"serving_stopped": {"signal", "stats"}}`` and exits 0.

    python -m paddle_tpu_torch tune <config.py> [--device cuda|cpu]
        [--batch 8] [--dtype float32] [--budget N] [--dry-run]
        [--timer auto|wall|model] [--out PATH]

builds the config's program, collects the shapes its ``mul`` and
``conv2d`` ops give the matmul and conv3x3 kernels, races each kernel's
tilings against the stock rung on the device, caches the winners
(``tune/cache.py``) and prints the winners table. Exit 0 on success, 1
when a population has no eligible candidate, 2 when the config fails to
build.

    python -m paddle_tpu_torch lint <config.py> [--strict] [--dot PATH]
        [--memory [--budget-gb G] [--batch 16] [--mesh dp=N]]

builds the config's program and runs the static verifier over it and
its startup program (``paddle_tpu_torch.analysis``, PT001-PT017); with
``--memory`` it appends the backward and the config's optimizer (SGD if
it names none) and prints the memory planner's residency table
(PT030-PT033) at ``--batch`` over ``--mesh dp=N``. Exit 0 when clean or
with warnings only, 1 on an error (or any diagnostic under
``--strict``), 2 when the config fails to build. ``--comm``,
``--sharding``, ``--spec`` and ``--all`` exit 2: their passes need
collectives and a mesh (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

__all__ = ["main"]


def _load_config(path):
    spec = importlib.util.spec_from_file_location("train_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cmd_train(args):
    from . import optimizer, trainer
    cfg = _load_config(args.config)
    spec = cfg.model()
    opt = spec.get("optimizer") or optimizer.SGD(
        learning_rate=args.learning_rate)
    tr = trainer.Trainer(cost=spec["cost"], optimizer=opt,
                         feed_list=spec["feed_list"], device=args.device,
                         checkpoint_dir=args.checkpoint_dir or None)
    last = {}

    def handler(e):
        if isinstance(e, trainer.EndIteration):
            last["at"] = (e.pass_id, e.batch_id)
            if e.batch_id % args.log_period == 0:
                print("pass %d batch %d cost %.5f"
                      % (e.pass_id, e.batch_id, e.cost), flush=True)
        elif isinstance(e, trainer.EndPass):
            print("pass %d done: %s" % (e.pass_id, e.metrics), flush=True)

    tr.train(spec["reader"],
             num_passes=args.num_passes or spec.get("num_passes", 1),
             event_handler=handler)
    if tr.preempted:
        print("preempted at pass %d batch %d: checkpoint in %s"
              % (last.get("at", (0, -1)) + (args.checkpoint_dir,)),
              flush=True)
    return 0


def _parse_extra_models(pairs, primary=None):
    """``--extra_model name=dir`` entries -> [(name, dir)]; ValueError on
    a malformed pair or a name repeated (or shadowing ``primary``):
    ``load_model`` would hot-swap the earlier artifact."""
    out = []
    seen = {primary} if primary else set()
    for pair in pairs or []:
        name, eq, dirname = pair.partition("=")
        if not (eq and name.strip() and dirname.strip()):
            raise ValueError("bad --extra_model %r (want name=dir)" % pair)
        name = name.strip()
        if name in seen:
            raise ValueError("duplicate model name %r (--extra_model "
                             "must not repeat a name or shadow --name)"
                             % name)
        seen.add(name)
        out.append((name, dirname.strip()))
    return out


def _validate_artifacts(artifact_dir, extra_models, draft_dir, kv_pages,
                        page_tokens, budget):
    """The JAX verb's up-front check: print the problems of the primary
    artifact, of each ``--extra_model`` and of a ``--draft_dir`` draft
    and return False on a bad one. A compiled artifact is judged by
    ``validate_artifact``, a generative one by
    ``validate_generative_artifact`` (PT034 at this run's pool geometry
    against ``budget`` included); then the aggregate of the generative
    ones: they load into one process, so each fitting alone proves
    nothing."""
    from . import inference
    from .analysis import memory as memory_mod
    if draft_dir and not inference.is_generative_artifact(draft_dir):
        print("serve: cannot serve: --draft_dir %r is not a generative "
              "artifact (speculation drafts are export_generative "
              "directories)" % draft_dir, file=sys.stderr)
        return False
    entries = [("artifact", artifact_dir)] + [
        ("extra model %r" % n, d) for n, d in extra_models]
    if draft_dir:
        entries.append(("--draft_dir", draft_dir))
    total, labels = 0, []
    for role, dirname in entries:
        generative = inference.is_generative_artifact(dirname)
        problems = (inference.validate_generative_artifact(
                        dirname, kv_pages=kv_pages, page_tokens=page_tokens,
                        budget_bytes=budget, check_pool=bool(budget))
                    if generative else inference.validate_artifact(dirname))
        if problems:
            print("serve: cannot serve %s %r:" % (role, dirname),
                  file=sys.stderr)
            for p in problems:
                print("  - " + p, file=sys.stderr)
            return False
        if generative and budget:
            nb = inference.generative_memory_bytes(
                dirname, kv_pages=kv_pages, page_tokens=page_tokens)
            if nb is not None:
                total += nb
                labels.append("%s=%s" % (role, memory_mod.fmt_bytes(nb)))
    if budget and len(labels) > 1 and total > budget:
        print("serve: cannot serve: PT034 the co-hosted generative models "
              "need %s together (%s) on a %s budget — each fits alone, "
              "one process loads them all"
              % (memory_mod.fmt_bytes(total), ", ".join(labels),
                 memory_mod.fmt_bytes(budget)), file=sys.stderr)
        return False
    return True


def cmd_serve(args):
    from . import inference, serving
    from .analysis import memory as memory_mod
    from .device import resolve_device
    from .flags import FLAGS
    draft_dir = args.draft_dir or FLAGS.serve_draft_dir or None
    try:
        extra_models = _parse_extra_models(args.extra_model,
                                           primary=args.name)
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print("serve: %s" % e, file=sys.stderr)
        return 1
    generative = inference.is_generative_artifact(args.artifact_dir)
    if draft_dir and not generative:
        print("serve: --draft_dir only pairs with a generative primary "
              "artifact", file=sys.stderr)
        return 1
    budget = memory_mod.resolve_budget_bytes(device=device)
    if not _validate_artifacts(args.artifact_dir, extra_models, draft_dir,
                               args.kv_pages or None,
                               args.page_tokens or None, budget):
        return 1
    service = serving.InferenceService(
        max_batch=args.max_batch or None,
        batch_timeout_ms=(args.batch_timeout_ms
                          if args.batch_timeout_ms >= 0 else None),
        queue_depth=args.queue_depth or None, tier=args.tier or None)
    knobs = {k: getattr(args, k) for k in ("max_running", "kv_pages",
                                           "page_tokens")
             if getattr(args, k)}
    if args.prefix_sharing:
        knobs["prefix_sharing"] = True
    # speculation is the primary model's alone
    primary = dict(knobs)
    if args.spec_k:
        primary["spec_k"] = args.spec_k
    loading = args.artifact_dir
    try:
        if draft_dir:
            loading = draft_dir
            primary["draft_model"] = inference.load_generative(
                draft_dir, device=device)
            primary.setdefault("spec_k", FLAGS.serve_spec_k)
            loading = args.artifact_dir
        entry = service.load_model(args.name, args.artifact_dir,
                                   device=device,
                                   **(primary if generative else {}))
        for extra_name, extra_dir in extra_models:
            loading = extra_dir
            service.load_model(
                extra_name, extra_dir, device=device,
                **(knobs if inference.is_generative_artifact(extra_dir)
                   else {}))
    except Exception as e:
        print("serve: failed to load %r: %s: %s"
              % (loading, type(e).__name__, e), file=sys.stderr)
        service.close()
        return 1
    server = serving.make_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    info = {
        "host": host, "port": port, "model": args.name,
        "kind": "generative" if generative else "compiled",
        "version": entry.version, "warmup_ms": round(entry.warmup_ms, 3),
        "device": str(device), "max_batch": service.max_batch,
        "batch_timeout_ms": service.batch_timeout_ms}
    if service.tier:
        info["tier"] = service.tier
    if extra_models:
        info["extra_models"] = [n for n, _ in extra_models]
    if generative:
        eng = entry.engine
        st = eng.stats
        info.update({
            "max_running": eng.max_running,
            "kv_pages": eng.pool.num_pages,
            "page_tokens": eng.pool.page_tokens,
            "max_context": eng.max_context,
            "speculative": st["speculative"], "spec_k": st["spec_k"],
            "spec_degraded": st["spec_degraded"],
            "prefix_sharing": st["prefix_sharing"],
            "prefix_degraded": st["prefix_degraded"]})
    print(json.dumps({"serving": info}), flush=True)
    try:
        signum = serving.serve_until_shutdown(server)
    finally:
        # snapshot before close(): close drains and drops the engines
        final_stats = service.stats
        server.server_close()
        service.close()
    print(json.dumps({"serving_stopped": {
        "signal": signum, "stats": final_stats}}), flush=True)
    return 0


def _tune_populations(program, batch, compute_dtype=None):
    """The tunable-kernel shape keys the program's ops hit: conv2d ops
    inside the conv3x3 kernel's population and mul gemms inside the
    matmul kernel's, the feed batch dim (-1) replaced by ``batch``.
    Returns ([(kernel, key)] deduplicated in declaration order, [keys of
    flash_attention ops]); the flash-attention space is not ported, so
    those are reported and not tuned. ``compute_dtype`` overrides the
    declared dtype of the conv and mul keys; it defaults to bfloat16 for
    a program under AMP, whose ops cast their operands before the tune
    dispatch looks up the key (a winner tuned at float32 would never
    hit), as in the JAX package.

    A declared dim of 0 is taken as the batch too: it is a reshape's
    "copy this input dim" that shape inference leaves in place (the
    transformer's attention output projection). The JAX package keys
    that gemm with m 0, a population no run dispatches (ROADMAP.md,
    faults of the reference)."""
    from .kernels.conv3x3 import supports_conv3x3
    from .kernels.matmul import supports_matmul

    if compute_dtype is None and getattr(program, "_amp", False):
        compute_dtype = "bfloat16"

    def shape_of(block, name):
        v = block._find_var_recursive(name)
        if v is None or v.shape is None:
            return None
        return tuple(batch if int(s) in (-1, 0) else int(s)
                     for s in v.shape)

    def run_dtype(block, name):
        if compute_dtype:
            return compute_dtype
        v = block._find_var_recursive(name)
        return str(getattr(v, "dtype", "float32") or "float32")

    out, seen, flash = [], set(), []

    def add(kernel, key):
        k = (kernel, tuple(sorted(key.items())))
        if k not in seen:
            seen.add(k)
            out.append((kernel, key))

    for block in program.blocks:
        for op in block.ops:
            if op.type == "conv2d":
                xs = shape_of(block, op.input("Input")[0])
                ws = shape_of(block, op.input("Filter")[0])
                if not xs or not ws or len(xs) != 4:
                    continue
                if supports_conv3x3(ws, op.attr("strides", [1, 1]),
                                    op.attr("paddings", [0, 0]),
                                    op.attr("dilations", [1, 1]),
                                    op.attr("groups", 1) or 1):
                    n, c, h, w = xs
                    add("conv3x3", {"n": n, "h": h, "w": w, "c": c,
                                    "o": int(ws[0]),
                                    "dtype": run_dtype(
                                        block, op.input("Input")[0])})
            elif op.type == "flash_attention":
                qs = shape_of(block, op.input("Q")[0])
                if qs and len(qs) == 4:
                    key = {"b": qs[0], "s": qs[1], "h": qs[2], "d": qs[3],
                           "causal": bool(op.attr("causal", False))}
                    if key not in flash:
                        flash.append(key)
            elif op.type == "mul":
                xs = shape_of(block, op.input("X")[0])
                ys = shape_of(block, op.input("Y")[0])
                if not xs or not ys:
                    continue
                xn = op.attr("x_num_col_dims", 1)
                yn = op.attr("y_num_col_dims", 1)
                m = k = n = 1
                for v in xs[:xn]:
                    m *= v
                for v in xs[xn:]:
                    k *= v
                for v in ys[yn:]:
                    n *= v
                dt = run_dtype(block, op.input("X")[0])
                if supports_matmul((m, k), (k, n), dt):
                    add("matmul", {"m": m, "k": k, "n": n, "dtype": dt})
    return out, flash


def _parse_mesh(spec, verb):
    """``'dp=4'`` -> {axis: size}. A malformed entry (no ``=``, a size
    that is not an integer of at least 1, an empty segment) is refused
    with a message (None): skipping it would price another mesh than the
    one asked for."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    mesh = {}
    for pair in spec.split(","):
        k, eq, v = pair.partition("=")
        try:
            if not (eq and k.strip()):
                raise ValueError("missing '='")
            size = int(v)
            if size < 1:
                raise ValueError("size < 1")
            mesh[k.strip()] = size
        except ValueError:
            print("%s: bad --mesh entry %r (want axis=size with "
                  "size >= 1, e.g. 'dp=8')" % (verb, pair))
            return None
    return mesh


def _append_train_step(verb, spec, main, startup):
    """Append the backward and the optimizer ops to ``main`` so that the
    memory pass prices the training step, not the forward alone: the
    config's optimizer, else the SGD ``train`` would use. True on
    success; a failing ``minimize`` is reported and leaves the forward
    program."""
    from . import optimizer
    from .core import ir
    if not (isinstance(spec, dict) and spec.get("cost") is not None):
        return False
    opt = spec.get("optimizer") or optimizer.SGD(learning_rate=0.01)
    try:
        with ir.program_guard(main, startup):
            opt.minimize(spec["cost"])
    except Exception as e:
        print("%s: could not append the backward (%s: %s); analysing "
              "the forward program only" % (verb, type(e).__name__, e))
        return False
    return True


def cmd_lint(args):
    """Statically verify the program a train config builds (the
    ``train`` contract: the file defines ``model()``); nothing runs.
    ``--memory`` adds the memory planner over the training step, its
    peak checked against ``--budget-gb`` or ``FLAGS.memory_budget_gb``
    (none known by default: lint touches no device). Exit 0 clean or
    warnings only, 1 on an error (any diagnostic with ``--strict``), 2
    when the config fails to build or a pass is asked for that the port
    lacks."""
    from . import analysis
    from .core import ir

    if args.comm or args.sharding or args.spec or args.all:
        print("lint: --comm, --sharding, --spec and --all need "
              "collectives and a mesh, which the port does not have yet "
              "(ROADMAP.md Queue 1 item 6)")
        return 2
    main, startup = ir.Program(), ir.Program()
    try:
        cfg = _load_config(args.config)
        with ir.program_guard(main, startup):
            spec = cfg.model()
    except Exception as e:
        print("lint: config %r failed to build: %s: %s"
              % (args.config, type(e).__name__, e))
        return 2
    fetches = None
    if isinstance(spec, dict) and spec.get("cost") is not None:
        # metrics count as fetch roots too: a trainer fetches them
        fetches = [spec["cost"]] + list(spec.get("metrics", ()))
    diags = analysis.verify(main, fetches=fetches)
    startup_diags = analysis.verify(startup)
    memory_diags = []
    reports = [("main program", diags), ("startup program", startup_diags)]
    if args.memory:
        from .analysis import memory as memory_mod
        mesh = _parse_mesh(args.mesh, "lint")
        if mesh is None:
            return 2
        ignored = sorted(a for a in mesh if a != "dp")
        if ignored:
            print("lint: --memory shards the batch over 'dp' only; "
                  "mesh axis(es) %s ignored (params priced replicated)"
                  % ", ".join(ignored))
        # the residency question is about the training step: the
        # structural rules above ran on the program as built
        train_step = _append_train_step("lint", spec, main, startup)
        budget = memory_mod.resolve_budget_bytes(
            budget_gb=args.budget_gb or None)
        plan, memory_diags = memory_mod.check_memory(
            main, budget_bytes=budget, batch=args.batch, fetches=fetches,
            dp=mesh.get("dp", 1))
        print("memory pass (%s program):"
              % ("train-step" if train_step else "forward-only"))
        print(plan.table(budget))
        reports.append(("memory pass", memory_diags))
    for label, ds in reports:
        report = analysis.render_diagnostics(ds, label=label)
        print(report if report else "%s: clean" % label)
    if args.dot:
        from . import debugger
        # errors fill red; the PT015+ dataflow findings at any severity
        bad_ops = {d.op_idx for d in diags
                   if d.block_idx == 0 and d.op_idx is not None
                   and (d.is_error or d.code >= "PT015")}
        debugger.draw_block_graphviz(main.global_block(),
                                     op_highlights=bad_ops, path=args.dot)
        print("lint: wrote %s (%d op(s) highlighted)"
              % (args.dot, len(bad_ops)))
    all_diags = diags + startup_diags + memory_diags
    failed = any(d.is_error for d in all_diags) \
        or (args.strict and all_diags)
    return 1 if failed else 0


def _fmt_config(cfg):
    if cfg.get("use") == "xla":
        return "xla"
    return ",".join("%s=%s" % kv for kv in sorted(cfg.items())) or "{}"


def cmd_tune(args):
    """Autotune the kernels a train config's program uses: enumerate
    each kernel's valid configs at the program's shapes, build, check
    parity with and time every candidate against the stock rung on the
    device, cache the winners per (device, shape) and print the winners
    table. ``--dry-run`` only enumerates."""
    from . import tune as tune_mod
    from .core import ir
    from .device import resolve_device
    from .flags import FLAGS
    from .tune import results as results_mod

    device = resolve_device(args.device)
    main, startup = ir.Program(), ir.Program()
    try:
        cfg_mod = _load_config(args.config)
        with ir.program_guard(main, startup):
            cfg_mod.model()
    except Exception as e:
        print("tune: config %r failed to build: %s: %s"
              % (args.config, type(e).__name__, e), file=sys.stderr)
        return 2
    pops, flash = _tune_populations(main, args.batch,
                                    compute_dtype=args.dtype or None)
    for key in flash:
        print("tune: flash_attention %s: not yet tunable in the port "
              "(skipped)" % tune_mod.signature(key))
    if not pops:
        print("tune: no tunable kernel populations in %r (conv3x3 / "
              "matmul shapes)" % args.config)
        return 0
    budget = args.budget if args.budget > 0 else (FLAGS.tune_budget or
                                                  None)
    if args.dry_run:
        # the loop's budget arithmetic (stock rung included), so the
        # printed count is what a run would time
        print("%-10s %-44s %10s" % ("kernel", "signature", "candidates"))
        for kernel, key in pops:
            cands = tune_mod.get_space(kernel).candidates(
                key, budget=(budget - 1) if budget else None)
            print("%-10s %-44s %10d" % (kernel, tune_mod.signature(key),
                                        len(cands) + 1))
        print("tune: dry run, nothing timed, nothing cached")
        return 0
    timer = {"wall": tune_mod.wall_timer, "model": tune_mod.model_timer,
             "auto": lambda: tune_mod.default_timer(device)}[args.timer]()
    from . import profiler as _prof
    rows, failed = [], 0
    cache = tune_mod.WinnerCache()
    print("%-10s %-44s %-34s %12s %6s" % ("kernel", "signature", "winner",
                                          "time", "cands"))
    for kernel, key in pops:
        res = tune_mod.autotune(kernel, key, timer=timer, budget=budget,
                                cache=cache, device=device)
        _prof.update_tune_counters(tune_loops=1,
                                   tune_candidates=len(res.records))
        rows.append(res.row())
        if not res.ok:
            failed += 1
            print("%-10s %-44s %-34s %12s %6d"
                  % (kernel, res.sig, "<NO ELIGIBLE CANDIDATE>", "-",
                     len(res.records)), flush=True)
            continue
        print("%-10s %-44s %-34s %10.4fms %6d"
              % (kernel, res.sig, _fmt_config(res.winner),
                 res.winner_seconds * 1e3, len(res.records)), flush=True)
    rec = results_mod.bench_record(
        "tune", rows, meta={"config": os.path.abspath(args.config),
                            "batch": args.batch, "budget": budget or 0,
                            "timer": getattr(timer, "kind", "custom"),
                            "device": str(device),
                            "cache_dir": cache.cache_dir})
    path = results_mod.write_result(rec, path=args.out)
    print("tune: %d population(s), %d failed; winners cached in %s; "
          "evidence %s" % (len(pops), failed, cache.path, path))
    return 1 if failed else 0


def _parser():
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch")
    sub = p.add_subparsers(dest="verb", required=True)
    t = sub.add_parser("train", help="train a model config")
    t.add_argument("config")
    t.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    t.add_argument("--num_passes", type=int, default=0,
                   help="0 = the config's num_passes")
    t.add_argument("--learning_rate", type=float, default=0.01,
                   help="SGD's rate when the config names no optimizer")
    t.add_argument("--log_period", type=int, default=10)
    t.add_argument("--checkpoint_dir", default="",
                   help="resume from, save to and preempt into this "
                        "directory")
    t.set_defaults(fn=cmd_train)
    s = sub.add_parser("serve", help="serve a compiled or generative "
                                     "artifact over HTTP")
    s.add_argument("artifact_dir")
    s.add_argument("--name", default="default",
                   help="model name in /v1/models/<name>:predict or "
                        ":generate")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080,
                   help="0 binds a free port (named on the readiness line)")
    s.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    s.add_argument("--max_running", type=int, default=0,
                   help="0 = FLAGS.serve_max_running")
    s.add_argument("--kv_pages", type=int, default=0,
                   help="0 = FLAGS.serve_kv_pages")
    s.add_argument("--page_tokens", type=int, default=0,
                   help="0 = FLAGS.serve_page_tokens")
    s.add_argument("--queue_depth", type=int, default=0,
                   help="0 = FLAGS.serve_queue_depth")
    s.add_argument("--max_batch", type=int, default=0,
                   help="compiled artifacts: 0 = FLAGS.serve_max_batch")
    s.add_argument("--batch_timeout_ms", type=float, default=-1.0,
                   help="compiled artifacts: negative = "
                        "FLAGS.serve_batch_timeout_ms")
    s.add_argument("--extra_model", action="append", default=[],
                   metavar="NAME=DIR",
                   help="another artifact served from the same process "
                        "(repeatable): a predict model and a generate "
                        "model side by side")
    s.add_argument("--draft_dir", default="",
                   help="a generative artifact to load as the draft "
                        "model of speculative decoding; empty defers to "
                        "FLAGS.serve_draft_dir or a speculative "
                        "artifact's own draft")
    s.add_argument("--spec_k", type=int, default=0,
                   help="speculation depth (0 = the pairing's k or "
                        "FLAGS.serve_spec_k)")
    s.add_argument("--prefix_sharing", "--prefix-sharing",
                   action="store_true",
                   help="copy-on-write prefix sharing over the KV pool "
                        "(default FLAGS.serve_prefix_sharing)")
    s.add_argument("--tier", default="", choices=["", "prefill", "decode"],
                   help="serving class in a disaggregated fleet, "
                        "advertised through /statz and /healthz (empty = "
                        "FLAGS.serve_tier, a do-everything replica by "
                        "default); every route stays served")
    s.set_defaults(fn=cmd_serve)
    tn = sub.add_parser("tune", help="autotune the kernels a train config "
                                     "uses; winners persist per device "
                                     "and shape")
    tn.add_argument("config")
    tn.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    tn.add_argument("--batch", type=int, default=8,
                    help="batch size substituted for the feed dim (-1) "
                         "when deriving kernel shapes")
    tn.add_argument("--dtype", default=None, choices=["float32"],
                    help="compute dtype of the conv/matmul keys (default: "
                         "the declared var dtype); the port's kernels take "
                         "float32 only")
    tn.add_argument("--budget", type=int, default=0,
                    help="cap on candidates per (kernel, shape), stock "
                         "rung included (0 = FLAGS.tune_budget)")
    tn.add_argument("--dry-run", action="store_true",
                    help="enumerate populations and candidate counts "
                         "only; nothing timed or cached")
    tn.add_argument("--timer", choices=["auto", "wall", "model"],
                    default="auto",
                    help="auto = the wall clock on cuda, the "
                         "deterministic model timer on the cpu")
    tn.add_argument("--out", default=None, metavar="PATH",
                    help="evidence-record path (default "
                         "build/tune/tune_<device>.json)")
    tn.set_defaults(fn=cmd_tune)
    li = sub.add_parser("lint", help="statically verify a train config's "
                                     "program (exit 1 on PT errors)")
    li.add_argument("config")
    li.add_argument("--dot", default=None, metavar="PATH",
                    help="write a graphviz .dot of the main block with "
                         "the failing ops highlighted")
    li.add_argument("--strict", action="store_true",
                    help="treat warnings as failures")
    li.add_argument("--memory", action="store_true",
                    help="run the static memory planner (PT030-PT033) "
                         "over the training step (backward and optimizer "
                         "appended) and print the residency table")
    li.add_argument("--budget-gb", type=float, default=0.0,
                    dest="budget_gb",
                    help="per-device budget for --memory (GiB; 0 = "
                         "FLAGS.memory_budget_gb, which at 0 leaves PT030 "
                         "unchecked)")
    li.add_argument("--batch", type=int, default=16,
                    help="global batch for the feed wildcard dim (-1) in "
                         "the --memory pass")
    li.add_argument("--mesh", default="dp=1",
                    help="mesh of the --memory pass, 'dp=N': the batch "
                         "shards over dp, params replicate")
    for flag in ("--comm", "--sharding", "--all"):
        li.add_argument(flag, action="store_true",
                        help="not in the port yet: exits 2 (ROADMAP.md "
                             "Queue 1 item 6)")
    li.add_argument("--spec", action="append", default=None,
                    metavar="VAR=SPEC",
                    help="not in the port yet: exits 2 (ROADMAP.md Queue "
                         "1 item 6)")
    li.set_defaults(fn=cmd_lint)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    return args.fn(args)
