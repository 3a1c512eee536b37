"""Command line of the port: the ``train`` and ``serve`` verbs
(counterparts of ``paddle_tpu/cli.py:cmd_train`` and of ``cmd_serve`` for
generative artifacts).

    python -m paddle_tpu_torch train <config.py> [--device cuda|cpu]
        [--num_passes N] [--log_period K] [--learning_rate LR]

loads the config file, calls its ``model()`` (a dict with ``cost``,
``feed_list``, ``reader`` and optionally ``optimizer`` and
``num_passes``), trains it with the port's Trainer on the device and
prints ``pass P batch B cost C`` for every K-th batch and a line at the
end of each pass.

    python -m paddle_tpu_torch serve <artifact_dir> --port 0 [--device cuda]

validates the artifact (exit 1 with the problems on a bad one), loads it
onto the device, warms the engine, prints one JSON readiness line
``{"serving": {"host", "port", ...}}`` (``--port 0`` binds a free port
and this line names it), and serves ``POST /v1/models/<name>:generate``
until SIGTERM or SIGINT. Then it drains in-flight generations, prints
``{"serving_stopped": {"signal", "stats"}}`` and exits 0.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
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
                         feed_list=spec["feed_list"], device=args.device)

    def handler(e):
        if isinstance(e, trainer.EndIteration):
            if e.batch_id % args.log_period == 0:
                print("pass %d batch %d cost %.5f"
                      % (e.pass_id, e.batch_id, e.cost), flush=True)
        elif isinstance(e, trainer.EndPass):
            print("pass %d done: %s" % (e.pass_id, e.metrics), flush=True)

    tr.train(spec["reader"],
             num_passes=args.num_passes or spec.get("num_passes", 1),
             event_handler=handler)
    return 0


def cmd_serve(args):
    from . import inference, serving
    problems = inference.validate_generative_artifact(args.artifact_dir)
    if not problems and not inference.is_generative_artifact(
            args.artifact_dir):
        problems = ["not a generative artifact (no %s)"
                    % inference.GEN_CONFIG_FILE]
    if problems:
        print("serve: cannot serve %r:" % args.artifact_dir,
              file=sys.stderr)
        for p in problems:
            print("  - " + p, file=sys.stderr)
        return 1
    service = serving.InferenceService(queue_depth=args.queue_depth or None)
    knobs = {k: getattr(args, k) for k in ("max_running", "kv_pages",
                                           "page_tokens")
             if getattr(args, k)}
    try:
        entry = service.load_model(args.name, args.artifact_dir,
                                   device=args.device, **knobs)
    except Exception as e:
        print("serve: failed to load %r: %s: %s"
              % (args.artifact_dir, type(e).__name__, e), file=sys.stderr)
        service.close()
        return 1
    server = serving.make_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    eng = entry.engine
    print(json.dumps({"serving": {
        "host": host, "port": port, "model": args.name,
        "kind": "generative", "version": entry.version,
        "warmup_ms": round(entry.warmup_ms, 3),
        "device": str(eng.device), "max_running": eng.max_running,
        "kv_pages": eng.pool.num_pages,
        "page_tokens": eng.pool.page_tokens,
        "max_context": eng.max_context}}), flush=True)
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
    t.set_defaults(fn=cmd_train)
    s = sub.add_parser("serve", help="serve a generative artifact over "
                                     "HTTP")
    s.add_argument("artifact_dir")
    s.add_argument("--name", default="default",
                   help="model name in /v1/models/<name>:generate")
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
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    return args.fn(args)
