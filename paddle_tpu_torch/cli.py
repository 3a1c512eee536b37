"""Command line of the port: the ``serve`` verb (counterpart of
``paddle_tpu/cli.py:cmd_serve`` for generative artifacts).

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
import json
import sys

__all__ = ["main"]


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
