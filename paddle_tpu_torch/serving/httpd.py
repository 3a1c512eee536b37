"""Stdlib JSON/HTTP front end over :class:`InferenceService` (the
``:generate`` part of ``paddle_tpu/serving/httpd.py``, same bodies and
answers).

====== ================================ ===================================
method path                             body / response
====== ================================ ===================================
POST   ``/v1/models/<name>:generate``   ``{"tokens": [ids],
                                        "max_new_tokens": N,
                                        "temperature": t, "seed": s,
                                        "deadline_ms": optional,
                                        "spec_k": optional}`` ->
                                        ``{"model": name, "version": v,
                                        "tokens": [...],
                                        "finish_reason": ...,
                                        "ttft_ms": ..., ...}``
GET    ``/healthz``                     liveness, models, readiness
GET    ``/statz``                       ``InferenceService.stats``
====== ================================ ===================================

``spec_k`` caps the request's speculation depth on a speculative engine
(0: plain decode); other engines ignore it.

Errors: 429 overload and kv-pool exhaustion (with a ``Retry-After``
header and a ``retry_after_ms`` body field), 504 deadline, 404 unknown
model or route, 400 malformed input, 500 anything else; each body is
``{"error": ..., "kind": ...}``. One thread per connection blocks in
``generate`` while the engine thread batches across them.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .admission import (DeadlineExceededError, ModelUnavailableError,
                        OverloadError)
from .kvcache import PoolExhausted

__all__ = ["make_server", "serve_until_shutdown"]

_MAX_BODY = 64 * 1024 * 1024


def write_json_reply(handler, code, payload, retry_after_ms=None):
    """Serialize one JSON answer; a 429 carries the back-off hint both as
    an integral ``Retry-After`` header and as ``retry_after_ms``."""
    if retry_after_ms is not None:
        payload = dict(payload)
        payload["retry_after_ms"] = round(float(retry_after_ms), 3)
    body = json.dumps(payload).encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    if retry_after_ms is not None:
        handler.send_header("Retry-After",
                            str(max(1, int(-(-retry_after_ms // 1000)))))
    handler.end_headers()
    handler.wfile.write(body)


def read_json_body(handler):
    """One request's JSON object body; ValueError on an oversized or
    non-object body (the caller answers 400)."""
    n = int(handler.headers.get("Content-Length") or 0)
    if n > _MAX_BODY:
        raise ValueError("request body too large (%d bytes)" % n)
    raw = handler.rfile.read(n) if n else b"{}"
    body = json.loads(raw.decode("utf-8"))
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    return body


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "paddle_tpu_torch-serve"

    def log_message(self, fmt, *args):
        # per-request logging would serialize every request on stderr
        pass

    @property
    def service(self):
        return self.server.service

    def _reply(self, code, payload, retry_after_ms=None):
        write_json_reply(self, code, payload, retry_after_ms=retry_after_ms)

    def _retry_hint(self, model):
        try:
            return self.service.retry_after_ms(model)
        except Exception:           # the hint must never fail the shed
            return 1000.0

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True,
                              "models": self.service.model_info(),
                              "ready": self.service.readiness()})
        elif self.path == "/statz":
            self._reply(200, self.service.stats)
        else:
            self._reply(404, {"error": "no route %r" % self.path,
                              "kind": "not_found"})

    def do_POST(self):
        try:
            body = read_json_body(self)
        except Exception as e:
            # the body may be partly unread: replying on a keep-alive
            # connection would parse the rest as the next request
            self.close_connection = True
            return self._reply(400, {"error": "bad JSON body: %s" % e,
                                     "kind": "bad_request"})
        if self.path.startswith("/v1/models/") and \
                self.path.endswith(":generate"):
            name = self.path[len("/v1/models/"):-len(":generate")]
            return self._generate(name, body)
        self._reply(404, {"error": "no route %r" % self.path,
                          "kind": "not_found"})

    def _generate(self, name, body):
        try:
            tokens = body.get("tokens")
            if not isinstance(tokens, list) or not tokens:
                raise ValueError('body must carry {"tokens": '
                                 "[token ids]}")
            spec_k = body.get("spec_k")
            req = self.service.generate_async(
                name, tokens,
                max_new_tokens=int(body.get("max_new_tokens", 16)),
                temperature=float(body.get("temperature", 0.0)),
                seed=int(body.get("seed", 0)),
                deadline_ms=body.get("deadline_ms"),
                spec_k=None if spec_k is None else int(spec_k))
            res = req.wait()
        except ModelUnavailableError as e:
            return self._reply(404, {"error": str(e),
                                     "kind": "model_unavailable"})
        except PoolExhausted as e:
            return self._reply(429, {"error": str(e),
                                     "kind": "kv_pool_exhausted"},
                               retry_after_ms=self._retry_hint(name))
        except OverloadError as e:
            return self._reply(429, {"error": str(e), "kind": "overload"},
                               retry_after_ms=self._retry_hint(name))
        except DeadlineExceededError as e:
            return self._reply(504, {"error": str(e), "kind": "deadline"})
        except (TypeError, ValueError) as e:
            return self._reply(400, {"error": str(e),
                                     "kind": "bad_request"})
        except Exception as e:
            return self._reply(500, {"error": repr(e), "kind": "dispatch"})
        out = {"model": name, "version": req.model_version}
        out.update(res.describe())
        self._reply(200, out)


def make_server(service, host="127.0.0.1", port=0):
    """Bind a :class:`ThreadingHTTPServer` over ``service``; ``port=0``
    picks a free port (read it back from ``server.server_address``).
    The caller owns ``serve_forever()`` / ``shutdown()``."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    server.service = service
    return server


def serve_until_shutdown(server, signals=None):
    """``serve_forever`` until one of ``signals`` (default SIGTERM and
    SIGINT) arrives; the signal trips ``server.shutdown()`` from a helper
    thread (calling it on the serving thread would deadlock). Returns
    the signal number, or None after an external ``shutdown()``. Must
    run on the main thread; restores the previous handlers."""
    import signal as _signal
    import threading
    signals = signals if signals is not None else (_signal.SIGTERM,
                                                   _signal.SIGINT)
    stopped = {"signum": None}
    previous = {}

    def on_signal(signum, frame):
        stopped["signum"] = signum
        threading.Thread(target=server.shutdown, daemon=True).start()

    for s in signals:
        previous[s] = _signal.signal(s, on_signal)
    try:
        server.serve_forever(poll_interval=0.1)
    finally:
        for s, h in previous.items():
            _signal.signal(s, h)
    return stopped["signum"]
