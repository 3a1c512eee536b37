"""Stdlib JSON/HTTP front end over :class:`InferenceService`
(counterpart of ``paddle_tpu/serving/httpd.py`` without the router's
routes: same bodies and answers).

====== ================================ ===================================
method path                             body / response
====== ================================ ===================================
POST   ``/v1/models/<name>:predict``    ``{"inputs": {feed: nested list},
                                        "deadline_ms": optional}`` ->
                                        ``{"model": name, "version": v,
                                        "fetch_names": [...],
                                        "outputs": [nested lists]}``
POST   ``/v1/models/<name>:reload``     ``{"dirname": path}`` ->
                                        ``{"model", "version",
                                        "warmup_ms"}``; 409 with
                                        ``serving_version`` when the load
                                        fails and the old version stays
POST   ``/v1/models/<name>:generate``   ``{"tokens": [ids],
                                        "max_new_tokens": N,
                                        "temperature": t, "seed": s,
                                        "deadline_ms": optional,
                                        "spec_k": optional}`` ->
                                        ``{"model": name, "version": v,
                                        "tokens": [...],
                                        "finish_reason": ...,
                                        "ttft_ms": ..., ...}``
POST   ``/v1/models/<name>:prefill``    ``{"tokens": [ids],
                                        "max_new_tokens": N,
                                        "temperature": t, "seed": s}`` ->
                                        ``{"model": name, "artifact":
                                        payload}``, the handoff artifact's
                                        wire payload (the prefill tier's
                                        half of the disaggregated hop)
POST   ``/v1/models/<name>:decode``     ``{"artifact": payload,
                                        "deadline_ms": optional}`` -> the
                                        ``:generate`` answer (the decode
                                        tier's half; a hop that fails
                                        prefills here again)
GET    ``/healthz``                     liveness, tier, models, readiness
GET    ``/statz``                       ``InferenceService.stats``
                                        (``tier`` among them)
GET    ``/v1/models``                   ``InferenceService.model_info``
====== ================================ ===================================

``spec_k`` caps the request's speculation depth on a speculative engine
(0: plain decode); other engines ignore it. A ``:decode`` body may be
as large as the largest handoff payload of the named model's pool
geometry (``InferenceService.handoff_body_limit``: the base64 K/V pages
of a prompt that fills the context, about 100 MB for GPT-2 small),
since a long prompt's pages are past ``_MAX_BODY``, the limit of the
other bodies and of a ``:decode`` to a model not served.

Errors: 429 overload and kv-pool exhaustion (with a ``Retry-After``
header and a ``retry_after_ms`` body field), 504 deadline (``:predict``,
``:generate`` and ``:decode``), 404 unknown model or route, 400 malformed input (a
malformed artifact included), 500 anything else (a failed batch of
``:predict``, a kernel that did not build or launch among them); each
body is ``{"error": ..., "kind": ...}``. One thread per connection
blocks in ``infer`` or ``generate`` while the dispatch thread or the
engine thread batches across them.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

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


def read_json_body(handler, limit=_MAX_BODY):
    """One request's JSON object body; ValueError on a body past
    ``limit`` bytes or not an object (the caller answers 400)."""
    n = int(handler.headers.get("Content-Length") or 0)
    if n > limit:
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
            self._reply(200, {"ok": True, "tier": self.service.tier,
                              "models": self.service.model_info(),
                              "ready": self.service.readiness()})
        elif self.path == "/statz":
            self._reply(200, self.service.stats)
        elif self.path == "/v1/models":
            self._reply(200, self.service.model_info())
        else:
            self._reply(404, {"error": "no route %r" % self.path,
                              "kind": "not_found"})

    def do_POST(self):
        route = name = None
        if self.path.startswith("/v1/models/") and ":" in self.path:
            name, _, route = self.path[len("/v1/models/"):].rpartition(":")
        handler = {"predict": self._predict, "generate": self._generate,
                   "prefill": self._prefill, "decode": self._decode,
                   "reload": self._reload}.get(route)
        try:
            body = read_json_body(self, limit=self._body_limit(route, name))
        except Exception as e:
            # the body may be partly unread: replying on a keep-alive
            # connection would parse the rest as the next request
            self.close_connection = True
            return self._reply(400, {"error": "bad JSON body: %s" % e,
                                     "kind": "bad_request"})
        if handler is None or not name:
            return self._reply(404, {"error": "no route %r" % self.path,
                                     "kind": "not_found"})
        handler(name, body)

    def _body_limit(self, route, name):
        """A ``:decode`` body carries K/V pages: its limit follows the
        named model's pool geometry. Every other body, and a ``:decode``
        to a model not served (answered 404 once read), gets
        ``_MAX_BODY``."""
        if route == "decode" and name:
            try:
                return self.service.handoff_body_limit(name)
            except ModelUnavailableError:
                pass
        return _MAX_BODY

    def _answer(self, name, call):
        """Run ``call`` and map its exceptions to the error answers: the
        one error mapping of every POST route. Returns the call's value,
        or None once an error answer is sent."""
        try:
            return call()
        except ModelUnavailableError as e:
            self._reply(404, {"error": str(e), "kind": "model_unavailable"})
        except PoolExhausted as e:
            self._reply(429, {"error": str(e), "kind": "kv_pool_exhausted"},
                        retry_after_ms=self._retry_hint(name))
        except OverloadError as e:
            self._reply(429, {"error": str(e), "kind": "overload"},
                        retry_after_ms=self._retry_hint(name))
        except DeadlineExceededError as e:
            self._reply(504, {"error": str(e), "kind": "deadline"})
        except (TypeError, ValueError) as e:
            self._reply(400, {"error": str(e), "kind": "bad_request"})
        except Exception as e:
            self._reply(500, {"error": repr(e), "kind": "dispatch"})
        return None

    def _predict(self, name, body):
        def call():
            entry = self.service.registry.get(name)
            inputs = body.get("inputs")
            if not isinstance(inputs, dict):
                raise ValueError('body must carry {"inputs": {name: '
                                 "nested-list}}")
            # only convert here (JSON nested lists -> the exported
            # dtype); the signature is checked once, by the service
            spec = entry.model.feed_spec
            feed = {fn: np.asarray(inputs[fn], dtype=dtype)
                    for fn, (_, dtype) in spec.items() if fn in inputs}
            req = self.service.infer_async(
                name, feed, deadline_ms=body.get("deadline_ms"))
            return entry, req, req.wait()
        done = self._answer(name, call)
        if done is None:
            return
        # the version that served the request, set at dispatch: the
        # JAX package answers with the one published at admission,
        # which a hot reload in between makes wrong (Queue 3 #40)
        entry, req, rows = done
        self._reply(200, {
            "model": name, "version": req.version,
            "fetch_names": list(entry.model.fetch_names),
            "outputs": [np.asarray(r).tolist() for r in rows]})

    def _reload(self, name, body):
        dirname = body.get("dirname")
        if not dirname:
            return self._reply(400, {"error": 'reload wants {"dirname": '
                                              "path}",
                                     "kind": "bad_request"})
        try:
            entry = self.service.reload_model(name, dirname)
        except Exception as e:
            # the previously published version keeps serving
            kept = None
            try:
                kept = self.service.registry.get(name).version
            except ModelUnavailableError:
                pass
            return self._reply(409, {"error": repr(e), "kind": "reload",
                                     "serving_version": kept})
        self._reply(200, {"model": name, "version": entry.version,
                          "warmup_ms": entry.warmup_ms})

    def _generate(self, name, body):
        def call():
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
            return req, req.wait()
        self._reply_result(name, self._answer(name, call))

    def _prefill(self, name, body):
        """The prefill tier's half of the hop: only the prompt pass,
        answered with the handoff artifact's wire payload."""
        def call():
            tokens = body.get("tokens")
            if not isinstance(tokens, list) or not tokens:
                raise ValueError('body must carry {"tokens": '
                                 "[token ids]}")
            return self.service.prefill(
                name, tokens,
                max_new_tokens=int(body.get("max_new_tokens", 16)),
                temperature=float(body.get("temperature", 0.0)),
                seed=int(body.get("seed", 0)))
        art = self._answer(name, call)
        if art is not None:
            self._reply(200, {"model": name, "artifact": art.to_payload()})

    def _decode(self, name, body):
        """The decode tier's half: install a shipped artifact into
        ``name``'s engine and decode to the end. A malformed artifact is
        the sender's fault (400); a failed install prefills here again
        and still answers 200."""
        def call():
            payload = body.get("artifact")
            if not isinstance(payload, dict):
                raise ValueError('body must carry {"artifact": '
                                 "handoff payload}")
            req = self.service.decode_handoff_async(
                name, payload, deadline_ms=body.get("deadline_ms"))
            return req, req.wait()
        self._reply_result(name, self._answer(name, call))

    def _reply_result(self, name, done):
        if done is None:
            return
        req, res = done
        out = {"model": name, "version": req.model_version}
        out.update(res.describe())
        self._reply(200, out)


class _Server(ThreadingHTTPServer):
    # the listen backlog: the stdlib's 5 resets the connections of a
    # burst of concurrent clients past it before a thread accepts them
    request_queue_size = 128


def make_server(service, host="127.0.0.1", port=0):
    """Bind a :class:`ThreadingHTTPServer` over ``service``; ``port=0``
    picks a free port (read it back from ``server.server_address``).
    The caller owns ``serve_forever()`` / ``shutdown()``."""
    server = _Server((host, port), _Handler)
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
