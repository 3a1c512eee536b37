"""The ``:predict`` serving tier of the port: twins of the 17 tests of
``tests/test_serving.py`` on ``device="cpu"``.

Contracts under test, as in the JAX suite: batched responses
bit-identical to ``CompiledModel.run`` of the request alone; batch
occupancy above 1 under concurrent load; deadline-exceeded and
overloaded requests shed with recorded events and without hangs; a
dispatch fault fails its batch and not the service; hot reload swaps
versions atomically behind in-flight requests and rolls back on a
warm-up fault armed through the ``PADDLE_TPU_FAULT_SPEC`` grammar; every
bucket warm after load (no capture on the request path); the service's
stats and the profiler's ``serving`` section; the HTTP ``:predict`` and
``:reload`` routes with JAX's status codes; and the ``serve`` CLI verb
(exit 1 on a bad artifact, HTTP, exit 0 on SIGTERM). Where the JAX test
reads a number (occupancy, counters, status codes), the twin asserts the
same number. The served outputs are also held to the JAX package's
``CompiledModel`` of the same weights (1e-6, ``OUT_TOL``).
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import profiler
from paddle_tpu_torch import resilience
from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch import initializer, layers
from paddle_tpu_torch.param_attr import ParamAttr
from paddle_tpu_torch.inference import ArtifactError
from paddle_tpu_torch.resilience import events
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      InferenceService, ModelUnavailableError,
                                      OverloadError, ServingError, bucket_for,
                                      make_server, padding_buckets)

DIM = 6
ROWS = 4
OUT = 3
OUT_TOL = 1e-6


def _export(dirname, scale):
    """Export y = x @ W with W constant-filled by ``scale``: outputs are
    row sums times scale, so the v1 and v2 artifacts are told apart."""
    main, startup = ir.Program(), ir.Program()
    with unique_name.guard(), ir.program_guard(main, startup):
        x = layers.data("x", shape=[DIM], dtype="float32")
        w = ParamAttr(name="serve_w",
                      initializer=initializer.ConstantInitializer(scale))
        out = layers.fc(x, size=OUT, param_attr=w, bias_attr=False,
                        act=None)
    from paddle_tpu_torch.core.executor import Executor
    scope = Scope()
    Executor("cpu").run(startup, scope=scope)
    tinf.export_compiled(
        dirname, ["x"], [out], None, main_program=main,
        example_feed={"x": np.zeros((ROWS, DIM), np.float32)}, scope=scope)
    return dirname


@pytest.fixture(scope="module")
def art_v1(tmp_path_factory):
    return _export(str(tmp_path_factory.mktemp("serving") / "v1"), 0.5)


@pytest.fixture(scope="module")
def art_v2(tmp_path_factory):
    return _export(str(tmp_path_factory.mktemp("serving") / "v2"), 1.0)


@pytest.fixture(autouse=True)
def _clean_faults():
    resilience.reset()
    resilience.clear_events()
    yield
    resilience.reset()


def _service(**kw):
    return InferenceService(**kw)


def _load(svc, name, art, **kw):
    return svc.load_model(name, art, device="cpu", **kw)


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(ROWS, DIM).astype(np.float32) for _ in range(n)]


def _expected(x, scale):
    return np.repeat(x.sum(axis=1, keepdims=True) * scale, OUT, axis=1)


def _run_alone(art, f):
    return tinf.load_compiled(art, device="cpu").run({"x": f})[0].numpy()


# -- buckets ------------------------------------------------------------------

def test_padding_buckets():
    assert padding_buckets(8) == [1, 2, 4, 8]
    assert padding_buckets(6) == [1, 2, 4, 6]
    assert padding_buckets(1) == [1]
    assert bucket_for(3, [1, 2, 4, 8]) == 4
    assert bucket_for(1, [1, 2, 4]) == 1
    assert bucket_for(9, [1, 2, 4, 8]) == 8  # capped at max_batch


# -- batching: bit-identity + occupancy ---------------------------------------

def test_batched_bit_identical_and_occupancy(art_v1):
    import paddle_tpu as jpt
    feeds = _feeds(12, seed=1)
    model = tinf.load_compiled(art_v1, device="cpu")
    want = [model.run({"x": f})[0].numpy() for f in feeds]
    with _service(max_batch=4, batch_timeout_ms=50, queue_depth=32) as svc:
        _load(svc, "m", art_v1)
        results = [None] * len(feeds)

        def worker(i):
            results[i] = svc.infer("m", {"x": feeds[i]})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(feeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = svc.stats
    for i in range(len(feeds)):
        np.testing.assert_array_equal(results[i][0], want[i])
        np.testing.assert_allclose(results[i][0],
                                   _expected(feeds[i], 0.5), rtol=1e-4)
    # the JAX package's artifact of the same weights agrees
    with jpt.scope_guard(jpt.Scope()):
        main, startup = jpt.Program(), jpt.Program()
        with jpt.program_guard(main, startup):
            x = jpt.layers.data("x", shape=[DIM], dtype="float32")
            out = jpt.layers.fc(
                x, size=OUT, bias_attr=False, act=None,
                param_attr=jpt.ParamAttr(
                    name="serve_w",
                    initializer=jpt.initializer.ConstantInitializer(0.5)))
        exe = jpt.Executor(jpt.CPUPlace())
        exe.run(startup)
        jd = os.path.join(os.path.dirname(art_v1), "jax_v1")
        jpt.inference.export_compiled(
            jd, ["x"], [out], exe, main_program=main,
            example_feed={"x": np.zeros((ROWS, DIM), np.float32)})
    jmodel = jpt.inference.load_compiled(jd)
    for i in range(len(feeds)):
        jw = np.asarray(jmodel.run({"x": feeds[i]})[0])
        assert np.abs(results[i][0] - jw).max() <= OUT_TOL
    assert st["completed"] == len(feeds)
    assert st["max_occupancy"] > 1           # coalescing really happened
    assert st["batches"] < len(feeds)
    assert st["batch_occupancy"] > 1.0
    assert st["latency_ms_p99"] >= st["latency_ms_p50"] > 0.0


def test_padded_bucket_stays_exact(art_v1):
    # 3 concurrent requests, max_batch 4 -> bucket 4, one padded row
    # counted as in the JAX package (the port runs the live rows alone):
    # live rows unaffected
    feeds = _feeds(3, seed=2)
    want = [_run_alone(art_v1, f) for f in feeds]
    with _service(max_batch=4, batch_timeout_ms=100, queue_depth=32) as svc:
        _load(svc, "m", art_v1)
        results = [None] * 3
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, svc.infer("m", {"x": feeds[i]}))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = svc.stats
    for got, w in zip(results, want):
        np.testing.assert_array_equal(got[0], w)
    if st["batches"] == 1:       # all three coalesced (the usual case)
        assert st["padded_rows"] == 1


def test_single_request_no_concurrency(art_v1):
    f = _feeds(1, seed=3)[0]
    with _service(max_batch=8, batch_timeout_ms=0, queue_depth=8) as svc:
        _load(svc, "m", art_v1)
        got = svc.infer("m", {"x": f})
        np.testing.assert_array_equal(got[0], _run_alone(art_v1, f))
        assert svc.stats["batches"] == 1
        assert svc.stats["batch_occupancy"] == 1.0


# -- admission control --------------------------------------------------------

def test_deadline_exceeded_is_shed_not_hung(art_v1):
    with _service(max_batch=4, batch_timeout_ms=0, queue_depth=8) as svc:
        _load(svc, "m", art_v1)
        f = _feeds(1, seed=4)[0]
        # an expired deadline: shed at dispatch, never served
        with pytest.raises(DeadlineExceededError):
            svc.infer("m", {"x": f}, deadline_ms=-1, timeout=30)
        # a sane deadline still serves
        out = svc.infer("m", {"x": f}, deadline_ms=30_000)
        assert np.asarray(out[0]).shape == (ROWS, OUT)
        assert svc.stats["shed_deadline"] == 1
    evs = events.events(kind="request_shed", site="serving.dispatch")
    assert evs and evs[0]["reason"] == "deadline"


def test_overload_is_shed_with_event(art_v1):
    # a slow device (a delay at the dispatch edge) backs the queue up
    # into admission control; request queue_depth + 1 is refused now
    resilience.arm("serving.dispatch", action="delay", delay=0.3,
                   nth=1, times=None)
    svc = _service(max_batch=1, batch_timeout_ms=0, queue_depth=2)
    try:
        _load(svc, "m", art_v1)
        feeds = _feeds(4, seed=5)
        first = svc.infer_async("m", {"x": feeds[0]})
        deadline = time.monotonic() + 5.0
        while svc._batcher.pending() and time.monotonic() < deadline:
            time.sleep(0.005)   # wait for it to enter the slow dispatch
        q1 = svc.infer_async("m", {"x": feeds[1]})
        q2 = svc.infer_async("m", {"x": feeds[2]})
        with pytest.raises(OverloadError):
            svc.infer("m", {"x": feeds[3]})
        assert svc.stats["shed_overload"] == 1
        resilience.disarm("serving.dispatch")
        for h in (first, q1, q2):       # the admitted ones still finish
            assert np.asarray(h.wait(timeout=30)[0]).shape == (ROWS, OUT)
    finally:
        svc.close()
    evs = events.events(kind="request_shed", site="serving.admission")
    assert evs and evs[0]["reason"] == "overload"


def test_dispatch_fault_fails_batch_not_service(art_v1):
    resilience.arm("serving.dispatch", action="raise", nth=1, times=1)
    with _service(max_batch=4, batch_timeout_ms=0, queue_depth=8) as svc:
        _load(svc, "m", art_v1)
        f = _feeds(1, seed=6)[0]
        with pytest.raises(resilience.FaultError):
            svc.infer("m", {"x": f}, timeout=30)
        # the dispatch loop survived the failed batch
        out = svc.infer("m", {"x": f}, timeout=30)
        assert np.asarray(out[0]).shape == (ROWS, OUT)
        assert svc.stats["failed"] == 1
    assert events.events(kind="batch_failed", site="serving.dispatch")


def test_closed_service_rejects_and_fails_queued(art_v1):
    svc = _service(max_batch=4, batch_timeout_ms=0, queue_depth=8)
    _load(svc, "m", art_v1)
    svc.close()
    with pytest.raises(ServingError):
        svc.infer("m", {"x": _feeds(1)[0]})


def test_unknown_model_and_missing_feed(art_v1):
    with _service(max_batch=2, batch_timeout_ms=0, queue_depth=8) as svc:
        with pytest.raises(ModelUnavailableError):
            svc.infer("nope", {"x": _feeds(1)[0]})
        _load(svc, "m", art_v1)
        with pytest.raises(ValueError, match="missing"):
            svc.infer("m", {"y": _feeds(1)[0]})


# -- registry: hot reload + rollback ------------------------------------------

def test_hot_reload_swaps_behind_in_flight_requests(art_v1, art_v2):
    feeds = _feeds(40, seed=7)
    with _service(max_batch=4, batch_timeout_ms=1, queue_depth=64) as svc:
        assert _load(svc, "m", art_v1).version == 1
        outputs, errors = [], []
        stop = threading.Event()

        def client():
            i = 0
            while not stop.is_set():
                f = feeds[i % len(feeds)]
                try:
                    outputs.append((f, svc.infer("m", {"x": f},
                                                 timeout=30)[0]))
                except Exception as e:      # no request may fail mid-swap
                    errors.append(e)
                i += 1

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.1)                     # in-flight traffic on v1
        entry = svc.reload_model("m", art_v2)
        time.sleep(0.1)                     # traffic continues on v2
        stop.set()
        for t in threads:
            t.join()
        assert entry.version == 2
        assert str(entry.model.device) == "cpu"   # the served version's
        assert not errors
        assert len(outputs) > 0
        for f, out in outputs:
            w1, w2 = _expected(f, 0.5), _expected(f, 1.0)
            ok = (np.allclose(out, w1, rtol=1e-4)
                  or np.allclose(out, w2, rtol=1e-4))
            assert ok, "response matches neither version's weights"
        # after the swap, fresh requests are served by v2
        f = feeds[0]
        np.testing.assert_allclose(svc.infer("m", {"x": f})[0],
                                   _expected(f, 1.0), rtol=1e-4)
        assert svc.stats["models"]["m"] == 2
    assert events.events(kind="model_loaded", site="serving.reload")


def test_reload_rollback_on_warmup_fault(art_v1, art_v2, monkeypatch):
    """A warm-up fault armed through the PADDLE_TPU_FAULT_SPEC grammar
    makes the reload fail: the previous version keeps serving and the
    rollback is a recorded event."""
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC",
                       "serving.reload:raise:nth=1,times=1")
    with _service(max_batch=2, batch_timeout_ms=0, queue_depth=8) as svc:
        _load(svc, "m", art_v1, warm=False)       # load before arming
        resilience.load_fault_spec()               # arm from the env var
        with pytest.raises(resilience.FaultError):
            svc.reload_model("m", art_v2)
        assert svc.registry.get("m").version == 1
        f = _feeds(1, seed=8)[0]
        np.testing.assert_allclose(svc.infer("m", {"x": f})[0],
                                   _expected(f, 0.5), rtol=1e-4)
        evs = events.events(kind="reload_rollback", site="serving.reload")
        assert evs and evs[0]["kept_version"] == 1
        # the fault window has passed: the next reload goes through
        assert svc.reload_model("m", art_v2).version == 2
        np.testing.assert_allclose(svc.infer("m", {"x": f})[0],
                                   _expected(f, 1.0), rtol=1e-4)


def test_initial_load_failure_is_readable(tmp_path):
    with _service(max_batch=2, batch_timeout_ms=0, queue_depth=8) as svc:
        with pytest.raises(ArtifactError, match="does not exist"):
            _load(svc, "m", str(tmp_path / "nope"))
        with pytest.raises(ModelUnavailableError):
            svc.infer("m", {"x": _feeds(1)[0]})


def test_warmup_pretriggers_every_bucket(art_v1):
    """The warm-up runs the one-request step's eager run and its capture,
    which every bucket's run_many replays, so serving depths 2 and 4 add
    no compiled step and no capture (the JAX scan adds no trace)."""
    with _service(max_batch=4, batch_timeout_ms=0, queue_depth=8) as svc:
        entry = _load(svc, "m", art_v1)
        assert entry.warm_buckets == (1, 2, 4)
        assert entry.warmup_ms > 0.0
        model = entry.model
        before = model.stats
        assert before["compiled_steps"] == 1
        feeds = _feeds(4, seed=9)
        model.run_many({"x": np.stack(feeds[:2])})
        model.run_many({"x": np.stack(feeds)})
        after = model.stats
        assert after["compiled_steps"] == before["compiled_steps"]
        assert after["graph_captures"] == before["graph_captures"]
        assert after["eager_runs"] == before["eager_runs"] == 0


# -- metrics ------------------------------------------------------------------

def test_stats_and_profiler_serving_section(art_v1, tmp_path):
    profiler.reset_serving_counters()
    with _service(max_batch=4, batch_timeout_ms=0, queue_depth=8) as svc:
        _load(svc, "m", art_v1)
        for f in _feeds(5, seed=10):
            svc.infer("m", {"x": f})
        st = svc.stats
    assert st["requests"] == 5 and st["completed"] == 5
    assert st["batches"] >= 1
    assert st["latency_ms_p50"] > 0 and st["queue_wait_ms_p99"] >= 0
    ctr = profiler.serving_counters()
    assert ctr["requests"] == 5 and ctr["batches"] >= 1
    art = profiler.write_timeline(str(tmp_path / "timeline.json"))
    assert art["serving"]["requests"] == 5


# -- HTTP front end -----------------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_http_endpoint(art_v1, art_v2):
    with _service(max_batch=4, batch_timeout_ms=1, queue_depth=16) as svc:
        _load(svc, "m", art_v1)
        server = make_server(svc, port=0)
        port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        base = "http://127.0.0.1:%d" % port
        try:
            f = _feeds(1, seed=11)[0]
            code, resp = _post(base + "/v1/models/m:predict",
                               {"inputs": {"x": f.tolist()}})
            assert code == 200 and resp["version"] == 1
            np.testing.assert_allclose(
                np.asarray(resp["outputs"][0], np.float32),
                _expected(f, 0.5), rtol=1e-4)

            with urllib.request.urlopen(base + "/healthz",
                                        timeout=30) as r:
                health = json.loads(r.read())
            assert health["ok"] and "m" in health["models"]
            assert health["ready"]["m"]["kind"] == "compiled"
            with urllib.request.urlopen(base + "/statz", timeout=30) as r:
                stats = json.loads(r.read())
            assert stats["requests"] >= 1
            with urllib.request.urlopen(base + "/v1/models",
                                        timeout=30) as r:
                assert json.loads(r.read())["m"]["version"] == 1

            # error mapping: wrong shape -> 400, unknown model -> 404
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/m:predict",
                      {"inputs": {"x": [[1.0] * DIM]}})
            assert ei.value.code == 400
            assert "shape" in json.loads(ei.value.read())["error"]
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/ghost:predict",
                      {"inputs": {"x": f.tolist()}})
            assert ei.value.code == 404
            # an expired deadline -> 504
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/m:predict",
                      {"inputs": {"x": f.tolist()}, "deadline_ms": -1})
            assert ei.value.code == 504
            # a failed batch -> 500
            resilience.arm("serving.dispatch", action="raise", nth=1,
                           times=1)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/m:predict",
                      {"inputs": {"x": f.tolist()}})
            assert ei.value.code == 500
            assert json.loads(ei.value.read())["kind"] == "dispatch"

            # hot reload over HTTP; a bad dirname -> 409 + kept version
            code, resp = _post(base + "/v1/models/m:reload",
                               {"dirname": art_v2})
            assert code == 200 and resp["version"] == 2
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/m:reload",
                      {"dirname": art_v2 + "-missing"})
            assert ei.value.code == 409
            assert json.loads(ei.value.read())["serving_version"] == 2
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + "/v1/models/m:reload", {})
            assert ei.value.code == 400
            code, resp = _post(base + "/v1/models/m:predict",
                               {"inputs": {"x": f.tolist()}})
            assert resp["version"] == 2
            np.testing.assert_allclose(
                np.asarray(resp["outputs"][0], np.float32),
                _expected(f, 1.0), rtol=1e-4)
        finally:
            server.shutdown()
            server.server_close()


def test_http_overload_is_429_with_retry_after(art_v1):
    resilience.arm("serving.dispatch", action="delay", delay=0.5,
                   nth=1, times=None)
    with _service(max_batch=1, batch_timeout_ms=0, queue_depth=1) as svc:
        _load(svc, "m", art_v1)
        server = make_server(svc, port=0)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        url = "http://127.0.0.1:%d/v1/models/m:predict" % (
            server.server_address[1])
        try:
            f = _feeds(1, seed=13)[0]
            first = svc.infer_async("m", {"x": f})
            deadline = time.monotonic() + 5.0
            while svc._batcher.pending() and time.monotonic() < deadline:
                time.sleep(0.005)
            queued = svc.infer_async("m", {"x": f})
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(url, {"inputs": {"x": f.tolist()}})
            assert ei.value.code == 429
            assert int(ei.value.headers["Retry-After"]) >= 1
            body = json.loads(ei.value.read())
            assert body["kind"] == "overload" and body["retry_after_ms"] > 0
            resilience.disarm("serving.dispatch")
            for h in (first, queued):
                h.wait(timeout=30)
        finally:
            server.shutdown()
            server.server_close()


# -- the CLI verb -------------------------------------------------------------

def test_serve_cli_bad_artifact_exit_1(tmp_path, capsys):
    from paddle_tpu_torch import cli
    rc = cli.main(["serve", str(tmp_path / "not-an-artifact"),
                   "--device", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "does not exist" in err
    # a partly written artifact: every missing file is named
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "__meta__.json").write_text("{}")
    rc = cli.main(["serve", str(broken), "--device", "cpu"])
    assert rc == 1
    err = capsys.readouterr().err
    assert "__model__" in err and "__params__.pkl" in err


def test_serve_cli_device_cuda_without_a_card_exits_1(art_v1, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from paddle_tpu_torch import cli
    assert cli.main(["serve", art_v1, "--port", "0"]) == 1
    assert "is_available() is false" in capsys.readouterr().err


def test_serve_cli_http_and_sigterm(art_v1, art_v2):
    """`serve` starts, answers ``:predict`` for its model and an
    ``--extra_model`` beside it, and exits 0 on SIGTERM."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", art_v1,
         "--name", "m", "--port", "0", "--batch_timeout_ms", "1",
         "--device", "cpu", "--extra_model", "m2=%s" % art_v2],
        cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready = {}

        def read_ready():
            ready["line"] = p.stdout.readline()

        t = threading.Thread(target=read_ready, daemon=True)
        t.start()
        t.join(timeout=240)
        assert ready.get("line"), "serve never printed its readiness line"
        info = json.loads(ready["line"])["serving"]
        assert info["model"] == "m" and info["version"] == 1
        assert info["kind"] == "compiled" and info["extra_models"] == ["m2"]

        f = _feeds(1, seed=12)[0]
        for name, scale in (("m", 0.5), ("m2", 1.0)):
            code, resp = _post(
                "http://%s:%d/v1/models/%s:predict" % (info["host"],
                                                       info["port"], name),
                {"inputs": {"x": f.tolist()}})
            assert code == 200
            np.testing.assert_allclose(
                np.asarray(resp["outputs"][0], np.float32),
                _expected(f, scale), rtol=1e-4)

        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
        assert p.returncode == 0, (out, err[-2000:])
        stopped = json.loads(out.strip().splitlines()[-1])
        assert stopped["serving_stopped"]["signal"] == signal.SIGTERM
        assert stopped["serving_stopped"]["stats"]["requests"] >= 2
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()


# -- Queue 3 #40 and #41 ------------------------------------------------------

def _reload_between_admission_and_dispatch(pkg_service, pkg_server, res,
                                           v1, v2, load_kw, delay):
    """Request A holds the dispatch (a delay at ``serving.dispatch``);
    request B is admitted over HTTP under v1 and queued; a reload
    publishes v2; B is then dispatched. Returns B's answer."""
    res.arm("serving.dispatch", action="delay", delay=delay, nth=1,
            times=1)
    svc = pkg_service(max_batch=1, batch_timeout_ms=0, queue_depth=8)
    server = None
    try:
        svc.load_model("m", v1, **load_kw)
        server = pkg_server(svc, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = "http://127.0.0.1:%d/v1/models/m:predict" % (
            server.server_address[1])
        f = _feeds(1, seed=14)[0]
        first = svc.infer_async("m", {"x": f})
        deadline = time.monotonic() + 30
        while svc._batcher.pending() and time.monotonic() < deadline:
            time.sleep(0.005)           # A is in its slow dispatch
        got = {}
        t = threading.Thread(target=lambda: got.update(
            answer=_post(url, {"inputs": {"x": f.tolist()}})))
        t.start()
        while not svc._batcher.pending() and time.monotonic() < deadline:
            time.sleep(0.005)           # B is admitted and queued
        svc.reload_model("m", v2, **load_kw)
        assert not first.done, "the dispatch delay ended before the reload"
        t.join(timeout=60)
        first.wait(timeout=60)
        return f, got["answer"]
    finally:
        res.disarm("serving.dispatch")
        if server is not None:
            server.shutdown()
            server.server_close()
        svc.close()


def test_predict_answers_with_the_version_that_served_it(art_v1, art_v2,
                                                         tmp_path):
    """Queue 3 #40: a request admitted under v1 and dispatched after a
    hot reload is served by v2. The JAX package labels it version 1
    (the entry it looked up at admission) beside v2's outputs; the port
    labels it 2."""
    import paddle_tpu as jpt
    from paddle_tpu import resilience as jres
    from paddle_tpu import serving as jserving

    def jax_export(d, scale):
        with jpt.scope_guard(jpt.Scope()):
            main, startup = jpt.Program(), jpt.Program()
            with jpt.program_guard(main, startup):
                x = jpt.layers.data("x", shape=[DIM], dtype="float32")
                out = jpt.layers.fc(
                    x, size=OUT, bias_attr=False, act=None,
                    param_attr=jpt.ParamAttr(
                        name="serve_w",
                        initializer=jpt.initializer.ConstantInitializer(
                            scale)))
            exe = jpt.Executor(jpt.CPUPlace())
            exe.run(startup)
            jpt.inference.export_compiled(
                d, ["x"], [out], exe, main_program=main,
                example_feed={"x": np.zeros((ROWS, DIM), np.float32)})
        return d

    j1 = jax_export(str(tmp_path / "j1"), 0.5)
    j2 = jax_export(str(tmp_path / "j2"), 1.0)
    jres.reset()
    try:
        f, (code, ans) = _reload_between_admission_and_dispatch(
            jserving.InferenceService, jserving.make_server, jres, j1, j2,
            {}, delay=5.0)
    finally:
        jres.reset()
    assert code == 200
    np.testing.assert_allclose(np.asarray(ans["outputs"][0], np.float32),
                               _expected(f, 1.0), rtol=1e-4)
    assert ans["version"] == 1          # the reference's label
    f, (code, ans) = _reload_between_admission_and_dispatch(
        InferenceService, make_server, resilience, art_v1, art_v2,
        {"device": "cpu"}, delay=1.0)
    assert code == 200
    np.testing.assert_allclose(np.asarray(ans["outputs"][0], np.float32),
                               _expected(f, 1.0), rtol=1e-4)
    assert ans["version"] == 2


def test_a_burst_of_concurrent_connections_is_served(art_v1):
    """Queue 3 #41: the stdlib server's listen backlog of 5 (the JAX
    package's) resets the connections of a burst past it before a
    thread accepts them; the port's server listens with 128, and 48
    concurrent ``:predict`` requests all answer 200."""
    with _service(max_batch=8, batch_timeout_ms=5, queue_depth=64) as svc:
        _load(svc, "m", art_v1)
        server = make_server(svc, port=0)
        assert server.request_queue_size >= 128
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = "http://127.0.0.1:%d/v1/models/m:predict" % (
            server.server_address[1])
        feeds = _feeds(48, seed=15)
        codes = [None] * len(feeds)
        start = threading.Barrier(len(feeds))

        def client(i):
            start.wait()
            try:
                codes[i] = _post(url, {"inputs": {"x": feeds[i].tolist()}})[0]
            except Exception as e:
                codes[i] = repr(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(feeds))]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            server.shutdown()
            server.server_close()
    assert codes == [200] * len(feeds), codes
