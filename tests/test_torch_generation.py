"""The port's generation engine, artifact format, service and HTTP
endpoint, held against the JAX package on the CPU.

Greedy decode is exact in both packages, so the port's tokens must equal
the JAX engine's (which the JAX package's own tests hold to its
sequential reference decoder) and the port's sequential reference
decoder's, token for token. Tempered decode matches the JAX package
only in distribution (the two draw from different random streams), so it
is held to replay within the port.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu.models import transformer as jtm  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu_torch import inference as tinf  # noqa: E402
from paddle_tpu_torch.device import NoDeviceError  # noqa: E402
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    GenerationEngine, InferenceService, OverloadError, PoolExhausted,
    ServingError, make_server, reference_decode)

VOCAB, MAX_SEQ = 29, 48


@pytest.fixture(scope="module")
def jax_model():
    cfg = jtm.TransformerConfig(vocab_size=VOCAB, hidden=16, num_layers=2,
                                num_heads=2, max_seq=MAX_SEQ)
    return jtm.TransformerLM(jtm.init_params(cfg, seed=3), cfg)


@pytest.fixture(scope="module")
def model(jax_model):
    params = {n: np.asarray(jax_model.params[n])
              for n in jtm.param_names(jax_model.config)}
    return ttm.TransformerLM.from_numpy(params, jax_model.config.to_dict(),
                                        device="cpu")


@pytest.fixture(scope="module")
def flood():
    rng = np.random.RandomState(7)
    return [list(rng.randint(0, VOCAB, n)) for n in (1, 3, 9, 16, 30)]


def _engine(model, **kw):
    kw.setdefault("max_running", 4)
    kw.setdefault("kv_pages", 64)
    kw.setdefault("page_tokens", 8)
    kw.setdefault("queue_depth", 64)
    return GenerationEngine(model, **kw)


def test_greedy_flood_equals_jax_engine_and_reference_decode(
        jax_model, model, flood):
    with JaxEngine(jax_model, max_running=4, kv_pages=64, page_tokens=8,
                   queue_depth=64, warm=False) as jeng:
        jax_tokens = [h.wait(timeout=300).tokens
                      for h in [jeng.submit(p, max_new_tokens=8)
                                for p in flood]]
    for device_sample in (True, False):
        with _engine(model, device_sample=device_sample) as eng:
            handles = [eng.submit(p, max_new_tokens=8) for p in flood]
            got = [h.wait(timeout=120) for h in handles]
            st = eng.stats
        assert [g.tokens for g in got] == jax_tokens
        assert all(g.finish_reason == "length" for g in got)
        assert (got[0].logprobs is not None) == device_sample
        assert st["completed"] == len(flood)
        assert st["max_running_seen"] > 1        # batching really happened
        assert st["page_utilization"]["live"] == 0
    assert [reference_decode(model, p, 8) for p in flood] == jax_tokens


def test_prompt_reservation_preempts_and_output_is_unchanged(model):
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    with _engine(model, max_running=2, kv_pages=4, page_tokens=4,
                 reserve="prompt") as eng:
        got = [h.wait(timeout=120).tokens for h in
               [eng.submit(p, max_new_tokens=8) for p in prompts]]
        st = eng.stats
    assert st["preemptions"] >= 1
    assert got == [reference_decode(model, p, 8) for p in prompts]


def test_tempered_request_replays_after_preemption(model):
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    with _engine(model) as big:
        want = [big.generate(p, max_new_tokens=8, temperature=0.6,
                             seed=i + 5, timeout=120).tokens
                for i, p in enumerate(prompts)]
    with _engine(model, max_running=2, kv_pages=5, page_tokens=4,
                 reserve="prompt") as pre:
        got = [h.wait(timeout=120).tokens for h in
               [pre.submit(p, max_new_tokens=8, temperature=0.6, seed=i + 5)
                for i, p in enumerate(prompts)]]
        st = pre.stats
    assert st["preemptions"] >= 1
    assert got == want


def test_submit_validation_and_sheds(model):
    with _engine(model, max_running=1, kv_pages=4, page_tokens=4,
                 queue_depth=1) as eng:
        for bad in (([], 4), ([VOCAB], 4), ([1], 0)):
            with pytest.raises(ValueError):
                eng.submit(*bad)
        with pytest.raises(ValueError):
            eng.submit([1], 4, temperature=float("nan"))
        with pytest.raises(ValueError):          # context overflow
            eng.submit([1] * (MAX_SEQ - 1), max_new_tokens=2)
        with pytest.raises(PoolExhausted):       # 4 pages x 4 tokens < 20
            eng.submit(list(range(12)), max_new_tokens=8)
        eng.drain(timeout=30)
        with pytest.raises(ServingError, match="draining"):
            eng.submit([1, 2], 2)
    with _engine(model, max_running=1, queue_depth=1) as eng:
        with eng._cond:        # hold the loop so the queue cannot drain
            eng.submit([1, 2], 2)
            with pytest.raises(OverloadError):
                eng.submit([3, 4], 2)
        eng.close()
        with pytest.raises(ServingError, match="closed"):
            eng.submit([1], 2)


def test_eos_retires_immediately(model):
    prompt = [3, 1, 4, 1, 5]
    ref = reference_decode(model, prompt, 6)
    with _engine(model, eos_id=ref[2]) as eng:
        res = eng.generate(prompt, max_new_tokens=6, timeout=120)
    assert res.finish_reason == "eos" and res.tokens == ref[:3]


def test_jax_artifact_loads_in_the_port(tmp_path, jax_model, model):
    art = str(tmp_path / "gen")
    jinf.export_generative(art, jax_model.config,
                           params={n: np.asarray(jax_model.params[n])
                                   for n in jtm.param_names(jax_model.config)})
    assert tinf.is_generative_artifact(art)
    assert tinf.validate_generative_artifact(art) == []
    loaded = tinf.load_generative(art, device="cpu")
    for n, t in model.params.items():
        assert torch.equal(getattr(loaded, n), t)
    # and the port's export loads back in the JAX package
    back = str(tmp_path / "back")
    tinf.export_generative(back, loaded.config, params=loaded.params)
    jl = jinf.load_generative(back)
    assert jl.config.to_dict() == jax_model.config.to_dict()
    with pytest.raises(tinf.ArtifactError, match="missing"):
        tinf.load_generative(str(tmp_path), device="cpu")


def test_default_device_without_a_card_raises(tmp_path, jax_model):
    if torch.cuda.is_available():
        pytest.skip("this process has a card: the default device works")
    art = str(tmp_path / "gen")
    jinf.export_generative(art, jax_model.config,
                           params={n: np.asarray(jax_model.params[n])
                                   for n in jtm.param_names(jax_model.config)})
    with pytest.raises(NoDeviceError):
        tinf.load_generative(art)
    with pytest.raises(NoDeviceError):
        InferenceService().load_model("lm", art)


def test_http_generate_on_port_zero(tmp_path, model):
    art = str(tmp_path / "gen")
    tinf.export_generative(art, model.config, params=model.params)
    svc = InferenceService()
    svc.load_model("lm", art, warm=False, device="cpu", max_running=2,
                   kv_pages=4, page_tokens=8)
    server = make_server(svc, host="127.0.0.1", port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = "http://%s:%d" % server.server_address[:2]

    def post(path, body, expect):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == expect
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            assert e.code == expect, e.read()
            return json.loads(e.read())

    try:
        prompt = [3, 5, 7]
        out = post("/v1/models/lm:generate",
                   {"tokens": prompt, "max_new_tokens": 4}, 200)
        assert out["tokens"] == reference_decode(model, prompt, 4)
        assert out["finish_reason"] == "length"
        assert out["model"] == "lm" and out["version"] == 1
        assert len(out["logprobs"]) == 4
        assert post("/v1/models/lm:generate", {"tokens": []},
                    400)["kind"] == "bad_request"
        assert post("/v1/models/ghost:generate", {"tokens": [1]},
                    404)["kind"] == "model_unavailable"
        too_big = post("/v1/models/lm:generate",
                       {"tokens": list(range(20)), "max_new_tokens": 20},
                       429)
        assert too_big["kind"] == "kv_pool_exhausted"
        assert too_big["retry_after_ms"] >= 1.0
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["ready"]["lm"]["kind"] == "generative"
        with urllib.request.urlopen(base + "/statz", timeout=30) as r:
            statz = json.loads(r.read())
        assert statz["generation"]["lm"]["completed"] == 1
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_serve_cli_readiness_generate_and_sigterm_drain(tmp_path, model):
    import os
    import signal
    import subprocess
    import sys
    art = str(tmp_path / "gen")
    tinf.export_generative(art, model.config, params=model.params)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", art, "--port",
         "0", "--device", "cpu", "--name", "lm", "--max_running", "2",
         "--kv_pages", "16", "--page_tokens", "8"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ready = json.loads(proc.stdout.readline())["serving"]
        assert ready["device"] == "cpu" and ready["max_running"] == 2
        req = urllib.request.Request(
            "http://%s:%d/v1/models/lm:generate" % (ready["host"],
                                                    ready["port"]),
            data=json.dumps({"tokens": [2, 4, 6],
                             "max_new_tokens": 3}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["tokens"] == reference_decode(model, [2, 4, 6], 3)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    stopped = json.loads(stdout.strip().splitlines()[-1])["serving_stopped"]
    assert stopped["signal"] == signal.SIGTERM
    assert stopped["stats"]["generation"]["lm"]["completed"] == 1


def test_serve_cli_refuses_a_directory_that_is_not_an_artifact(tmp_path):
    from paddle_tpu_torch.cli import main
    assert main(["serve", str(tmp_path), "--device", "cpu"]) == 1


def test_an_untuned_decode_calls_the_paged_kernels_wrapper(model,
                                                           monkeypatch):
    """ROADMAP Queue 3 #5 (deliberate): with no tune winner the JAX
    engine's decode runs the gather reference, while the port's decode
    step calls the paged-attention kernel's wrapper once a layer (its
    plain version on the CPU, the kernel on a CUDA tensor); the tokens
    are the JAX engine's either way (the flood test above)."""
    calls = []
    real = ttm.paged_attention

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ttm, "paged_attention", spy)
    prompt = [3, 1, 4, 1, 5]
    with _engine(model) as eng:
        res = eng.generate(prompt, max_new_tokens=6, timeout=120)
        steps = eng.stats["decode_steps"]
    assert res.tokens == reference_decode(model, prompt, 6)
    assert steps > 0
    assert len(calls) >= model.config.num_layers * steps
