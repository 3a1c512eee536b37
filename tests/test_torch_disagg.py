"""Disaggregated serving in the port, held against itself and against the
JAX package on the CPU: the prefill engine, the handoff artifact and its
wire payload, ``ship`` with its failure semantics, the decode engine's
install (``submit_prefilled``), the service's tier path, the
``:prefill`` / ``:decode`` routes and ``serve --tier``.

Within the port a handoff is exact: prefill -> ship -> decode gives the
tokens and logprobs of a local submit bit for bit, greedy and seeded,
since both run the same functions on the same inputs. Across the
packages the seeded streams differ by construction (the port keys its
draws with its own hash, not threefry), so those checks are greedy: a
JAX artifact decodes in the port to the JAX engine's own tokens and a
port artifact in the JAX engine to the port's, and the two packages'
page contents for the same prompt agree to 1e-5 (the tolerance of the
port's other float32 transformer checks). Every test that needs
requests to be concurrent queues them all before the engine admits any
(it holds the engine's lock while submitting).
"""
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.models import transformer as jtm  # noqa: E402
from paddle_tpu.serving import GenerationEngine as JaxEngine  # noqa: E402
from paddle_tpu.serving import HandoffArtifact as JaxArtifact  # noqa: E402
from paddle_tpu.serving import PrefillEngine as JaxPrefill  # noqa: E402
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402
from paddle_tpu_torch.resilience import events, faults  # noqa: E402
from paddle_tpu_torch.serving import (  # noqa: E402
    GenerationEngine, HandoffArtifact, InferenceService, OverloadError,
    PoolExhausted, PrefillEngine, ServingError, make_server, pages_for,
    reference_decode, ship)

VOCAB, MAX_SEQ = 23, 48
PAGES_TOL = 1e-5
PROMPT = [5, 7, 11, 2, 9, 4, 8, 6, 3, 1, 12]


@pytest.fixture(scope="module")
def jax_model():
    cfg = jtm.TransformerConfig(vocab_size=VOCAB, hidden=16, num_layers=2,
                                num_heads=2, max_seq=MAX_SEQ)
    return jtm.TransformerLM(jtm.init_params(cfg, seed=3), cfg)


def _port(jax_model):
    params = {n: np.asarray(jax_model.params[n])
              for n in jtm.param_names(jax_model.config)}
    return ttm.TransformerLM.from_numpy(params, jax_model.config.to_dict(),
                                        device="cpu")


@pytest.fixture(scope="module")
def model(jax_model):
    return _port(jax_model)


@pytest.fixture(scope="module")
def draft():
    cfg = ttm.TransformerConfig(vocab_size=VOCAB, hidden=8, num_layers=1,
                                num_heads=2, max_seq=MAX_SEQ)
    return ttm.TransformerLM.from_numpy(ttm.init_params(cfg, seed=5), cfg,
                                        device="cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    events.clear_events()
    yield
    faults.reset()


def _engine(model, **kw):
    kw.setdefault("max_running", 4)
    kw.setdefault("kv_pages", 64)
    kw.setdefault("page_tokens", 8)
    kw.setdefault("queue_depth", 64)
    return GenerationEngine(model, **kw)


def _prefill(model, prompt=PROMPT, page_tokens=8, **kw):
    pre = PrefillEngine(model, page_tokens=page_tokens, name="pre",
                        device="cpu")
    try:
        art = pre.prefill(prompt, **kw)
        assert pre.pool.live == 0     # the export freed its pages
        return art, pre.stats
    finally:
        pre.close()


def _handoff_failures():
    return [e for e in events.events() if e["kind"] == "handoff_failed"]


# -- the hop within the port --------------------------------------------------

@pytest.mark.parametrize("budget", [1, 2, 16])
@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 7)])
def test_prefill_ship_decode_equals_a_local_submit(model, temperature, seed,
                                                   budget):
    kw = dict(max_new_tokens=budget, temperature=temperature, seed=seed)
    art, pst = _prefill(model, **kw)
    assert art.pages == pages_for(len(PROMPT), 8)
    assert pst["prefills"] == 1 and pst["exported_pages"] == art.pages
    assert pst["exported_bytes"] == art.kv_bytes
    with _engine(model, name="dec") as dec:
        got = ship(art, dec).wait(timeout=300)
        st = dec.stats
    with _engine(model, name="local") as loc:
        want = loc.submit(PROMPT, **kw).wait(timeout=300)
    assert got.tokens == want.tokens and len(got.tokens) == budget
    assert got.logprobs == want.logprobs
    assert got.finish_reason == want.finish_reason == "length"
    assert st["handoff_installs"] == (1 if budget > 1 else 0)
    assert st["prefills"] == 0 and st["completed"] == 1
    if temperature == 0.0:
        assert got.tokens == reference_decode(model, PROMPT, budget)
    assert not _handoff_failures()


def test_payload_round_trips_bit_exactly(model):
    art, _ = _prefill(model, max_new_tokens=6, temperature=0.7, seed=11)
    back = HandoffArtifact.from_payload(
        json.loads(json.dumps(art.to_payload())))
    for slot in HandoffArtifact.__slots__:
        if slot.endswith("_pages"):
            a, b = getattr(art, slot), getattr(back, slot)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        else:
            assert getattr(back, slot) == getattr(art, slot), slot


@pytest.mark.parametrize("mutate", [
    lambda p: {"prompt": [1]},
    lambda p: [p],
    lambda p: dict(p, k_pages="not a block"),
    lambda p: dict(p, k_pages=dict(p["k_pages"], data="@@@")),
    lambda p: dict(p, v_pages=dict(p["v_pages"], shape=[3, 5])),
    lambda p: dict(p, k_pages=dict(p["k_pages"], dtype="no-such-type")),
], ids=["missing_keys", "not_an_object", "block_not_an_object",
        "bad_base64", "bad_shape", "bad_dtype"])
def test_a_malformed_payload_raises_value_error(model, mutate):
    art, _ = _prefill(model, max_new_tokens=4)
    with pytest.raises(ValueError):
        HandoffArtifact.from_payload(mutate(art.to_payload()))


@pytest.mark.parametrize("reason", ["eos", "length"])
def test_a_finished_first_token_resolves_at_once(model, reason):
    budget = 1 if reason == "length" else 6
    art, _ = _prefill(model, max_new_tokens=budget)
    eos = art.first_token if reason == "eos" else None
    with _engine(model, name="dec", eos_id=eos) as dec:
        req = dec.submit_prefilled(art)
        assert req.done                 # resolved on the caller's thread
        res = req.wait(timeout=1)
        st = dec.stats
    assert res.tokens == [art.first_token] and res.finish_reason == reason
    assert st["completed"] == 1 and st["handoff_installs"] == 0


# -- failure semantics --------------------------------------------------------

def test_armed_ship_reprefills_on_the_decode_engine(model):
    art, _ = _prefill(model, max_new_tokens=6)
    faults.arm("serving.ship", "raise", nth=1, times=1)
    with _engine(model, name="dec") as dec:
        res = ship(art, dec).wait(timeout=300)
        st = dec.stats
    assert res.tokens == reference_decode(model, PROMPT, 6)
    assert st["handoff_installs"] == 0 and st["prefills"] == 1
    evs = _handoff_failures()
    assert len(evs) == 1 and evs[0]["site"] == "serving.ship"
    assert evs[0]["pages"] == art.pages


def test_a_geometry_mismatch_reprefills(model):
    art, _ = _prefill(model, page_tokens=4, max_new_tokens=6)
    with _engine(model, page_tokens=8, name="dec") as dec:
        with pytest.raises(ServingError):
            dec.submit_prefilled(art)
        res = ship(art, dec).wait(timeout=300)
        st = dec.stats
    assert res.tokens == reference_decode(model, PROMPT, 6)
    assert st["prefills"] == 1 and st["handoff_installs"] == 0
    assert len(_handoff_failures()) == 1


def _short(art):
    art.k_pages, art.v_pages = art.k_pages[:, :-1], art.v_pages[:, :-1]


def _prompt_past_vocab(art):
    art.prompt = [VOCAB] + art.prompt[1:]


# artifacts that come off the network wrong; "reprefill": the prompt is
# sound, so ship prefills it again on the decode engine; "refused": the
# request itself is malformed, so the re-prefill refuses it too
BAD_ARTIFACTS = [
    ("first_token_past_vocab",
     lambda a: setattr(a, "first_token", VOCAB), "reprefill"),
    ("first_token_negative",
     lambda a: setattr(a, "first_token", -1), "reprefill"),
    ("one_page_short", _short, "reprefill"),
    ("nan_temperature",
     lambda a: setattr(a, "temperature", float("nan")), "refused"),
    ("negative_temperature",
     lambda a: setattr(a, "temperature", -0.5), "refused"),
    ("prompt_id_past_vocab", _prompt_past_vocab, "refused"),
    ("no_budget", lambda a: setattr(a, "max_new_tokens", 0), "refused"),
]


@pytest.mark.parametrize("mutate,outcome", [b[1:] for b in BAD_ARTIFACTS],
                         ids=[b[0] for b in BAD_ARTIFACTS])
def test_submit_prefilled_refuses_a_malformed_artifact(model, mutate,
                                                       outcome):
    art, _ = _prefill(model, max_new_tokens=6)
    mutate(art)
    with _engine(model, name="dec") as dec:
        with pytest.raises(ValueError):
            dec.submit_prefilled(art)
        assert dec.stats["submitted"] == 0
        if outcome == "refused":
            with pytest.raises(ValueError):
                ship(art, dec)
        else:
            res = ship(art, dec).wait(timeout=300)
            assert res.tokens == reference_decode(model, PROMPT, 6)
        st = dec.stats
    assert st["handoff_installs"] == 0
    assert st["prefills"] == (outcome == "reprefill")
    assert len(_handoff_failures()) == 1


def test_pages_that_do_not_fit_the_pool_fail_that_request(model):
    art, _ = _prefill(model, max_new_tokens=6)
    # pages of another shape than the artifact's header says: the install
    # on the engine thread refuses them and fails that request, as a
    # failed prefill does; the engine keeps serving
    art.k_pages = art.k_pages[:, :, :4]
    with _engine(model, name="dec") as dec:
        with pytest.raises(ServingError, match="pool layout"):
            dec.submit_prefilled(art).wait(timeout=300)
        st = dec.stats
        assert dec.generate(PROMPT, max_new_tokens=3, timeout=300).tokens \
            == reference_decode(model, PROMPT, 3)
    assert st["failed"] == 1 and st["handoff_installs"] == 0
    assert [e["phase"] for e in events.events()
            if e["kind"] == "generate_failed"] == ["prefill"]


class _Refusing(object):
    name = "dec"

    def __init__(self, exc):
        self.exc = exc
        self.submits = 0

    def submit_prefilled(self, artifact, deadline_ms=None):
        raise self.exc("the decode tier is full")

    def submit(self, *a, **kw):
        self.submits += 1


@pytest.mark.parametrize("exc", [OverloadError, PoolExhausted])
def test_ship_propagates_decode_backpressure(model, exc):
    art, _ = _prefill(model, max_new_tokens=4)
    dec = _Refusing(exc)
    with pytest.raises(exc):
        ship(art, dec)
    assert dec.submits == 0 and not _handoff_failures()


def test_a_real_pool_too_small_propagates_without_a_reprefill(model):
    art, _ = _prefill(model, max_new_tokens=16)
    with _engine(model, kv_pages=2, name="dec") as dec:
        with pytest.raises(PoolExhausted):
            ship(art, dec)
        st = dec.stats
    assert st["prefills"] == 0 and st["submitted"] == 0
    assert st["shed_pool"] == 1 and not _handoff_failures()


# -- the handoff row on a speculative, prefix-sharing engine ------------------

def test_a_handoff_decodes_plainly_and_privately(model, draft):
    prefix = PROMPT[:8]
    with _engine(model, name="plain") as plain:
        want = plain.generate(PROMPT, max_new_tokens=8, timeout=300).tokens
    art, _ = _prefill(model, max_new_tokens=8)
    with _engine(model, name="dec", draft_model=draft, spec_k=3,
                 prefix_sharing=True) as dec:
        assert dec.stats["speculative"] and dec.stats["prefix_sharing"]
        res = ship(art, dec).wait(timeout=300)
        st = dec.stats
        assert st["handoff_installs"] == 1 and st["prefills"] == 0
        assert st["prefix_published"] == 0 and st["prefix_hits"] == 0
        assert st["draft_tokens"] == 0        # no lane proposed for it
        assert res.tokens == want
        # a local request publishes the prompt's pages; a second handoff
        # of a prompt sharing them still pins and publishes nothing
        dec.generate(prefix + [0, 1], max_new_tokens=2, timeout=300)
        before = dec.stats
        assert before["prefix_published"] > 0
        again = ship(art, dec).wait(timeout=300)
        after = dec.stats
    assert again.tokens == want
    assert after["handoff_installs"] == 2
    for key in ("prefix_published", "prefix_hits", "prefix_hit_requests",
                "prefills"):
        assert after[key] == before[key], key
    assert not _handoff_failures() and not [
        e for e in events.events()
        if e["kind"] in ("speculation_degraded", "prefix_degraded")]


def test_a_preempted_handoff_row_resumes_by_reprefill(model):
    other = [3, 9, 1, 4, 4, 8, 2, 7]
    art, _ = _prefill(model, prompt=other, page_tokens=4,
                      max_new_tokens=12)
    # 6 pages of 4 positions: two rows of 8 + 12 outgrow it together,
    # and the row in slot 0 (the handoff, queued first) starves first
    with _engine(model, name="dec", kv_pages=6, page_tokens=4,
                 reserve="prompt") as dec:
        with dec._cond:
            hand = ship(art, dec)
            local = dec.submit(PROMPT[:8], max_new_tokens=12)
        got, loc = hand.wait(timeout=300), local.wait(timeout=300)
        st = dec.stats
    assert got.preemptions >= 1 and st["preemptions"] >= 1
    assert st["handoff_installs"] == 1 and st["prefills"] >= 2
    assert got.tokens == reference_decode(model, other, 12)
    assert loc.tokens == reference_decode(model, PROMPT[:8], 12)


# -- across the packages ------------------------------------------------------

@pytest.fixture(scope="module")
def both_artifacts(jax_model, model):
    """The same greedy prompt prefilled by each package's PrefillEngine:
    (JAX artifact, port artifact)."""
    jpre = JaxPrefill(jax_model, page_tokens=8, name="jpre")
    try:
        jart = jpre.prefill(PROMPT, max_new_tokens=10)
    finally:
        jpre.close()
    art, _ = _prefill(model, max_new_tokens=10)
    return jart, art


@pytest.fixture(scope="module")
def jax_tokens(jax_model):
    eng = JaxEngine(jax_model, max_running=4, kv_pages=64, page_tokens=8,
                    warm=False, name="jlocal")
    try:
        return eng.generate(PROMPT, max_new_tokens=10, timeout=300).tokens
    finally:
        eng.close()


def test_a_jax_artifact_decodes_in_the_port(model, both_artifacts,
                                            jax_tokens):
    jart, _ = both_artifacts
    art = HandoffArtifact.from_payload(
        json.loads(json.dumps(jart.to_payload())))
    with _engine(model, name="dec") as dec:
        res = ship(art, dec).wait(timeout=300)
        st = dec.stats
    assert st["handoff_installs"] == 1 and st["prefills"] == 0
    assert res.tokens == jax_tokens


def test_a_port_artifact_decodes_in_the_jax_engine(jax_model, model,
                                                   both_artifacts):
    _, art = both_artifacts
    with _engine(model, name="local") as loc:
        want = loc.generate(PROMPT, max_new_tokens=10, timeout=300).tokens
    jart = JaxArtifact.from_payload(json.loads(json.dumps(art.to_payload())))
    eng = JaxEngine(jax_model, max_running=4, kv_pages=64, page_tokens=8,
                    warm=False, name="jdec")
    try:
        res = eng.submit_prefilled(jart).wait(timeout=300)
        st = eng.stats
    finally:
        eng.close()
    assert st["handoff_installs"] == 1 and st["prefills"] == 0
    assert res.tokens == want


def test_both_packages_write_the_same_pages_and_payload_layout(
        both_artifacts):
    jart, art = both_artifacts
    assert jart.first_token == art.first_token
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(getattr(art, name), getattr(jart, name),
                                   rtol=0, atol=PAGES_TOL)
    jp, tp = jart.to_payload(), art.to_payload()
    assert sorted(jp) == sorted(tp)
    for name in ("k_pages", "v_pages"):
        assert sorted(jp[name]) == sorted(tp[name])
        assert jp[name]["dtype"] == tp[name]["dtype"] == "float32"
        assert jp[name]["shape"] == tp[name]["shape"]
    for key in jp:
        if not key.endswith("_pages") and key != "first_logprob":
            assert jp[key] == tp[key], key


# -- the service and its HTTP routes ------------------------------------------

def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def tiers(model):
    """A prefill-class and a decode-class service over the model, each
    behind its own server: {tier: (service, base URL)}."""
    import threading
    out, stops = {}, []
    for tier in ("prefill", "decode"):
        svc = InferenceService(tier=tier)
        svc.register_generative("lm", model, max_running=4, kv_pages=64,
                                page_tokens=8)
        srv = make_server(svc, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out[tier] = (svc, "http://127.0.0.1:%d" % srv.server_address[1])
        stops.append((srv, svc))
    yield out
    for srv, svc in stops:
        srv.shutdown()
        srv.server_close()
        svc.close()


def test_http_prefill_then_decode_returns_the_local_tokens(model, tiers):
    code, pre = _post(tiers["prefill"][1], "/v1/models/lm:prefill",
                      {"tokens": PROMPT, "max_new_tokens": 6,
                       "temperature": 0.8, "seed": 3})
    assert code == 200 and pre["model"] == "lm"
    code, out = _post(tiers["decode"][1], "/v1/models/lm:decode",
                      {"artifact": pre["artifact"]})
    assert code == 200 and out["finish_reason"] == "length"
    code, local = _post(tiers["decode"][1], "/v1/models/lm:generate",
                        {"tokens": PROMPT, "max_new_tokens": 6,
                         "temperature": 0.8, "seed": 3})
    assert code == 200 and out["tokens"] == local["tokens"]
    assert out["logprobs"] == local["logprobs"]
    st = tiers["decode"][0].stats
    assert st["generation"]["lm"]["handoff_installs"] >= 1
    assert tiers["prefill"][0].stats["prefill"]["lm"]["prefills"] >= 1


@pytest.mark.parametrize("tier", ["prefill", "decode"])
def test_tier_in_statz_and_healthz(tiers, tier):
    base = tiers[tier][1]
    assert _get(base, "/statz")["tier"] == tier
    health = _get(base, "/healthz")
    assert health["ok"] and health["tier"] == tier
    assert health["ready"]["lm"]["kind"] == "generative"


@pytest.mark.parametrize("route,body,code,kind", [
    ("lm:decode", {"artifact": {"prompt": [1]}}, 400, "bad_request"),
    ("lm:decode", {"artifact": "x"}, 400, "bad_request"),
    ("lm:prefill", {"tokens": []}, 400, "bad_request"),
    ("lm:prefill", {"tokens": [VOCAB]}, 400, "bad_request"),
    ("nope:prefill", {"tokens": [1, 2]}, 404, "model_unavailable"),
    ("nope:decode", {"artifact": None}, 400, "bad_request"),
], ids=["malformed_artifact", "artifact_not_an_object", "empty_prompt",
        "token_out_of_range", "unknown_model_prefill",
        "no_artifact_before_the_model"])
def test_http_error_answers(tiers, route, body, code, kind):
    got, out = _post(tiers["decode"][1], "/v1/models/" + route, body)
    assert got == code and out["kind"] == kind


@pytest.mark.parametrize("mutate,outcome", [b[1:] for b in BAD_ARTIFACTS],
                         ids=[b[0] for b in BAD_ARTIFACTS])
def test_http_decode_of_a_malformed_artifact(model, tiers, mutate, outcome):
    art, _ = _prefill(model, max_new_tokens=6)
    mutate(art)
    svc, base = tiers["decode"]
    other = svc.generate_async("lm", PROMPT[:5], max_new_tokens=24)
    code, out = _post(base, "/v1/models/lm:decode",
                      {"artifact": art.to_payload()})
    if outcome == "refused":
        assert code == 400 and out["kind"] == "bad_request"
    else:
        assert code == 200
        assert out["tokens"] == reference_decode(model, PROMPT, 6)
    assert len(_handoff_failures()) == 1
    # the request in flight beside it is untouched
    assert other.wait(timeout=300).tokens == \
        reference_decode(model, PROMPT[:5], 24)


def test_decode_body_limit_follows_the_pool_geometry(model, tiers):
    import io
    from types import SimpleNamespace
    from paddle_tpu_torch.serving import httpd
    from paddle_tpu_torch.serving.admission import ModelUnavailableError
    from paddle_tpu_torch.serving.disagg import max_payload_bytes
    svc = tiers["decode"][0]
    engine = svc._gen_entry("lm").engine
    limit = svc.handoff_body_limit("lm")
    assert limit == max_payload_bytes(engine.pool, MAX_SEQ) < httpd._MAX_BODY
    with pytest.raises(ModelUnavailableError):
        svc.handoff_body_limit("nope")
    # the body of a prompt that fills the context fits the limit
    art, _ = _prefill(model, prompt=[1] * (MAX_SEQ - 1), max_new_tokens=1)
    assert art.pages == pages_for(MAX_SEQ, 8)
    assert len(json.dumps({"artifact": art.to_payload()})) <= limit
    handler = SimpleNamespace(service=svc)
    assert httpd._Handler._body_limit(handler, "decode", "lm") == limit
    for route, name in (("decode", "nope"), ("generate", "lm"),
                        ("prefill", "lm")):
        assert httpd._Handler._body_limit(handler, route, name) \
            == httpd._MAX_BODY
    big = SimpleNamespace(headers={"Content-Length": str(limit + 1)},
                          rfile=io.BytesIO(b"{}"))
    with pytest.raises(ValueError, match="too large"):
        httpd.read_json_body(big, limit=limit)


def test_decode_of_an_unknown_model_is_404(model, tiers):
    art, _ = _prefill(model, max_new_tokens=3)
    code, out = _post(tiers["decode"][1], "/v1/models/nope:decode",
                      {"artifact": art.to_payload()})
    assert code == 404 and out["kind"] == "model_unavailable"


def test_service_tier_default_and_refusal():
    from paddle_tpu_torch.flags import FLAGS
    assert InferenceService().tier == FLAGS.serve_tier == ""
    with pytest.raises(ValueError, match="tier"):
        InferenceService(tier="bogus")


def test_service_prefill_engine_follows_the_model_version(model):
    svc = InferenceService(tier="prefill")
    try:
        svc.register_generative("lm", model, kv_pages=16, page_tokens=8)
        svc.prefill("lm", PROMPT, max_new_tokens=2)
        first = svc._prefill_engines["lm"]
        svc.register_generative("lm", model, kv_pages=16, page_tokens=8)
        svc.prefill("lm", PROMPT, max_new_tokens=2)
        second = svc._prefill_engines["lm"]
        assert (first[0], second[0]) == (1, 2)
        assert first[1]._closed and not second[1]._closed
        assert svc.stats["prefill"]["lm"]["prefills"] == 1
    finally:
        svc.close()
    assert second[1]._closed


def test_serve_cli_tier_prefill(tmp_path, model):
    from paddle_tpu_torch import cli, inference
    args = cli._parser().parse_args(["serve", "x", "--tier", "decode"])
    assert args.tier == "decode"
    with pytest.raises(SystemExit):
        cli._parser().parse_args(["serve", "x", "--tier", "bogus"])
    art = str(tmp_path / "gen")
    inference.export_generative(art, model.config, params=model.params)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", art, "--port",
         "0", "--device", "cpu", "--name", "lm", "--max_running", "2",
         "--kv_pages", "16", "--page_tokens", "8", "--tier", "prefill"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())["serving"]
        assert ready["tier"] == "prefill"
        base = "http://%s:%d" % (ready["host"], ready["port"])
        assert _get(base, "/statz")["tier"] == "prefill"
        code, pre = _post(base, "/v1/models/lm:prefill",
                          {"tokens": PROMPT, "max_new_tokens": 5})
        assert code == 200
        with _engine(model, name="dec") as dec:
            res = dec.submit_prefilled(
                HandoffArtifact.from_payload(pre["artifact"])).wait(300)
        assert res.tokens == reference_decode(model, PROMPT, 5)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr
    stopped = json.loads(stdout.strip().splitlines()[-1])["serving_stopped"]
    assert stopped["stats"]["tier"] == "prefill"
    assert stopped["stats"]["prefill"]["lm"]["prefills"] == 1
