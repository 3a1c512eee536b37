"""Fault injection of the port (``paddle_tpu_torch/resilience/faults.py``)
against the JAX package's (``paddle_tpu/resilience/faults.py``), on the
CPU: the fault-spec cases of ``tests/test_resilience.py`` and the
registry conformance walk of ``tests/test_trainer_resilience.py``.

- ``parse_fault_spec`` gives the same entries as the JAX package's on
  the same specs, and both refuse the same malformed ones.
- ``PADDLE_TPU_FAULT_SPEC`` is armed by the first ``fault_point``;
  ``load_fault_spec``, ``armed``, the nth/times window, the ``delay``
  action, seeded size-preserving corruption and hit counting under
  threads behave as in the JAX package.
- ``SITE_TABLE`` is the port's ten sites: it agrees with the docstring
  table, every site arms and fires, sits at its documented module, and
  a site marked delay-documented says what a delay means there.

Tolerance: none (exact equality).
"""
import os
import re
import subprocess
import sys
import threading

import pytest

pytest.importorskip("torch")

from paddle_tpu import resilience as JR  # noqa: E402
from paddle_tpu_torch import resilience as TR  # noqa: E402
from paddle_tpu_torch.resilience import faults  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = [
    "checkpoint.write:corrupt:nth=2,seed=7",
    "checkpoint.write:corrupt:nth=2,seed=7;"
    "serving.ship:raise:nth=1,times=2,exc=ConnectionError;"
    "pipeline.feed_next:delay:nth=*,delay=0.01;"
    "checkpoint.load:raise:message=disk_gone",
    "trainer.step:delay:nth=3,delay=3600",
    "trainer.step:raise:nth=2,times=*",
    " tune.cache : corrupt ; ;serving.generate:delay:delay=0.5,times=3 ",
    "",
]
BAD_SPECS = ["justasite", "s:badaction", "s:raise:nth=x",
             "s:raise:exc=NotAnException", "s:raise:wat=1",
             "s:delay:delay", "s:raise:times=y"]


@pytest.fixture(autouse=True)
def _clean_registry():
    for R in (JR, TR):
        R.reset()
        R.clear_events()
    yield
    for R in (JR, TR):
        R.reset()
        R.clear_events()


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_as_in_jax(spec):
    assert TR.parse_fault_spec(spec) == JR.parse_fault_spec(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_a_malformed_spec_is_refused_as_in_jax(spec):
    with pytest.raises(ValueError):
        JR.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        TR.parse_fault_spec(spec)


def test_fault_spec_entries():
    entries = TR.parse_fault_spec(SPECS[1])
    assert entries[0] == {"site": "checkpoint.write", "action": "corrupt",
                          "nth": 2, "seed": 7}
    assert entries[1]["exc"] is ConnectionError
    assert entries[1]["nth"] == 1 and entries[1]["times"] == 2
    assert entries[2]["nth"] == 1 and entries[2]["times"] is None
    assert entries[3]["message"] == "disk gone"


def test_load_fault_spec_arms_from_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC",
                       "trainer.step:raise:nth=1,exc=TimeoutError")
    assert TR.load_fault_spec() == 1
    assert TR.armed() == {"trainer.step": "raise"}
    with pytest.raises(TimeoutError):
        TR.fault_point("trainer.step")


def test_an_unknown_site_is_refused_by_the_port():
    """The port arms only its own sites (the JAX package takes any
    name): a spec naming a JAX-only site fails where it is loaded."""
    with pytest.raises(ValueError):
        TR.load_fault_spec("async_sgd.push_grads:raise")
    assert TR.armed() == {}


def test_the_first_fault_point_arms_the_environment_spec():
    """A fresh process with the variable set: the first fault_point arms
    it, once; a malformed spec warns and arms nothing."""
    code = (
        "import warnings\n"
        "from paddle_tpu_torch.resilience import faults as f\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    f.fault_point('tune.cache')\n"
        "print(sorted(f.armed().items()), len(w))\n"
        "try:\n"
        "    f.fault_point('trainer.step'); f.fault_point('trainer.step')\n"
        "except f.FaultError as e:\n"
        "    print('raised', f.hits('trainer.step'))\n")
    for spec, want in (
            ("trainer.step:raise:nth=2", "[('trainer.step', 'raise')] 0\n"
                                         "raised 2\n"),
            ("trainer.step:nope", "[] 1\n")):
        env = dict(os.environ, PYTHONPATH=ROOT, PADDLE_TPU_FAULT_SPEC=spec)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.stdout == want, out.stderr


def test_fault_nth_hit_window_as_in_jax():
    for R, site in ((JR, "trainer.step"), (TR, "trainer.step")):
        R.arm(site, action="raise", nth=3, times=2)
        R.fault_point(site)  # 1
        R.fault_point(site)  # 2
        for _ in range(2):   # 3, 4 fire
            with pytest.raises(R.FaultError):
                R.fault_point(site)
        R.fault_point(site)  # 5: the window is closed
        assert R.hits(site) == 5
        assert len(R.events(kind="fault_injected", site=site)) == 2


def test_delay_action_sleeps_its_delay_at_each_firing_hit(monkeypatch):
    slept = []
    monkeypatch.setattr(faults, "time",
                        type("T", (), {"sleep": staticmethod(slept.append)}))
    TR.load_fault_spec("trainer.step:delay:nth=2,times=2,delay=1.5")
    payload = object()
    assert [TR.fault_point("trainer.step", payload) is payload
            for _ in range(4)] == [True] * 4
    assert slept == [1.5, 1.5]
    assert [e["hit"] for e in TR.events(kind="fault_injected")] == [1, 2]


def test_corrupt_is_seeded_and_size_preserving():
    payload = b"checkpoint shard bytes" * 32

    def corrupt_once(seed):
        TR.reset()
        TR.arm("checkpoint.write", action="corrupt", nth=1, seed=seed)
        return TR.fault_point("checkpoint.write", payload)

    a, b, c = corrupt_once(5), corrupt_once(5), corrupt_once(6)
    assert a == b != c
    assert a != payload and len(a) == len(payload)


def test_fault_point_counts_every_hit_across_threads():
    TR.arm("pipeline.feed_next", action="raise", nth=10_000)
    n_threads, per = 8, 250

    def spin():
        for _ in range(per):
            TR.fault_point("pipeline.feed_next")

    ts = [threading.Thread(target=spin) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert TR.hits("pipeline.feed_next") == n_threads * per


# -- the registry: code, table and docstring agree -----------------------------

def _docstring_table_sites():
    return re.findall(r"^``([a-z_0-9]+\.[a-z_0-9]+)``", faults.__doc__,
                      re.MULTILINE)


def test_site_table_matches_the_docstring_table():
    doc = _docstring_table_sites()
    assert sorted(doc) == sorted(faults.SITE_TABLE)
    assert len(doc) == len(set(doc)) == 10


def test_every_port_site_is_a_jax_site_in_the_same_module():
    from paddle_tpu.resilience import faults as jfaults
    for site, (module, armable, delay_doc) in faults.SITE_TABLE.items():
        assert jfaults.SITE_TABLE[site] == (module, armable, delay_doc), site


@pytest.mark.parametrize("site", sorted(faults.SITE_TABLE))
def test_every_site_arms_and_fires(site):
    TR.arm(site, "raise", nth=1, times=1)
    with pytest.raises(TR.FaultError):
        TR.fault_point(site)
    # outside the firing window the site passes its payload through
    assert TR.fault_point(site, "payload") == "payload"
    assert TR.disarm(site)


@pytest.mark.parametrize("site", sorted(faults.SITE_TABLE))
def test_every_site_sits_at_its_documented_module(site):
    module, armable, _ = faults.SITE_TABLE[site]
    path = os.path.join(ROOT, "paddle_tpu_torch", module)
    with open(path) as f:
        src = f.read()
    assert armable
    assert re.search(r'fault_point\(\s*"%s"' % re.escape(site), src), \
        "no fault_point(%r) in %s" % (site, module)


def test_delay_marked_sites_document_delay_semantics():
    rows = re.split(r"^``", faults.__doc__, flags=re.MULTILINE)
    doc_of = {}
    for row in rows:
        m = re.match(r"([a-z_0-9]+\.[a-z_0-9]+)``", row)
        if m:
            doc_of[m.group(1)] = row
    for site, (_m, _armable, delay_doc) in faults.SITE_TABLE.items():
        if delay_doc:
            assert "delay" in doc_of[site], site
    assert faults.SITE_TABLE["trainer.step"][2]


def test_the_package_exports_what_the_jax_one_exports_of_these_modules():
    want = {"record_event", "record_durable_event", "events",
            "clear_events", "FaultError", "SITE_TABLE", "arm", "disarm",
            "reset", "hits", "armed", "fault_point", "parse_fault_spec",
            "load_fault_spec", "StepWatchdog", "STEP_HUNG_EXIT",
            "NumericGuard"}
    assert want <= set(JR.__all__)
    assert set(TR.__all__) == want
    for name in want:
        assert hasattr(TR, name), name
    TR.record_event("x", site="a")
    # resilience.events is callable as the JAX package's function, and
    # stays the events module
    assert [e["kind"] for e in TR.events(kind="x")] == ["x"]
    assert TR.events.events(kind="x") == TR.events(kind="x")
