"""paddle_tpu_torch.tune against its counterpart ``paddle_tpu.tune``, on
the CPU: the search spaces, the autotune loop (deterministic timers,
the stock rung, both fault sites), the winner cache (round trip,
corruption), the dispatch of ``mul`` and ``conv2d`` (fallback, hit,
winner, miss) with the Executor's counters, the ``tune`` verb, and two
checks across the packages: the populations each package's
``_tune_populations`` finds in the same programs, and the same tiny LM
trained in both with a matmul winner cached in each.

Every test gets a throwaway cache directory, fresh counters, disarmed
faults and a cold in-memory cache layer. Tolerances: a tuned ``mul`` or
``conv2d`` against the stock lowering 2e-4 relative and 1e-5 absolute
(the loop's parity gate for float32; the plain versions sum k tiles or
taps in another order); losses of the two packages 1e-5 relative at
every step, the tolerance of ``tests/test_torch_training.py``.
"""
import inspect
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import cli as jcli  # noqa: E402
from paddle_tpu import layers as jlayers  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import tune as jtune  # noqa: E402
from paddle_tpu.core import unique_name as jun  # noqa: E402
from paddle_tpu.flags import flags_guard  # noqa: E402
from paddle_tpu.tune import space as jspace  # noqa: E402
from paddle_tpu_torch import cli as tcli  # noqa: E402
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch import tune  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core import unique_name as tun  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.device import DEFAULT_DEVICE  # noqa: E402
from paddle_tpu_torch.core.scope import (Scope as TScope,  # noqa: E402
                                         scope_from_numpy)
from paddle_tpu_torch.flags import FLAGS  # noqa: E402
from paddle_tpu_torch.kernels import conv3x3 as tconv  # noqa: E402
from paddle_tpu_torch.kernels import matmul as tmm  # noqa: E402
from paddle_tpu_torch import models as tmodels  # noqa: E402
from paddle_tpu_torch.models import transformer as ttransformer  # noqa: E402
from paddle_tpu_torch.resilience import faults  # noqa: E402
from paddle_tpu_torch.resilience.events import (  # noqa: E402
    clear_events, events)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MM_KEY = {"m": 64, "k": 256, "n": 256, "dtype": "float32"}
CONV_KEY = {"n": 2, "h": 8, "w": 8, "c": 16, "o": 32, "dtype": "float32"}
RTOL, ATOL = 2e-4, 1e-5
LOSS_TOL = 1e-5


def _set_flags(**kw):
    old = {k: getattr(FLAGS, k) for k in kw}
    for k, v in kw.items():
        setattr(FLAGS, k, v)
    return old


@pytest.fixture(autouse=True)
def _isolated_tune(tmp_path):
    old = _set_flags(tune_cache_dir=str(tmp_path / "tune"), tune=True)
    tune.clear_memory_cache()
    tune.reset_counters()
    faults.reset()
    clear_events()
    yield tmp_path / "tune"
    tune.clear_memory_cache()
    tune.reset_counters()
    faults.reset()
    _set_flags(**old)


def _ck(kernel, key):
    return tune.cache_key(tune.device_kind(), kernel, tune.signature(key))


# -- spaces ------------------------------------------------------------------

def test_matmul_space_candidates_are_compiled_tilings_default_first():
    sp = tune.get_space("matmul")
    big = {"m": 8192, "k": 768, "n": 3072, "dtype": "float32"}
    cands = sp.candidates(big)
    assert cands[0] == sp.default_config(big) == tmm.DEFAULT_CONFIG
    assert len(cands) == len(tmm.TILINGS) == 12
    assert {(c["block_m"], c["block_n"], c["block_k"])
            for c in cands} == set(tmm.TILINGS)
    for cfg in cands:
        assert sp.is_valid(cfg, big)
        assert sp.smem_bytes(cfg, big) <= tune.space.SMEM_BUDGET
    assert sp.candidates(big, budget=3) == cands[:3]
    assert sp.candidates(big, budget=0) == []
    # m 64: a 128-row block would idle half its threads, so it is pruned,
    # but the default tiling stays valid at every shape
    small = sp.candidates(MM_KEY)
    assert small[0] == tmm.DEFAULT_CONFIG
    assert all(c["block_m"] == 64 for c in small[1:])
    assert len(small) == 1 + 6
    # a JAX tiling is not a tiling of this kernel
    assert not sp.is_valid({"block_m": 0, "block_n": 0, "block_k": 0},
                           MM_KEY)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_matmul_space_bf16_candidates_are_the_wgmma_tilings(dtype):
    # a bfloat16 key races the face's wgmma tilings, default first; a
    # float32 key at the same shape keeps the float32 face's 12
    sp = tune.get_space("matmul")
    key = {"m": 8192, "k": 3072, "n": 768, "dtype": dtype}
    cands = sp.candidates(key)
    want = tmm.TILINGS_BF16 if dtype == "bfloat16" else tmm.TILINGS
    default = tmm.default_config(dtype)
    assert cands[0] == sp.default_config(key) == default
    assert len(cands) == len(want)
    assert {(c["block_m"], c["block_n"], c["block_k"])
            for c in cands} == set(want)
    for cfg in cands:
        assert sp.smem_bytes(cfg, key) == tmm.smem_bytes(
            cfg["block_m"], cfg["block_n"], cfg["block_k"], dtype)
        assert sp.smem_bytes(cfg, key) <= tune.space.SMEM_BUDGET
    # a tiling of the other face is not valid for this one
    other = tmm.TILINGS if dtype == "bfloat16" else tmm.TILINGS_BF16
    assert not any(sp.is_valid(dict(zip(("block_m", "block_n", "block_k"),
                                        t)), key) for t in other)
    if dtype == "bfloat16":
        assert cands[0] == {"block_m": 128, "block_n": 128, "block_k": 64}
        # m 64 prunes the 128-row blocks but keeps the default
        small = sp.candidates(dict(key, m=64))
        assert small[0] == default
        assert [c["block_m"] for c in small[1:]] == [64, 64, 64]


def test_conv3x3_space_has_the_kernels_one_tiling():
    sp = tune.get_space("conv3x3")
    assert sp.candidates(CONV_KEY) == [{}]
    assert not sp.is_valid({"block_n": 2, "block_o": 0,
                            "grid_order": "no"}, CONV_KEY)
    # the footprint of the tiling the kernel's rule picks for the key:
    # 128 pixels are one block, too few for 128-row tiles, so 64 x 64
    assert sp.smem_bytes({}, CONV_KEY) == 3 * (64 * 36 + 32 * 72) * 4
    assert sp.smem_bytes({}, dict(CONV_KEY, n=32, h=56, w=56, c=64,
                                  o=64)) == 3 * (128 * 36 + 32 * 72) * 4
    assert tune.space_names() == ["conv3x3", "matmul"]
    with pytest.raises(KeyError, match="flash_attention"):
        tune.get_space("flash_attention")


@pytest.mark.parametrize("kernel,key", [("matmul", MM_KEY),
                                        ("conv3x3", CONV_KEY)])
def test_operands_are_the_jax_spaces_numbers(kernel, key):
    got = tune.get_space(kernel).make_operands(key, seed=3, device="cpu")
    want = jspace.get_space(kernel).make_operands(key, seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tune.signature(key) == jtune.signature(key)


@pytest.mark.parametrize("kernel", ["matmul", "conv3x3"])
def test_operands_default_to_the_card_like_every_entry_point(kernel):
    make = tune.get_space(kernel).make_operands
    assert DEFAULT_DEVICE == "cuda"
    assert inspect.signature(make).parameters["device"].default == \
        DEFAULT_DEVICE


def test_stock_rung_is_the_library_call_without_tf32():
    x, w = tune.get_space("matmul").make_operands(MM_KEY, device="cpu")
    assert torch.equal(tune.get_space("matmul").reference(MM_KEY)(x, w),
                       torch.matmul(x, w))
    x, w = tune.get_space("conv3x3").make_operands(CONV_KEY, device="cpu")
    got = tune.get_space("conv3x3").reference(CONV_KEY)(x, w)
    np.testing.assert_allclose(got.numpy(),
                               tconv.conv3x3_reference(x, w).numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.backends.cudnn.allow_tf32   # restored after the rung


def test_parity_scales_the_absolute_term_by_the_largest_magnitude():
    ref = torch.tensor([30.0, -12.0, 0.001, 0.0])
    # an error of 3e-5 on a value near 0 when the largest value is 30
    assert tune.parity_ok(ref, ref + torch.tensor([0., 0., 3e-5, -3e-5]))
    # the JAX rule, unscaled, where the values are at most 1
    small = torch.tensor([0.5, 0.001])
    assert not tune.parity_ok(small, small + torch.tensor([0., 3e-5]))
    # a TF32-sized error (~1e-3 of the scale) fails
    assert "elements outside" in tune.parity_report(
        ref, ref + torch.tensor([0., 0., 0.03, 0.]))
    assert "shape mismatch" in tune.parity_report(ref, ref[:2])
    assert "non-finite" in tune.parity_report(
        ref, torch.tensor([30.0, -12.0, float("nan"), 0.0]))


# -- loop --------------------------------------------------------------------

def test_autotune_deterministic_winner_under_the_table_timer():
    cands = tune.get_space("matmul").candidates(MM_KEY)
    target = dict(cands[-1])
    table = {frozenset(target.items()): 0.01,
             frozenset(tune.XLA_CONFIG.items()): 0.5}
    res = tune.autotune("matmul", MM_KEY, device="cpu",
                        timer=tune.table_timer(table, default=1.0))
    assert res.ok and res.winner == target and res.timer_kind == "table"
    assert all(r["status"] == "ok" for r in res.records)
    assert len(res.records) == 1 + len(cands)
    tune.clear_memory_cache()
    assert tune.WinnerCache().get_config(res.cache_key) == target
    assert res.cache_key == _ck("matmul", MM_KEY)


@pytest.mark.parametrize("kernel,key", [("matmul", MM_KEY),
                                        ("conv3x3", CONV_KEY)])
def test_model_timer_is_deterministic_and_prices_smem(kernel, key):
    runs = [tune.autotune(kernel, key, device="cpu", persist=False,
                          timer=tune.model_timer()) for _ in range(2)]
    assert [r["seconds"] for r in runs[0].records] == \
        [r["seconds"] for r in runs[1].records]
    assert runs[0].records[0]["seconds"] == 0.5
    sp = tune.get_space(kernel)
    for r in runs[0].records[1:]:
        frac = sp.smem_bytes(r["config"], key) / tune.space.SMEM_BUDGET
        assert r["seconds"] == pytest.approx(1.0 - 0.8 * frac)
    # every tiling of these kernels uses well under 5/8 of the budget,
    # so the stock rung wins deterministically
    assert runs[0].winner == tune.XLA_CONFIG
    assert tune.default_timer("cpu").kind == "model"


def test_stock_rung_always_in_the_race():
    res = tune.autotune("conv3x3", CONV_KEY, device="cpu",
                        timer=tune.table_timer({}))
    assert res.winner == tune.XLA_CONFIG
    assert res.records[0]["config"] == tune.XLA_CONFIG
    res = tune.autotune("matmul", MM_KEY, device="cpu", budget=1,
                        timer=tune.table_timer({}))
    assert [r["config"] for r in res.records] == [tune.XLA_CONFIG]


def test_candidate_fault_recorded_and_skipped():
    faults.arm("tune.candidate", "raise", nth=3, times=1)
    res = tune.autotune("matmul", MM_KEY, device="cpu",
                        timer=tune.model_timer())
    assert res.ok
    errs = [r for r in res.records if r["status"] == "error"]
    assert len(errs) == 1 and errs[0] is res.records[2]
    assert events(kind="tune_candidate_failed")
    assert events(kind="fault_injected", site="tune.candidate")
    assert faults.hits("tune.candidate") == len(res.records)


def test_parity_gate_skips_a_candidate_that_computes_wrong(monkeypatch):
    sp = tune.get_space("matmul")
    real = sp.build

    def build(config, key):
        fn = real(config, key)
        if config["block_k"] == 16:
            return lambda x, w: fn(x, w) * 1.01
        return fn

    monkeypatch.setattr(sp, "build", build)
    table = {frozenset(c.items()): 0.01 for c in sp.candidates(MM_KEY)
             if c["block_k"] == 16}
    res = tune.autotune("matmul", MM_KEY, device="cpu",
                        timer=tune.table_timer(table, default=1.0))
    bad = [r for r in res.records if r["status"] == "parity_fail"]
    assert bad and all(r["config"]["block_k"] == 16 for r in bad)
    assert all(r["seconds"] is None for r in bad)
    # the fast candidates all failed the gate: the first of the equal
    # rest, the stock rung, wins
    assert res.winner == tune.XLA_CONFIG


def test_build_failure_on_the_cpu_is_recorded_and_skipped(monkeypatch):
    sp = tune.get_space("matmul")

    def build(config, key):
        raise RuntimeError("no such tiling")

    monkeypatch.setattr(sp, "build", build)
    res = tune.autotune("matmul", MM_KEY, device="cpu", persist=False,
                        timer=tune.model_timer())
    assert res.winner == tune.XLA_CONFIG
    assert all(r["status"] == "error" for r in res.records[1:])


@pytest.mark.parametrize("dev,exc,skipped", [
    ("cpu", RuntimeError("launch failed"), True),
    ("cpu", faults.FaultError("injected"), True),
    ("cuda", faults.FaultError("injected"), True),
    ("cuda", RuntimeError("launch failed"), False),
])
def test_only_injected_faults_are_skipped_on_the_card(dev, exc, skipped):
    # on the card a kernel that fails to build or launch propagates out
    # of the loop instead of handing its shape to the stock rung
    from paddle_tpu_torch.tune import loop
    assert loop._skippable(exc, torch.device(dev)) is skipped


def test_zero_eligible_candidates_give_a_result_not_an_exception():
    faults.arm("tune.candidate", "raise", nth=1, times=None)
    res = tune.autotune("conv3x3", CONV_KEY, device="cpu", persist=False,
                        timer=tune.model_timer())
    assert not res.ok and res.winner is None and res.winner_seconds is None
    assert all(r["status"] == "error" for r in res.records)
    assert res.row()["failed"] == len(res.records) == 2


# -- cache -------------------------------------------------------------------

def test_cache_round_trip_and_drop(_isolated_tune):
    cache = tune.WinnerCache()
    key = tune.cache_key("cpu", "matmul", "sig=1")
    cache.put(key, {"block_m": 64}, time_ms=1.5, timer="model")
    assert cache.get_config(key) == {"block_m": 64}
    assert cache.path == str(_isolated_tune / "winners.torch.json")
    tune.clear_memory_cache()
    again = tune.WinnerCache()
    assert again.get_config(key) == {"block_m": 64}
    assert again.get(key)["timer"] == "model"
    with open(again.path) as f:
        assert json.load(f)["schema"] == "paddle_tpu_torch.tune.v1"
    assert again.drop(key) and not again.drop(key)
    tune.clear_memory_cache()
    assert tune.WinnerCache().get_config(key) is None


def test_cache_entry_crc_detects_manual_bit_rot(_isolated_tune):
    cache = tune.WinnerCache()
    k1 = tune.cache_key("cpu", "matmul", "sig=1")
    k2 = tune.cache_key("cpu", "matmul", "sig=2")
    cache.put(k1, {"block_m": 64})
    cache.put(k2, {"block_m": 128})
    with open(cache.path) as f:
        doc = json.load(f)
    doc["entries"][k1]["config"]["block_m"] = 8
    with open(cache.path, "w") as f:
        json.dump(doc, f)
    tune.clear_memory_cache()
    fresh = tune.WinnerCache()
    assert fresh.get_config(k1) is None
    assert fresh.get_config(k2) == {"block_m": 128}
    assert events(kind="tune_cache_corrupt")


def test_cache_fault_site_corruption_detected_and_retuned():
    timer = tune.model_timer()
    faults.arm("tune.cache", "corrupt", nth=1, times=1, seed=3)
    res = tune.autotune("matmul", MM_KEY, device="cpu", timer=timer)
    faults.reset()
    tune.clear_memory_cache()
    assert tune.WinnerCache().get_config(res.cache_key) is None
    assert events(kind="tune_cache_corrupt")
    assert events(kind="fault_injected", site="tune.cache")
    res2 = tune.autotune("matmul", MM_KEY, device="cpu", timer=timer)
    tune.clear_memory_cache()
    assert tune.WinnerCache().get_config(res2.cache_key) == res2.winner


def test_unparseable_cache_file_is_empty_not_fatal():
    cache = tune.WinnerCache()
    cache.put(tune.cache_key("cpu", "x", "s"), {"a": 1})
    with open(cache.path, "w") as f:
        f.write("{ not json")
    tune.clear_memory_cache()
    assert tune.WinnerCache().entries() == {}
    assert events(kind="tune_cache_corrupt")
    # and dispatch on a corrupt cache is all-miss, never a crash
    assert tune.lookup("matmul", MM_KEY) is None
    assert tune.counters()["tune_fallbacks"] == 1


def test_the_packages_never_read_each_others_winners(_isolated_tune):
    """One cache directory for both packages (the same flag): each
    writes its own file and schema."""
    with flags_guard(tune_cache_dir=str(_isolated_tune), tune=True):
        jtune.clear_memory_cache()
        jck = jtune.cache_key("cpu", "matmul", jtune.signature(MM_KEY))
        jtune.WinnerCache().put(jck, {"block_m": 8, "block_n": 128,
                                      "block_k": 128})
        tune.WinnerCache().put(_ck("matmul", MM_KEY),
                               {"block_m": 64, "block_n": 64,
                                "block_k": 8})
        tune.clear_memory_cache()
        jtune.clear_memory_cache()
        assert sorted(os.listdir(_isolated_tune)) == ["winners.json",
                                                      "winners.torch.json"]
        assert jtune.WinnerCache().get_config(jck)["block_k"] == 128
        assert tune.WinnerCache().get_config(
            _ck("matmul", MM_KEY))["block_k"] == 8
    jtune.clear_memory_cache()


# -- dispatch ----------------------------------------------------------------

def _fc_program(size):
    main, startup = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, startup):
        x = tlayers.data("x", shape=[256], dtype="float32")
        out = tlayers.fc(input=x, size=size, bias_attr=False)
    return main, startup, out


def _run(main, startup, out, feed):
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(startup, scope=scope)
    val, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    return val, exe.stats


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_mul_dispatch_fallback_hit_and_winner(monkeypatch):
    main, startup, out = _fc_program(256)
    feed = {"x": np.random.RandomState(0).randn(64, 256).astype(np.float32)}
    calls = _spy(monkeypatch, tmm, "matmul")
    v_stock, stats = _run(main, startup, out, feed)
    assert stats["tune_fallbacks"] == 1 and stats["tune_hits"] == 0
    assert not calls

    tune.WinnerCache().put(_ck("matmul", MM_KEY), dict(tune.XLA_CONFIG))
    tune.reset_counters()
    v_hit, stats = _run(main, startup, out, feed)
    assert stats["tune_hits"] == 1 and stats["tune_fallbacks"] == 0
    assert not calls
    np.testing.assert_array_equal(v_stock, v_hit)

    win = {"block_m": 64, "block_n": 128, "block_k": 32}
    tune.WinnerCache().put(_ck("matmul", MM_KEY), win)
    tune.reset_counters()
    v_kernel, stats = _run(main, startup, out, feed)
    assert stats["tune_hits"] == 1
    assert len(calls) == 1 and calls[0][0][3] == win
    np.testing.assert_allclose(v_kernel, v_stock, rtol=RTOL, atol=ATOL)

    # FLAGS.tune 0: no consult, a fallback, the stock product
    _set_flags(tune=False)
    tune.reset_counters()
    v_off, stats = _run(main, startup, out, feed)
    assert stats["tune_hits"] == 0 and stats["tune_fallbacks"] == 1
    np.testing.assert_array_equal(v_off, v_stock)
    assert len(calls) == 1


def test_a_cached_bf16_triple_outside_the_tilings_is_a_miss_on_the_default(
        monkeypatch):
    """A winner whose triple is not one of the bfloat16 face's tilings (a
    triple of the face before its wgmma kernel) counts as a miss, not a
    hit, and the kernel runs the face's default tiling."""
    from paddle_tpu_torch import amp as tamp
    main, startup, out = _fc_program(256)
    tamp.enable(main)
    feed = {"x": np.random.RandomState(0).randn(64, 256).astype(np.float32)}
    calls = _spy(monkeypatch, tmm, "matmul")
    stale = {"block_m": 128, "block_n": 128, "block_k": 32}
    assert not tmm.is_tiling(stale, torch.bfloat16)
    tune.WinnerCache().put(_ck("matmul", dict(MM_KEY, dtype="bfloat16")),
                           stale)
    prev = tamp.force(True)           # the AMP casts on the CPU too
    try:
        v_stale, stats = _run(main, startup, out, feed)
        assert stats["tune_misses"] == 1 and stats["tune_hits"] == 0
        assert len(calls) == 1 and calls[0][0][3] == {}
        assert calls[0][0][0].dtype == torch.bfloat16
        # the same product as a winner of the default tiling, a hit
        tune.WinnerCache().put(
            _ck("matmul", dict(MM_KEY, dtype="bfloat16")),
            tmm.default_config(torch.bfloat16))
        tune.reset_counters()
        v_default, stats = _run(main, startup, out, feed)
    finally:
        tamp.force(prev)
    assert stats["tune_hits"] == 1 and stats["tune_misses"] == 0
    assert len(calls) == 2
    np.testing.assert_array_equal(v_stale, v_default)


def test_mul_outside_the_population_is_a_recorded_fallback(monkeypatch):
    main, startup, out = _fc_program(100)
    calls = _spy(monkeypatch, tmm, "matmul")
    feed = {"x": np.ones((64, 256), np.float32)}
    _, stats = _run(main, startup, out, feed)
    assert stats["tune_fallbacks"] == 1 and not calls


def _conv_program(conv_impl="conv"):
    main, startup = tir.Program(), tir.Program()
    with tun.guard(), tir.program_guard(main, startup):
        img = tlayers.data("img", shape=[16, 8, 8], dtype="float32")
        out = tlayers.conv2d(input=img, num_filters=32, filter_size=3,
                             padding=1)
    for op in main.global_block().ops:
        if op.type == "conv2d":
            op.attrs["conv_impl"] = conv_impl
    return main, startup, out


def _conv_feed():
    return {"img": np.random.RandomState(0).randn(2, 16, 8, 8)
            .astype(np.float32)}


def test_conv2d_dispatch_fallback_then_hit_and_bit_identity(monkeypatch):
    calls = _spy(monkeypatch, tconv, "conv3x3_s1_nhwc")
    main, startup, out = _conv_program()
    v_stock, stats = _run(main, startup, out, _conv_feed())
    assert stats["tune_hits"] == 0 and stats["tune_fallbacks"] >= 1
    tune.WinnerCache().put(_ck("conv3x3", CONV_KEY), dict(tune.XLA_CONFIG))
    tune.reset_counters()
    # a stock winner outranks a program that opts the kernel in
    main, startup, out = _conv_program("pallas3x3")
    v_hit, stats = _run(main, startup, out, _conv_feed())
    assert stats["tune_hits"] >= 1 and not calls
    np.testing.assert_array_equal(v_stock, v_hit)


def test_conv2d_winner_routes_to_the_kernel_wrapper(monkeypatch):
    calls = _spy(monkeypatch, tconv, "conv3x3_s1_nhwc")
    tune.WinnerCache().put(_ck("conv3x3", CONV_KEY), {})
    main, startup, out = _conv_program()
    v_kernel, stats = _run(main, startup, out, _conv_feed())
    assert stats["tune_hits"] >= 1 and len(calls) == 1
    _set_flags(tune=False)
    tune.reset_counters()
    v_stock, stats = _run(main, startup, out, _conv_feed())
    assert stats["tune_hits"] == 0 and stats["tune_fallbacks"] >= 1
    assert len(calls) == 1
    np.testing.assert_allclose(v_kernel, v_stock, rtol=RTOL, atol=ATOL)


def test_conv2d_miss_under_pallas3x3_equals_the_legacy_kernel_path(
        monkeypatch):
    calls = _spy(monkeypatch, tconv, "conv3x3_s1_nhwc")
    main, startup, out = _conv_program("pallas3x3")
    _set_flags(tune=False)
    v_legacy, stats = _run(main, startup, out, _conv_feed())
    assert stats["tune_misses"] == 1 and len(calls) == 1
    _set_flags(tune=True)
    tune.reset_counters()
    v_miss, stats = _run(main, startup, out, _conv_feed())
    assert stats["tune_misses"] == 1 and len(calls) == 2
    tune.WinnerCache().put(_ck("conv3x3", CONV_KEY), {})
    tune.reset_counters()
    v_winner, stats = _run(main, startup, out, _conv_feed())
    assert stats["tune_hits"] == 1 and len(calls) == 3
    np.testing.assert_array_equal(v_legacy, v_miss)
    np.testing.assert_array_equal(v_legacy, v_winner)


def test_lookup_decision_table():
    assert tune.lookup("matmul", MM_KEY) is None
    assert tune.lookup("conv3x3", CONV_KEY, enabled=True) == {}
    tune.WinnerCache().put(_ck("matmul", MM_KEY), {"block_m": 64})
    assert tune.lookup("matmul", MM_KEY) == {"block_m": 64}
    tune.record_fallback("matmul")
    assert tune.counters() == {"tune_hits": 1, "tune_misses": 1,
                               "tune_fallbacks": 2}
    tune.reset_counters()
    assert set(tune.counters().values()) == {0}


# -- CLI ---------------------------------------------------------------------

LM_CONFIG = """\
from paddle_tpu_torch.configs import tiny_lm


def model():
    return tiny_lm.model(vocab=32, seq=16, batch=2, hidden=128,
                         num_layers=2, num_heads=4)
"""

CONV_CONFIG = """\
from paddle_tpu_torch import layers


def model():
    img = layers.data(name="img", shape=[16, 8, 8], dtype="float32")
    out = layers.conv2d(input=img, num_filters=32, filter_size=3,
                        padding=1)
    return {"cost": layers.mean(out), "feed_list": [img], "reader": None}
"""


@pytest.fixture
def config_file(tmp_path):
    def make(text, name):
        p = tmp_path / name
        p.write_text(text)
        return str(p)
    return make


def test_cli_dry_run_lists_the_lm_matmul_populations(config_file, capsys):
    cfg = config_file(LM_CONFIG, "lm_config.py")
    rc = tcli.main(["tune", cfg, "--dry-run", "--device", "cpu",
                    "--batch", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "dry run" in out
    for sig in ("dtype=float32,k=128,m=32,n=128",
                "dtype=float32,k=128,m=32,n=512",
                "dtype=float32,k=512,m=32,n=128"):
        assert sig in out
    assert "flash_attention" in out and "not yet tunable" in out
    assert not os.path.exists(tune.WinnerCache().path)


def test_cli_dry_run_lists_the_resnet_cifar_conv3x3_populations(capsys):
    rc = tcli.main(["tune", os.path.join(ROOT, "paddle_tpu_torch", "configs",
                                         "resnet_cifar.py"),
                    "--dry-run", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    rows = [ln for ln in out.splitlines() if ln.startswith("conv3x3")]
    # the 3x3 / s1 convs of ResNet-20 at batch 8: stem, and one shape a
    # stage (the stride-2 entries are outside the population)
    assert len(rows) == 4
    assert "c=3,dtype=float32,h=32,n=8,o=16,w=32" in out


def test_cli_bad_config_exits_two(tmp_path):
    bad = tmp_path / "bad_config.py"
    bad.write_text("def model():\n    raise RuntimeError('nope')\n")
    assert tcli.main(["tune", str(bad), "--device", "cpu"]) == 2


def test_cli_end_to_end_caches_crc_winners(config_file, tmp_path, capsys):
    cfg = config_file(CONV_CONFIG, "conv_config.py")
    out = tmp_path / "tune_evidence.json"
    rc = tcli.main(["tune", cfg, "--device", "cpu", "--batch", "2",
                    "--out", str(out)])
    assert rc == 0
    tune.clear_memory_cache()
    entries = tune.WinnerCache().entries()
    assert list(entries) == [_ck("conv3x3", CONV_KEY)]
    for e in entries.values():
        assert e["timer"] == "model" and e["crc32"]
    rec = json.loads(out.read_text())
    assert rec["schema"] == "paddle_tpu.bench.v1"
    assert rec["rows"][0]["kernel"] == "conv3x3"
    assert [r["config"] for r in rec["rows"][0]["records"]] == \
        [tune.XLA_CONFIG, {}]


def test_cli_exits_one_when_a_population_has_no_eligible_candidate(
        config_file, tmp_path):
    cfg = config_file(CONV_CONFIG, "conv_config.py")
    faults.arm("tune.candidate", "raise", nth=1, times=None)
    out = tmp_path / "ev.json"
    assert tcli.main(["tune", cfg, "--device", "cpu", "--batch", "2",
                      "--timer", "model", "--out", str(out)]) == 1
    rows = json.loads(out.read_text())["rows"]
    assert [r["failed"] for r in rows] == [r["candidates"] for r in rows]


def test_cli_rejects_a_dtype_the_kernels_do_not_take(config_file):
    cfg = config_file(CONV_CONFIG, "conv_config.py")
    with pytest.raises(SystemExit) as e:
        tcli.main(["tune", cfg, "--device", "cpu", "--dtype", "bfloat16",
                   "--dry-run"])
    assert e.value.code == 2


# -- across the packages -----------------------------------------------------

LM = dict(vocab=32, seq=16, hidden=128, num_layers=2, num_heads=4)
LM_BATCH = 2
LM_STEPS = 3


def _lm_program(pkg):
    """tiny LM at hidden 128 with Adam, built under the package's
    unique_name guard so every var has the same name in both."""
    if pkg == "jax":
        main, startup = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, startup):
            toks = jlayers.data("toks", shape=[LM["seq"]], dtype="int64")
            toks.shape = (-1, LM["seq"])
            tgt = jlayers.data("tgt", shape=[LM["seq"]], dtype="int64")
            tgt.shape = (-1, LM["seq"])
            logits = jmodels.transformer_lm(
                toks, vocab_size=LM["vocab"], hidden=LM["hidden"],
                num_layers=LM["num_layers"], num_heads=LM["num_heads"])
            flat = jlayers.reshape(logits, shape=[-1, LM["vocab"]])
            cost = jlayers.mean(jlayers.softmax_with_cross_entropy(
                flat, jlayers.reshape(tgt, shape=[-1, 1])))
            jpt.optimizer.Adam(learning_rate=0.01).minimize(cost)
    else:
        main, startup = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, startup):
            toks = tlayers.data("toks", shape=[LM["seq"]], dtype="int64")
            toks.shape = (-1, LM["seq"])
            tgt = tlayers.data("tgt", shape=[LM["seq"]], dtype="int64")
            tgt.shape = (-1, LM["seq"])
            logits = ttransformer.transformer_lm(
                toks, vocab_size=LM["vocab"], hidden=LM["hidden"],
                num_layers=LM["num_layers"], num_heads=LM["num_heads"])
            flat = tlayers.reshape(logits, shape=[-1, LM["vocab"]])
            cost = tlayers.mean(tlayers.softmax_with_cross_entropy(
                flat, tlayers.reshape(tgt, shape=[-1, 1])))
            topt.Adam(learning_rate=0.01).minimize(cost)
    return main, startup, cost


def _resnet_program(pkg):
    if pkg == "jax":
        main, startup = jpt.Program(), jpt.Program()
        with jun.guard(), jpt.program_guard(main, startup):
            img = jlayers.data("img", shape=[3, 16, 16], dtype="float32")
            jmodels.resnet(img, class_dim=10, depth=20,
                           variant="cifar")
    else:
        main, startup = tir.Program(), tir.Program()
        with tun.guard(), tir.program_guard(main, startup):
            img = tlayers.data("img", shape=[3, 16, 16], dtype="float32")
            tmodels.resnet(img, class_dim=10, depth=20, variant="cifar")
    return main


def _sigs(pops):
    return [(kernel, jtune.signature(key)) for kernel, key in pops
            if kernel in ("matmul", "conv3x3")]


@pytest.mark.parametrize("program,batch,kernels,flash", [
    (lambda p: _lm_program(p)[0], LM_BATCH, ["matmul"] * 3, 1),
    (_resnet_program, 4, ["conv3x3"] * 4, 0)], ids=["tiny_lm", "resnet20"])
def test_both_packages_find_the_same_populations(program, batch, kernels,
                                                 flash):
    jax_pops = jcli._tune_populations(program("jax"), batch)
    got, got_flash = tcli._tune_populations(program("port"), batch)
    # the JAX package keys the attention output projection, whose input
    # is a reshape with a copied (0) batch dim, with m 0: a population
    # no run dispatches. The port takes the 0 as the batch, so that gemm
    # joins q / k / v's population (ROADMAP.md, faults of the reference)
    jax_m0 = [s for s in _sigs(jax_pops) if ",m=0," in s[1]]
    assert len(jax_m0) == flash
    assert _sigs(got) == [s for s in _sigs(jax_pops) if s not in jax_m0]
    assert [k for k, _ in got] == kernels
    # the flash-attention population is found and left untuned
    assert len(got_flash) == flash == \
        [k for k, _ in jax_pops].count("flash_attention")


def _lm_batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(LM_STEPS):
        xs = rng.randint(0, LM["vocab"], (LM_BATCH, LM["seq"])).astype(
            np.int64)
        out.append({"toks": xs, "tgt": (xs + 1) % LM["vocab"]})
    return out


def test_tiny_lm_trains_alike_with_a_matmul_winner_in_each_package(
        _isolated_tune, monkeypatch):
    """Both packages cache a kernel tiling for every gemm population of
    the LM (each its own kernel's tiling) and train LM_STEPS Adam steps
    from the JAX startup state: the losses agree at every step, and each
    package's counters say hit for the in-population gemms and fallback
    for the vocab head (N 32)."""
    jmain, jstart, jcost = _lm_program("jax")
    tmain, tstart, tcost = _lm_program("port")
    pops, _ = tcli._tune_populations(tmain, LM_BATCH)
    assert [k for k, _ in pops] == ["matmul"] * 3
    with flags_guard(tune_cache_dir=str(_isolated_tune), tune=True):
        jtune.clear_memory_cache()
        jtune.reset_counters()
        from paddle_tpu.tune.results import device_kind as jkind
        for _, key in pops:
            sig = jtune.signature(key)
            jtune.WinnerCache().put(
                jtune.cache_key(jkind(), "matmul", sig),
                {"block_m": 8, "block_n": 128, "block_k": 128})
            tune.WinnerCache().put(
                _ck("matmul", key),
                {"block_m": 64, "block_n": 64, "block_k": 32})
        batches = _lm_batches()
        persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
        jexe, jscope = jpt.Executor(jpt.CPUPlace()), jpt.Scope()
        with jpt.scope_guard(jscope):
            jexe.run(jstart)
            state = {n: np.asarray(jscope.find_var(n)) for n in persist
                     if jscope.find_var(n) is not None}
            jtune.reset_counters()
            jlosses = [float(np.asarray(jexe.run(
                jmain, feed=feed, fetch_list=[jcost])[0]).reshape(-1)[0])
                for feed in batches]
            jstats = dict(jexe.stats)
    jtune.clear_memory_cache()
    jtune.reset_counters()

    calls = _spy(monkeypatch, tmm, "matmul")
    texe, tscope = TExecutor("cpu"), TScope()
    texe.run(tstart, scope=tscope)
    scope_from_numpy(state, device="cpu", scope=tscope)
    tune.reset_counters()
    tlosses = [float(texe.run(tmain, feed=feed, fetch_list=[tcost],
                              scope=tscope)[0].reshape(-1)[0])
               for feed in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_TOL, atol=0)
    # both packages count once per trace: 12 gemms in population hit,
    # the head falls back. The port's trace is a step key's first
    # lowering pass; its capture and the CPU's stand-in for a replay
    # run the lowerings (the kernel is called every step) and count
    # nothing (ROADMAP Queue 3 #4, closed)
    # (JAX's tune_misses come from the flash op's consult, not ported)
    assert jstats["tune_hits"] == 12 and jstats["tune_fallbacks"] == 1
    assert texe.stats["tune_hits"] == jstats["tune_hits"]
    assert texe.stats["tune_fallbacks"] == jstats["tune_fallbacks"]
    assert texe.stats["tune_misses"] == 0
    assert len(calls) == 12 * LM_STEPS
