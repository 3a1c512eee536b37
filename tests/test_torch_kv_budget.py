"""PT034, the KV pool's memory-budget check, in the port against the JAX
package on the CPU: ``kv_pool_bytes`` and ``check_kv_pool`` over a grid
of geometries (the message strings word for word), the validator's
problem list and ``generative_memory_bytes`` for one artifact, plain
and as a speculative pairing, the budget's resolution order, and the
serve verb's refusals. Both packages read the same artifact directory,
so every number and string must be equal, not close.
"""
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import inference as jinf  # noqa: E402
from paddle_tpu.analysis import memory as jmem  # noqa: E402
from paddle_tpu.flags import flags_guard  # noqa: E402
from paddle_tpu_torch import inference as tinf  # noqa: E402
from paddle_tpu_torch.analysis import memory as tmem  # noqa: E402
from paddle_tpu_torch.flags import FLAGS  # noqa: E402
from paddle_tpu_torch.models import transformer as ttm  # noqa: E402

GEOMETRIES = [(2, 2, 8, 64, 8), (12, 12, 64, 1024, 16), (1, 1, 1, 0, 1),
              (24, 16, 128, 4096, 32), (12, 12, 64, 57, 16)]
BUDGETS = [None, 0, 1 << 20, 500 << 20, 2 << 30, 80 << 30]


@pytest.fixture
def _budget_flag():
    old = FLAGS.memory_budget_gb
    yield
    FLAGS.memory_budget_gb = old


def _cfg(hidden=32, layers=2, seed=0):
    return ttm.TransformerConfig(vocab_size=50, hidden=hidden,
                                 num_layers=layers, num_heads=4, max_seq=64)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A plain artifact and a speculative pairing, written by the port."""
    root = tmp_path_factory.mktemp("kv_budget")
    cfg, dcfg = _cfg(), _cfg(hidden=16, layers=1)
    plain = str(root / "plain")
    tinf.export_generative(plain, cfg, params=ttm.init_params(cfg, seed=1))
    spec = str(root / "spec")
    tinf.export_speculative(spec, cfg, dcfg, 3,
                            params=ttm.init_params(cfg, seed=1),
                            draft_params=ttm.init_params(dcfg, seed=2))
    return {"plain": plain, "spec": spec}


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_kv_pool_bytes_and_check_equal_jax(geo):
    layers, heads, head_dim, pages, ptokens = geo
    assert tmem.kv_pool_bytes(*geo) == jmem.kv_pool_bytes(*geo)
    pool = tmem.kv_pool_bytes(*geo)
    for model_bytes in (0, 12345, pool):
        for budget in BUDGETS + [pool, pool + model_bytes,
                                 pool + model_bytes - 1]:
            got = tmem.check_kv_pool(layers, heads, head_dim, pages,
                                     ptokens, model_bytes=model_bytes,
                                     budget_bytes=budget)
            want = jmem.check_kv_pool(layers, heads, head_dim, pages,
                                      ptokens, model_bytes=model_bytes,
                                      budget_bytes=budget)
            assert [str(d) for d in got] == [str(d) for d in want]
            assert [d.code for d in got] == [d.code for d in want]
            assert [d.is_error for d in got] == [d.is_error for d in want]


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 5 << 20, 3 << 30, 7 << 40])
def test_the_byte_formatter_is_the_jax_one(n):
    assert tmem.fmt_bytes(n) == jmem.fmt_bytes(n)


@pytest.mark.parametrize("kind", ["plain", "spec"])
@pytest.mark.parametrize("kv_pages,page_tokens", [(None, None), (64, 16),
                                                   (4000, 32)])
def test_generative_memory_bytes_equals_jax(artifacts, kind, kv_pages,
                                            page_tokens):
    d = artifacts[kind]
    got = tinf.generative_memory_bytes(d, kv_pages=kv_pages,
                                       page_tokens=page_tokens)
    assert got == jinf.generative_memory_bytes(
        d, kv_pages=kv_pages, page_tokens=page_tokens)
    assert got > 0


@pytest.mark.parametrize("kind", ["plain", "spec"])
@pytest.mark.parametrize("fit", ["tight", "loose"])
def test_validator_problems_equal_jax(artifacts, kind, fit):
    d = artifacts[kind]
    need = tinf.generative_memory_bytes(d, kv_pages=256, page_tokens=16)
    budget = need - 1 if fit == "tight" else need
    got = tinf.validate_generative_artifact(d, kv_pages=256, page_tokens=16,
                                            budget_bytes=budget)
    want = jinf.validate_generative_artifact(d, kv_pages=256,
                                             page_tokens=16,
                                             budget_bytes=budget)
    assert got == want
    assert len(got) == (1 if fit == "tight" else 0)
    if got:
        assert got[0].startswith("PT034 error: KV page pool needs ")
    # check_pool=False is the integrity contract alone
    assert tinf.validate_generative_artifact(
        d, kv_pages=256, page_tokens=16, budget_bytes=budget,
        check_pool=False) == []


def test_the_flag_budget_is_read_as_the_jax_package_reads_it(artifacts,
                                                             _budget_flag):
    d = artifacts["spec"]
    FLAGS.memory_budget_gb = 0.0001
    with flags_guard(memory_budget_gb=0.0001):
        want = jinf.validate_generative_artifact(d, kv_pages=512)
    got = tinf.validate_generative_artifact(d, kv_pages=512)
    assert got == want and len(got) == 1


def test_without_a_budget_the_check_is_silent_on_the_cpu(artifacts,
                                                         _budget_flag):
    assert not torch.cuda.is_available()
    FLAGS.memory_budget_gb = 0.0
    assert tmem.card() is None
    assert tmem.resolve_budget_bytes() is None
    assert tmem.resolve_budget_bytes(device="cpu") is None
    for d in artifacts.values():
        assert tinf.validate_generative_artifact(d, kv_pages=10 ** 9) == []


def test_the_budget_resolution_order(_budget_flag):
    FLAGS.memory_budget_gb = 2.0
    assert tmem.resolve_budget_bytes(0.5, device="cpu") == 1 << 29
    assert tmem.resolve_budget_bytes(device="cpu") == 2 << 30
    FLAGS.memory_budget_gb = 0.0
    assert tmem.resolve_budget_bytes(device="cpu") is None


def test_serve_exits_one_with_the_pt034_problem(artifacts, _budget_flag,
                                                capsys):
    from paddle_tpu_torch.cli import main
    d = artifacts["plain"]
    FLAGS.memory_budget_gb = 0.001
    assert main(["serve", d, "--device", "cpu", "--kv_pages", "4096"]) == 1
    err = capsys.readouterr().err
    assert "cannot serve artifact" in err and "PT034 error" in err


def test_serve_refuses_a_target_and_draft_that_fit_only_alone(
        artifacts, _budget_flag, capsys):
    from paddle_tpu_torch.cli import main
    target = artifacts["plain"]
    draft = artifacts["spec"] + "/" + tinf.DRAFT_SUBDIR
    kw = dict(kv_pages=8, page_tokens=16)
    a = tinf.generative_memory_bytes(target, **kw)
    b = tinf.generative_memory_bytes(draft, **kw)
    FLAGS.memory_budget_gb = (max(a, b) + 1) / float(1 << 30)
    assert main(["serve", target, "--device", "cpu", "--kv_pages", "8",
                 "--page_tokens", "16", "--draft_dir", draft]) == 1
    err = capsys.readouterr().err
    assert "PT034 the co-hosted generative models need" in err
