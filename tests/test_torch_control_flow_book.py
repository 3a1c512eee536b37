"""The two book models of the control flow slice in the port against the
JAX package, on the CPU, at the book tests' widths
(``tests/torch_book.py``'s ``CF_KINDS``):

- each training program builds alike in both packages, every block
  (but the LoD level the port gives an embedding's or an fc's output
  over a LoD input, where the JAX package leaves 0);
- 3 Adagrad steps from the JAX startup's state on the first batches of
  the JAX package's synthetic wmt14: every loss within 1e-5 relative
  (``torch_book.REL_TOL``) and every persistable within 1e-4 of max(1,
  the largest magnitude) (``torch_book.CF_STATE_TOL``, Adagrad's), on
  the port's compiled path (the DynamicRNN step captured: jit runs
  only, as ``tests/book/test_machine_translation.py:121-124`` asserts
  of the JAX package) and on its per-op path. The
  JAX side runs with its ``while_grad`` corrected
  (``torch_book.jax_while_grad_first_write``, ROADMAP Queue 3 #36):
  uncorrected it drops the first output step's gradient;
- the translator's beam-search decode (beam 2, 6 steps, end id 10) from
  one state: sentence ids and LoD equal, scores within 1e-5 of max(1,
  |score|), and the runs' paths equal: a host op (``beam_search``) in a
  While body runs the program per-op in both (``chip_smoke.DECODE_PATH``,
  which phase 20 holds the card's decode to).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_book as book  # noqa: E402
from paddle_tpu.core import lod as jlod  # noqa: E402
from paddle_tpu_torch.models import machine_translation as tmt  # noqa: E402
from paddle_tpu_torch.core import lod as tlod  # noqa: E402
from test_torch_control_flow import (  # noqa: E402
    assert_same, blocks_of, run_jax, run_port)
from torch_optim import PKGS, build  # noqa: E402

STEPS = 3


@pytest.mark.parametrize("kind", book.CF_KINDS)
def test_book_program_builds_alike(kind):
    progs = {}
    for pkg in ("jax", "port"):
        main, start, _ = book.build(pkg, kind, minimize=True)
        # the port gives an embedding's and an fc's output over a LoD
        # input the input's LoD level, where the JAX package leaves 0
        progs[pkg] = (blocks_of(main, lod_levels=False), blocks_of(start))
    assert progs["port"] == progs["jax"]


@pytest.mark.parametrize("kind", book.CF_KINDS)
def test_book_trains_alike(kind):
    jmain, jstart, jspec = book.build("jax", kind)
    tmain, _, tspec = book.build("port", kind)
    state = book.jax_startup_state(jmain, jstart)
    fetch = [jspec["cost"].name]
    with book.jax_while_grad_first_write():
        want, want_final = book.jax_run(jmain, state,
                                        book.feeds(kind, "jax", STEPS), fetch)
    want_losses = [float(o[0].reshape(-1)[0]) for o in want]
    for use_jit in (True, False):
        exe_feeds = book.feeds(kind, "port", STEPS)
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.scope import Scope, scope_from_numpy
        from paddle_tpu_torch.core.scope import scope_to_numpy
        exe, scope = Executor("cpu"), Scope()
        scope_from_numpy(state, device="cpu", scope=scope)
        got = [float(np.asarray(exe.run(tmain, feed=f, fetch_list=fetch,
                                        scope=scope, use_jit=use_jit)[0])
                     .reshape(-1)[0]) for f in exe_feeds]
        assert book.loss_rel(got, want_losses) <= book.REL_TOL, (
            use_jit, got, want_losses)
        final = scope_to_numpy(scope, names=state)
        for n in state:
            assert book.rel(final[n], want_final[n]) <= book.CF_STATE_TOL, n
        runs = {k: exe.stats[k] for k in ("jit_runs", "eager_runs",
                                          "hybrid_runs")}
        if use_jit:
            assert runs == {"jit_runs": STEPS, "eager_runs": 0,
                            "hybrid_runs": 0}, runs
    assert tspec["cost"].name == jspec["cost"].name


def _decode(pkg):
    return list(tmt.nmt_decode(pkg.layers, pkg.ParamAttr))


def test_beam_search_decode_as_jax():
    """The translator's decode over the book's 2 sources from the JAX
    startup's weights: the same sentences (ids, LoD), scores and path."""
    progs = {p.name: build(p, _decode) for p in PKGS}
    assert blocks_of(progs["jax"][0], lod_levels=False) == blocks_of(
        progs["port"][0], lod_levels=False)
    state = book.jax_startup_state(*progs["jax"][:2])
    sources = [r[0] for r in book.cf_samples("machine_translation", 2)]
    fetch = {k: [v.name for v in progs[k][2]] for k in progs}
    want, want_paths, _ = run_jax(
        *progs["jax"][:2], [tmt.decode_feed(jlod, sources)] * 2,
        fetch["jax"], state=state)
    got, paths, _ = run_port(
        *progs["port"][:2], [tmt.decode_feed(tlod, sources)] * 2,
        fetch["port"], state=state)
    assert_same(got, want)
    # chip_smoke's phase 20 holds the card's decode to this path, a run
    import chip_smoke
    assert paths == want_paths == {k: 2 * v for k, v in
                                   chip_smoke.DECODE_PATH.items()}
    (ids, lod), _ = got[0]
    assert len(lod[0]) - 1 == 2 and lod[0][-1] == 2 * tmt.NMT["beam_size"]
    lens = np.diff(lod[1])
    assert ((lens >= 1) & (lens <= tmt.NMT["max_length"] + 1)).all()
