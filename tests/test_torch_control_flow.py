"""The control flow slice of the port against the JAX package, on the CPU.

- Twins of the 11 non-CSP tests of ``tests/test_control_flow.py``:
  each program is built alike in both packages (``torch_optim.build``),
  run in the JAX package as its test runs it, and in the port on the
  compiled path and on the per-op path. Values within 1e-5 of
  max(1, |the JAX value|) (``TOL``), ids and offsets equal, and the path
  each run took (``exe.stats``: jit, eager and hybrid runs) equal to the
  JAX Executor's. Where a program has parameters, the port starts from
  the JAX startup's values.
- The 29 layer callables of ``layers/control_flow.py`` build the same
  programs as the JAX package's, every block of them.
- The host value of a concrete scalar: in a hybrid segment's key; a
  tensor array read by a device op takes the program per-op, as the JAX
  package's ``_HybridNotTraceable`` does; never in the scope or in a
  compiled step's state; a parameter read only in a While body is state.
- A forward-only program keeps no snapshot of a While.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.core import lod as jlod  # noqa: E402
from paddle_tpu_torch.core import lod as tlod  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.executor import LoDValue  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.core.scope import scope_from_numpy  # noqa: E402
from torch_optim import JAX, PKGS, PORT, build, jax_startup_state  # noqa: E402

TOL = 1e-5
PATH_KEYS = ("jit_runs", "eager_runs", "hybrid_runs")
LOD = {JAX.name: jlod, PORT.name: tlod}
FLOAT0 = "float0"


def _host(v):
    """(array, LoD or None) of a fetched value of either package. The JAX
    package's generic grad of a LoD input carries its offsets as float0
    cotangents (no values): that LoD reads as ``FLOAT0`` and is not
    compared."""
    if hasattr(v, "lod") and callable(v.lod):
        lod = v.lod()
        if any(getattr(np.asarray(l), "dtype", None) is not None
               and np.asarray(l).dtype.kind == "V" for l in lod):
            return np.asarray(v.numpy()), FLOAT0
        return np.asarray(v.numpy()), [list(map(int, l)) for l in lod]
    return np.asarray(v), None


def _paths(exe, before=None):
    return {k: exe.stats[k] - (before or {}).get(k, 0) for k in PATH_KEYS}


def run_jax(main, start, feeds, fetch, use_jit=True, state=None,
            scope_vars=None):
    """Each feed's fetches ((array, LoD) each), the runs' paths, the
    scope: the JAX package as its tests run it."""
    scope, exe = jpt.Scope(), jpt.Executor(jpt.CPUPlace())
    with jpt.scope_guard(scope):
        exe.run(start)
        for n, v in dict(state or {}, **(scope_vars or {})).items():
            scope.set_var(n, v)
        before = dict(exe.stats)
        outs = [[_host(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                           use_jit=use_jit)]
                for f in feeds]
    return outs, _paths(exe, before), scope


def run_port(main, start, feeds, fetch, use_jit=True, state=None,
             scope_vars=None):
    """The same in the port on the CPU."""
    scope, exe = TScope(), TExecutor("cpu")
    exe.run(start, scope=scope)
    scope_from_numpy(state or {}, device="cpu", scope=scope)
    for n, v in (scope_vars or {}).items():
        scope.set_var(n, v)
    before = dict(exe.stats)
    outs = [[_host(o) for o in exe.run(main, feed=f, fetch_list=fetch,
                                       scope=scope, use_jit=use_jit)]
            for f in feeds]
    return outs, _paths(exe, before), scope


def assert_same(got, want, label=""):
    for i, (g_run, w_run) in enumerate(zip(got, want)):
        for j, ((g, gl), (w, wl)) in enumerate(zip(g_run, w_run)):
            where = "%s run %d fetch %d" % (label, i, j)
            assert gl == wl or wl == FLOAT0, where
            assert g.shape == w.shape, (where, g.shape, w.shape)
            if np.issubdtype(w.dtype, np.floating):
                err = np.abs(g.astype(np.float64) - w).max() if w.size else 0
                assert err <= TOL * max(1.0, float(np.abs(w).max())
                                        if w.size else 1.0), (where, err)
            else:
                np.testing.assert_array_equal(g, w, err_msg=where)


def twin(fn, feeds_of, fetch_of=None, jax_use_jit=True, state=False,
         scope_vars=None, port_paths=("compiled", "per_op")):
    """Build ``fn`` in both packages, run it in each and compare: the
    JAX runs' fetches and paths against the port's compiled run's, and
    the per-op run's fetches. Returns the port's compiled scope."""
    progs = {p.name: build(p, fn) for p in PKGS}
    fetch = {k: (fetch_of(out) if fetch_of else out)
             for k, (_, _, out) in progs.items()}
    fetch = {k: [f.name if hasattr(f, "name") else f for f in v]
             for k, v in fetch.items()}
    jmain, jstart, _ = progs["jax"]
    st = jax_startup_state(jmain, jstart) if state else None
    sv = scope_vars or {}
    want, want_paths, _ = run_jax(jmain, jstart, feeds_of(JAX), fetch["jax"],
                                  use_jit=jax_use_jit, state=st,
                                  scope_vars=sv.get("jax"))
    tmain, tstart, _ = progs["port"]
    scope = None
    for path in port_paths:
        got, paths, sc = run_port(tmain, tstart, feeds_of(PORT),
                                  fetch["port"], use_jit=path == "compiled",
                                  state=st, scope_vars=sv.get("port"))
        assert_same(got, want, path)
        if path == "compiled":
            assert paths == want_paths, (paths, want_paths)
            scope = sc
    return scope


# -- twins of tests/test_control_flow.py --------------------------------------

def _while_sum(pkg):
    L = pkg.layers
    d = [L.data("d%d" % k, shape=[10], append_batch_size=False)
         for k in range(3)]
    i = L.zeros(shape=[1], dtype="int64")
    i.stop_gradient = True
    init = L.zeros(shape=[10], dtype="float32")
    mem_array = L.array_write(x=init, i=i)
    data_array = L.array_write(x=d[0], i=i)
    i = L.increment(i)
    L.array_write(d[1], i, array=data_array)
    i = L.increment(i)
    L.array_write(d[2], i, array=data_array)
    i = L.zeros(shape=[1], dtype="int64")
    i.stop_gradient = True
    array_len = L.fill_constant(shape=[1], dtype="int64", value=3)
    array_len.stop_gradient = True
    cond = L.less_than(x=i, y=array_len)
    w = L.While(cond=cond)
    with w.block():
        di = L.array_read(array=data_array, i=i)
        prev = L.array_read(array=mem_array, i=i)
        result = L.sums(input=[di, prev])
        i = L.increment(x=i, in_place=True)
        L.array_write(result, i=i, array=mem_array)
        L.less_than(x=i, y=array_len, cond=cond)
    return [L.array_read(array=mem_array, i=i)]


def test_while_array_sum():
    rng = np.random.RandomState(0)
    feeds = [{"d%d" % k: rng.random_sample(10).astype(np.float32)
              for k in range(3)} for _ in range(3)]
    twin(_while_sum, lambda pkg: feeds)
    main, start, fetch = build(PORT, _while_sum)
    got = run_port(main, start, feeds, [fetch[0].name])[0]
    for f, run in zip(feeds, got):
        np.testing.assert_allclose(run[0][0], f["d0"] + f["d1"] + f["d2"],
                                   rtol=1e-6)


def _static_rnn(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4, 2, 3], append_batch_size=False)
    x.stop_gradient = False
    h_boot = L.data("h_boot", shape=[2, 3], append_batch_size=False)
    h_boot.stop_gradient = False
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_pre = rnn.memory(init=h_boot)
        h = L.scale(L.elementwise_add(x_t, h_pre), scale=1.0)
        rnn.update_memory(h_pre, h)
        rnn.step_output(h)
    out = rnn()
    loss = L.mean(out)
    pg = pkg.append_backward(loss, parameter_list=["x", "h_boot"])
    return [out, loss] + [g for _, g in pg]


def test_static_rnn_matches_numpy_and_trains():
    rng = np.random.RandomState(1)
    xv = rng.randn(4, 2, 3).astype(np.float32)
    hb = rng.randn(2, 3).astype(np.float32)
    twin(_static_rnn, lambda pkg: [{"x": xv, "h_boot": hb}])
    main, start, fetch = build(PORT, _static_rnn)
    (out, _, gx, gh), = [[v for v, _ in run] for run in run_port(
        main, start, [{"x": xv, "h_boot": hb}], [f.name for f in fetch])[0]]
    np.testing.assert_allclose(out, hb + np.cumsum(xv, 0), rtol=1e-5)
    n = xv.size
    for t in range(4):
        np.testing.assert_allclose(gx[t], np.full((2, 3), (4 - t) / n),
                                   rtol=1e-4)
    np.testing.assert_allclose(gh, np.full((2, 3), 4 / n), rtol=1e-4)


def _dyn_rnn_sum(pkg):
    L = pkg.layers
    x = L.data("x", shape=[2], dtype="float32", lod_level=1)
    rnn = L.DynamicRNN()
    with rnn.block():
        x_t = rnn.step_input(x)
        mem = rnn.memory(shape=[2], value=0.0)
        acc = L.elementwise_add(x_t, mem)
        rnn.update_memory(mem, acc)
        rnn.output(acc)
    out = rnn()
    return [L.sequence_last_step(out), out]


@pytest.mark.parametrize("lens", [(3, 5, 1), (3, 5, 3, 1, 5)],
                         ids=["distinct", "ties"])
def test_dynamic_rnn_ragged_eager(lens):
    """Per-sequence sums over a ragged batch; equal lengths keep their
    order in the rank table (a stable sort), so the twin of the JAX run
    holds with ties too."""
    rng = np.random.RandomState(2)
    seqs = [rng.randn(n, 2).astype(np.float32) for n in lens]
    twin(_dyn_rnn_sum,
         lambda pkg: [{"x": LOD[pkg.name].build_lod_tensor(seqs)}])
    main, start, fetch = build(PORT, _dyn_rnn_sum)
    (last, _), = run_port(main, start, [
        {"x": tlod.build_lod_tensor(seqs)}], [fetch[0].name, fetch[1].name],
        use_jit=False)[0]
    np.testing.assert_allclose(last[0], np.stack([s.sum(0) for s in seqs]),
                               rtol=1e-5)


def _dyn_rnn_train(pkg):
    L = pkg.layers
    x = L.data("x", shape=[3], dtype="float32", lod_level=1)
    c = L.data("c", shape=[4], dtype="float32")
    context = L.fc(c, size=4, act="tanh")
    rnn = L.DynamicRNN()
    with rnn.block():
        w_t = rnn.step_input(x)
        pre = rnn.memory(init=context)
        cur = L.fc([w_t, pre], size=4, act="tanh")
        rnn.update_memory(pre, cur)
        rnn.output(cur)
    last = L.sequence_last_step(rnn())
    loss = L.mean(L.reduce_sum(L.elementwise_mul(last, last), dim=1))
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss]


def test_dynamic_rnn_trains_through_while():
    """16 SGD steps through while_grad, the array conversions' grads and
    the boot's: every loss as JAX's, on the compiled path with no eager
    run (``tests/book/test_machine_translation.py:121-124``'s assertion)
    and on the per-op path; the loss falls."""
    rng = np.random.RandomState(11)
    seqs = [rng.randn(4, 3).astype(np.float32),
            rng.randn(2, 3).astype(np.float32)]
    ctx_in = rng.randn(2, 4).astype(np.float32)

    def feeds(pkg):
        return [{"x": LOD[pkg.name].build_lod_tensor(seqs), "c": ctx_in}
                for _ in range(16)]

    twin(_dyn_rnn_train, feeds, state=True)
    main, start, (loss,) = build(PORT, _dyn_rnn_train)
    st = jax_startup_state(*build(JAX, _dyn_rnn_train)[:2])
    got, paths, _ = run_port(main, start, feeds(PORT), [loss.name],
                             state=st)
    assert paths == {"jit_runs": 16, "eager_runs": 0, "hybrid_runs": 0}
    losses = [float(r[0][0].reshape(-1)[0]) for r in got]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def _ifelse_scalar(pkg):
    L = pkg.layers
    a = L.data("a", shape=[1], append_batch_size=False)
    b = L.fill_constant(shape=[1], dtype="float32", value=5.0)
    ie = L.IfElse(L.less_than(a, b))
    with ie.true_block():
        ie.output(L.scale(a, scale=2.0))
    with ie.false_block():
        ie.output(L.scale(a, scale=-1.0))
    return [ie()[0]]


def test_ifelse_scalar():
    feeds = [{"a": np.array([3.0], np.float32)},
             {"a": np.array([7.0], np.float32)}]
    twin(_ifelse_scalar, lambda pkg: feeds)
    main, start, fetch = build(PORT, _ifelse_scalar)
    got = run_port(main, start, feeds, [fetch[0].name])[0]
    assert [float(r[0][0][0]) for r in got] == [6.0, -7.0]


def _switch(pkg):
    L = pkg.layers
    x = L.data("x", shape=[1], append_batch_size=False)
    one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
    two = L.fill_constant(shape=[1], dtype="float32", value=2.0)
    out = L.create_global_var(shape=[1], value=0.0, dtype="float32",
                              persistable=True, name="switch_out")
    sw = L.Switch()
    with sw.case(L.less_than(x, one)):
        L.assign(L.fill_constant([1], "float32", 10.0), out)
    with sw.case(L.less_than(x, two)):
        L.assign(L.fill_constant([1], "float32", 20.0), out)
    with sw.default():
        L.assign(L.fill_constant([1], "float32", 30.0), out)
    return [out]


def test_switch():
    """conditional_block is a host op in a sub-block: the program runs
    per-op in both packages."""
    feeds = [{"x": np.array([v], np.float32)} for v in (0.5, 1.5, 9.0)]
    twin(_switch, lambda pkg: feeds)
    main, start, fetch = build(PORT, _switch)
    got, paths, _ = run_port(main, start, feeds, ["switch_out"])
    assert [float(r[0][0][0]) for r in got] == [10.0, 20.0, 30.0]
    assert paths == {"jit_runs": 0, "eager_runs": 3, "hybrid_runs": 0}


def _beam_step(pkg):
    L = pkg.layers
    pre_ids = L.data("pre_ids", shape=[1], dtype="int64", lod_level=2)
    ids = L.data("ids", shape=[2], dtype="int64")
    scores = L.data("scores", shape=[2], dtype="float32")
    return list(L.beam_search(pre_ids, ids, scores, beam_size=2, end_id=0))


def _beam_feeds(pkg):
    return [{"pre_ids": LOD[pkg.name].LoDTensor(
        np.array([[1], [2]], np.int64), [[0, 2], [0, 1, 2]]),
        "ids": np.array([[3, 4], [5, 6]], np.int64),
        "scores": np.array([[0.9, 0.1], [0.8, 0.2]], np.float32)}]


def test_beam_search_step():
    """One step selects the top 2 of the source; a host op outside any
    sub-block: the hybrid path in both."""
    twin(_beam_step, _beam_feeds)
    main, start, fetch = build(PORT, _beam_step)
    (ids, ids_lod), (sc, _) = run_port(main, start, _beam_feeds(PORT),
                                       [f.name for f in fetch])[0][0]
    np.testing.assert_array_equal(ids.reshape(-1), [3, 5])
    np.testing.assert_allclose(sc.reshape(-1), [0.9, 0.8])
    assert ids_lod == [[0, 2], [0, 1, 2]]


def _decode_arrays(pkg):
    """The two-step beam of ``test_beam_search_decode_backtrack`` as the
    package's (ids, scores) array values."""
    lod = [[0, 2], [0, 1, 2]]
    steps = [([[11], [12]], [[0.5], [0.4]]), ([[21], [22]], [[0.9], [0.7]])]
    if pkg is JAX:
        import jax.numpy as jnp
        from paddle_tpu.core.executor import TracedLoD
        from paddle_tpu.ops.control_flow_ops import LoDTensorArrayVal
        jl = tuple(jnp.asarray(l) for l in lod)
        return (LoDTensorArrayVal(TracedLoD(jnp.asarray(i), jl)
                                  for i, _ in steps),
                LoDTensorArrayVal(TracedLoD(jnp.asarray(v, jnp.float32), jl)
                                  for _, v in steps))
    from paddle_tpu_torch.ops.control_flow_ops import LoDTensorArrayVal
    tl = [torch.tensor(l) for l in lod]
    return (LoDTensorArrayVal(LoDValue(torch.tensor(i), tl, (2, 1))
                              for i, _ in steps),
            LoDTensorArrayVal(LoDValue(torch.tensor(v), tl, (2, 1))
                              for _, v in steps))


def _decode(pkg):
    L = pkg.layers
    ids_v = L.create_array("int64")
    sc_v = L.create_array("float32")
    ids_v.persistable = sc_v.persistable = True
    return list(L.beam_search_decode(ids_v, sc_v))


def test_beam_search_decode_backtrack():
    """The decode walks the parents back into sentences; the arrays live
    in the scope and the run is per-op (``use_jit=False``) in both."""
    got = {}
    for pkg in PKGS:
        main, start, fetch = build(pkg, _decode)
        op, = main.global_block().ops
        arrays = dict(zip(op.input("Ids") + op.input("Scores"),
                          _decode_arrays(pkg)))
        run = run_jax if pkg is JAX else run_port
        got[pkg.name] = run(main, start, [{}], [v.name for v in fetch],
                            use_jit=False, scope_vars=arrays)[:2]
    assert_same(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1]
    (ids, lod), _ = got["port"][0][0]
    np.testing.assert_array_equal(ids.reshape(-1), [11, 21, 12, 22])
    assert lod[1] == [0, 2, 4]


def _while_counter(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4], append_batch_size=False)
    i = L.zeros(shape=[1], dtype="int64")
    i.stop_gradient = True
    bound = L.fill_constant(shape=[1], dtype="int64", value=3)
    acc = L.array_write(x=x, i=i)
    cond = L.less_than(x=i, y=bound)
    w = L.While(cond=cond)
    with w.block():
        v = L.array_read(array=acc, i=i)
        i = L.increment(x=i, in_place=True)
        L.array_write(L.scale(v, scale=2.0), i=i, array=acc)
        L.less_than(x=i, y=bound, cond=cond)
    return [L.array_read(array=acc, i=i)]


def test_while_jit_path_taken():
    """A While on concrete counters unrolls into the compiled step: jit
    runs only (the CPU's stand-in for a capture at the second)."""
    feeds = [{"x": np.ones(4, np.float32)}] * 2
    twin(_while_counter, lambda pkg: feeds)
    main, start, fetch = build(PORT, _while_counter)
    got, paths, _ = run_port(main, start, feeds, [fetch[0].name])
    np.testing.assert_allclose(got[-1][0][0], 8.0 * np.ones(4), rtol=1e-6)
    assert paths == {"jit_runs": 2, "eager_runs": 0, "hybrid_runs": 0}


def _while_data_dependent(pkg):
    L = pkg.layers
    n = L.data("n", shape=[1], dtype="int64", append_batch_size=False)
    i = L.zeros(shape=[1], dtype="int64")
    i.stop_gradient = True
    total = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(x=i, y=n)
    w = L.While(cond=cond)
    with w.block():
        L.increment(x=total, value=1.0, in_place=True)
        i = L.increment(x=i, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
    return [total]


def test_while_data_dependent_falls_back_eager():
    """A condition on fed data is read back: the compiled step's warm-up
    sees the read and warns, and the program runs per-op from its first
    run, as the JAX package's trace falls back (ROADMAP Queue 3 #35)."""
    feeds = [{"n": np.asarray([5], np.int64)},
             {"n": np.asarray([3], np.int64)}]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        twin(_while_data_dependent, lambda pkg: feeds)
    assert any(issubclass(w.category, RuntimeWarning)
               and "per-op path" in str(w.message) for w in caught)
    main, start, fetch = build(PORT, _while_data_dependent)
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        got, paths, _ = run_port(main, start, feeds, [fetch[0].name])
    assert [float(r[0][0][0]) for r in got] == [5.0, 3.0]
    assert paths == {"jit_runs": 0, "eager_runs": 2, "hybrid_runs": 0}


def _counter(pkg):
    L = pkg.layers
    step = L.create_global_var(shape=[1], value=0, dtype="int64",
                               persistable=True, name="step_counter")
    L.increment(x=step, value=1.0, in_place=True)
    return [L.scale(step, scale=1.0)]


@pytest.mark.parametrize("use_jit", [True, False], ids=["compiled", "per_op"])
def test_concrete_counter_not_persisted(use_jit):
    """A persistable counter enters every step as a tensor and is written
    back as one, never as a concrete scalar, whose value a captured graph
    would freeze: it counts on across runs."""
    twin(_counter, lambda pkg: [{}] * 3)
    main, start, _ = build(PORT, _counter)
    scope, exe = TScope(), TExecutor("cpu")
    exe.run(start, scope=scope)
    assert type(scope.find_var("step_counter")) is torch.Tensor
    for k in range(1, 4):
        exe.run(main, fetch_list=[], scope=scope, use_jit=use_jit)
        v = scope.find_var("step_counter")
        assert type(v) is torch.Tensor and int(v.reshape(-1)[0]) == k


# -- the layers build the JAX package's programs ----------------------------

def blocks_of(main, lod_levels=True):
    """Every block's ops (type, slots, attrs) and vars (name, shape,
    dtype, LoD level unless ``lod_levels`` is false, type, flags)."""
    out = []
    for blk in main.blocks:
        ops = [(op.type, dict(op.inputs), dict(op.outputs),
                {k: v for k, v in op.attrs.items() if k != "snap_key"})
               for op in blk.ops]
        out.append((blk.idx, blk.parent_idx, ops, sorted(
            (v.name, None if v.shape is None else tuple(v.shape),
             None if v.dtype is None else str(v.dtype),
             v.lod_level if lod_levels else None,
             getattr(getattr(v, "type", None), "name", None), v.persistable,
             v.stop_gradient) for v in blk.vars.values())))
    return out


def _every_layer(pkg):
    """All 29 callables, each once, in one program."""
    L = pkg.layers
    x = L.data("x", shape=[3], dtype="float32", lod_level=1)
    y = L.data("y", shape=[3], dtype="float32")
    a = L.data("a", shape=[1], append_batch_size=False)
    b = L.fill_constant(shape=[1], dtype="float32", value=1.0)
    conds = [getattr(L, n)(a, b) for n in (
        "less_than", "less_equal", "greater_than", "greater_equal", "equal",
        "not_equal")]
    L.logical_or(L.logical_and(conds[0], conds[1]), conds[2])
    L.zeros_like(y)
    L.Print(y, message="y")
    table = L.lod_rank_table(x)
    arr = L.lod_tensor_to_array(x, table)
    n = L.array_length(arr)
    ml = L.max_sequence_len(table)
    i = L.zeros(shape=[1], dtype="int64")
    xt = L.array_read(arr, i)
    L.shrink_memory(xt, i, table)
    L.reorder_lod_tensor_by_rank(x, table)
    out_arr = L.create_array("float32")
    L.array_write(xt, i, array=out_arr)
    L.array_to_lod_tensor(out_arr, table)
    cond = L.less_than(i, ml)
    w = L.While(cond)
    with w.block():
        L.increment(i, in_place=True)
        L.less_than(i, n, cond=cond)
    t, f = L.split_lod_tensor(y, conds[0])
    L.merge_lod_tensor(t, f, y, conds[0])
    ie = L.IfElse(conds[0])
    with ie.true_block():
        ie.output(L.scale(ie.input(y), scale=2.0))
    with ie.false_block():
        ie.output(ie.input(y))
    ie()
    sw = L.Switch()
    with sw.case(conds[0]):
        L.assign(b, b)
    with sw.default():
        L.assign(a, a)
    srnn = L.StaticRNN()
    seq = L.data("s", shape=[4, 2, 3], append_batch_size=False)
    with srnn.step():
        st = srnn.step_input(seq)
        h = srnn.memory(shape=[3], batch_ref=st)
        nh = L.elementwise_add(st, h)
        srnn.update_memory(h, nh)
        srnn.output(nh)
    srnn()
    drnn = L.DynamicRNN()
    with drnn.block():
        s = drnn.step_input(x)
        m = drnn.memory(shape=[3])
        nm = L.elementwise_add(s, m)
        drnn.update_memory(m, nm)
        drnn.output(nm)
    drnn()
    pre = L.data("pre", shape=[1], dtype="int64", lod_level=2)
    ids = L.data("ids", shape=[2], dtype="int64")
    sc = L.data("sc", shape=[2], dtype="float32")
    si, ss = L.beam_search(pre, ids, sc, beam_size=2, end_id=0)
    ia, sa = L.create_array("int64"), L.create_array("float32")
    L.array_write(si, i, array=ia)
    L.array_write(ss, i, array=sa)
    L.beam_search_decode(ia, sa)
    return []


CALLABLES = ("While", "StaticRNN", "DynamicRNN", "IfElse", "Switch",
             "array_write", "array_read", "array_length", "create_array",
             "less_than", "less_equal", "greater_than", "greater_equal",
             "equal", "not_equal", "logical_and", "logical_or",
             "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
             "array_to_lod_tensor", "shrink_memory",
             "reorder_lod_tensor_by_rank", "beam_search",
             "beam_search_decode", "zeros_like", "split_lod_tensor",
             "merge_lod_tensor", "Print")


def test_the_29_callables_build_the_jax_programs():
    from paddle_tpu_torch.layers import control_flow
    assert len(CALLABLES) == 29
    assert sorted(control_flow.__all__) == sorted(CALLABLES)
    for n in CALLABLES:
        assert callable(getattr(PORT.layers, n)), n
    progs = {p.name: blocks_of(build(p, _every_layer)[0]) for p in PKGS}
    assert progs["port"] == progs["jax"]
    for fn in (_dyn_rnn_train, _static_rnn, _while_sum, _switch):
        progs = {p.name: blocks_of(build(p, fn)[0]) for p in PKGS}
        assert progs["port"] == progs["jax"], fn.__name__


def test_comparison_operators_go_through_the_layers():
    """``a < b`` on Variables builds what the JAX package's operator
    builds: the comparison op with ``axis`` -1, a bool output."""
    def fn(pkg):
        L = pkg.layers
        a = L.data("a", shape=[2, 3], append_batch_size=False)
        b = L.data("b", shape=[2, 3], append_batch_size=False)
        return [a < b, a >= b, a > 0.5]
    progs = {p.name: blocks_of(build(p, fn)[0]) for p in PKGS}
    assert progs["port"] == progs["jax"]
    rng = np.random.RandomState(3)
    feed = {"a": rng.randn(2, 3).astype(np.float32),
            "b": rng.randn(2, 3).astype(np.float32)}
    feed["a"][0, 0] = 2.0
    twin(fn, lambda pkg: [feed])


# -- the host value of a concrete scalar -------------------------------------

def _host_range(L):
    """A ``range`` op, a host op in both packages: the segments' edge."""
    from importlib import import_module
    helper = import_module(L.__name__ + ".layer_helper").LayerHelper("rg")
    bounds = [L.fill_constant([1], "float32", v) for v in (1.0, 7.0, 2.0)]
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="range", inputs={
        "Start": [bounds[0]], "End": [bounds[1]], "Step": [bounds[2]]},
        outputs={"Out": [out]})
    return out


def _hybrid_array(pkg):
    """A tensor array made before a host op and read by a device op after
    it."""
    L = pkg.layers
    x = L.data("x", shape=[4], append_batch_size=False)
    i = L.fill_constant(shape=[1], dtype="int64", value=1)
    arr = L.array_write(x=x, i=i)
    _host_range(L)
    return [L.scale(L.array_read(arr, i), scale=2.0)]


def test_hybrid_refuses_a_tensor_array():
    """A captured segment can hold no array: the program leaves the
    hybrid path (a RuntimeWarning) and runs per-op from then on, as the
    JAX package's does (``_HybridNotTraceable``), the same runs counted."""
    feeds = [{"x": np.arange(4, dtype=np.float32)}] * 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        twin(_hybrid_array, lambda pkg: feeds)
    main, start, fetch = build(PORT, _hybrid_array)
    with pytest.warns(RuntimeWarning, match="left the hybrid path"):
        got, paths, _ = run_port(main, start, feeds, [fetch[0].name])
    np.testing.assert_allclose(got[1][0][0], np.arange(4) * 2.0)
    assert paths == {"jit_runs": 0, "eager_runs": 1, "hybrid_runs": 1}


def _hybrid_concrete(pkg):
    """``max_sequence_len`` of a LoD feed, made before a host op, indexes
    an array after it: the second segment's output depends on the host
    value it reads."""
    L = pkg.layers
    x = L.data("x", shape=[1], dtype="float32", lod_level=1)
    y = L.data("y", shape=[2], append_batch_size=False)
    ml = L.max_sequence_len(L.lod_rank_table(x))
    _host_range(L)
    arr = L.array_write(x=y, i=ml)
    return [L.array_length(arr)]


def test_hybrid_segment_key_holds_the_concrete_value():
    """Two feeds of other longest sequences: the segment after the host
    op reads the concrete ``max_sequence_len``, whose value is in its key
    (``paddle_tpu/core/executor.py:1020``), so each gets its own length."""
    def feeds(pkg):
        return [{"x": LOD[pkg.name].build_lod_tensor(
            [np.ones((n, 1), np.float32), np.ones((2, 1), np.float32)]),
            "y": np.ones(2, np.float32)} for n in (3, 5, 3)]
    twin(_hybrid_concrete, feeds)
    main, start, fetch = build(PORT, _hybrid_concrete)
    got, paths, _ = run_port(main, start, feeds(PORT), [fetch[0].name])
    assert [int(r[0][0][0]) for r in got] == [4, 6, 4]
    assert paths == {"jit_runs": 0, "eager_runs": 0, "hybrid_runs": 3}


def _while_param(pkg):
    L = pkg.layers
    x = L.data("x", shape=[3], dtype="float32", lod_level=1)
    c = L.data("c", shape=[3], dtype="float32")
    rnn = L.DynamicRNN()
    with rnn.block():
        w_t = rnn.step_input(x)
        pre = rnn.memory(init=c)
        cur = L.fc([w_t, pre], size=3, act="tanh",
                   param_attr=[pkg.ParamAttr(name="body_wx"),
                               pkg.ParamAttr(name="body_wh")],
                   bias_attr=pkg.ParamAttr(name="body_b"))
        rnn.update_memory(pre, cur)
        rnn.output(cur)
    loss = L.mean(L.sequence_pool(rnn(), "sum"))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def _while_param_grads(state, seqs, c):
    """The float64 gradients of ``_while_param``'s body weights, by hand:
    each sequence from its row of c, h = tanh(x Wx + h Wh + b), the loss
    the mean of the per-sequence sums of h."""
    w = {n: torch.tensor(state[n], dtype=torch.float64, requires_grad=True)
         for n in ("body_wx", "body_wh", "body_b")}
    pooled = []
    for s, sq in enumerate(seqs):
        h, acc = torch.tensor(c[s], dtype=torch.float64), 0.0
        for x_t in torch.tensor(sq, dtype=torch.float64):
            h = torch.tanh(x_t @ w["body_wx"] + h @ w["body_wh"]
                           + w["body_b"])
            acc = acc + h
        pooled.append(acc)
    torch.stack(pooled).mean().backward()
    return {n: v.grad.numpy() for n, v in w.items()}


WHILE_PARAM_FEED = ((2, 4, 4), 4)  # lengths (a tie), seed


def _while_param_case():
    lens, seed = WHILE_PARAM_FEED
    rng = np.random.RandomState(seed)
    seqs = [rng.randn(n, 3).astype(np.float32) for n in lens]
    c = rng.randn(3, 3).astype(np.float32)
    st = jax_startup_state(*build(JAX, _while_param)[:2])
    return seqs, c, st, _while_param_grads(st, seqs, c)


GRADS = ["body_wx@GRAD", "body_wh@GRAD", "body_b@GRAD"]


@pytest.mark.parametrize("use_jit", [True, False], ids=["compiled", "per_op"])
def test_a_parameter_read_only_in_a_while_body_is_state(use_jit):
    """The fc's weights live only in the body: the compiled step takes
    them as state (the program's facts look into the sub-block), their
    gradients through while_grad equal the float64 ones by hand, every
    output step's included, and the updates reach the scope."""
    from paddle_tpu_torch.core.executor import _ProgramFacts
    main, start, (loss,) = build(PORT, _while_param)
    outer = {n for op in main.global_block().ops if op.type != "while"
             and op.type != "while_grad" and not op.type.startswith("sgd")
             for n in op.input_arg_names}
    assert "body_wx" not in outer
    assert "body_wx" in _ProgramFacts(main).referenced
    seqs, c, st, want = _while_param_case()
    feed = {"x": tlod.build_lod_tensor(seqs), "c": c}
    got, paths, scope = run_port(main, start, [feed] * 2,
                                 [loss.name] + GRADS, use_jit=use_jit,
                                 state=st)
    for g, n in zip(got[0][1:], GRADS):
        np.testing.assert_allclose(g[0].reshape(want[n[:-5]].shape),
                                   want[n[:-5]], rtol=0, atol=1e-6)
    assert not np.allclose(np.asarray(scope.find_var("body_wx")),
                           st["body_wx"])
    if use_jit:
        assert paths == {"jit_runs": 2, "eager_runs": 0, "hybrid_runs": 0}


def test_jax_while_grad_drops_the_first_write_pin():
    """ROADMAP Queue 3 #36, the pin: the JAX package's while_grad leaves
    the output array out of the first iteration's vjp (it is not in that
    iteration's snapshot), so its body-weight gradients miss the first
    step's output; with that one line corrected
    (``torch_book.jax_while_grad_first_write``) they equal the float64
    ones by hand and the port's."""
    import torch_book
    seqs, c, st, want = _while_param_case()
    feed = [{"x": jlod.build_lod_tensor(seqs), "c": c}]
    errs = {}
    for fixed in (False, True):
        main, start, _ = build(JAX, _while_param)
        with (torch_book.jax_while_grad_first_write() if fixed
              else warnings.catch_warnings()):
            got, _, _ = run_jax(main, start, feed, GRADS, state=st)
        errs[fixed] = max(float(np.abs(g[0].reshape(want[n[:-5]].shape)
                                       - want[n[:-5]]).max())
                          for g, n in zip(got[0], GRADS))
    assert errs[False] > 1e-2 and errs[True] < 1e-6, errs


def _dyn_rnn_forward(pkg):
    L = pkg.layers
    x = L.data("x", shape=[3], dtype="float32", lod_level=1)
    rnn = L.DynamicRNN()
    with rnn.block():
        w_t = rnn.step_input(x)
        pre = rnn.memory(shape=[3])
        cur = L.elementwise_add(w_t, pre)
        rnn.update_memory(pre, cur)
        rnn.output(cur)
    return [L.sequence_last_step(rnn())]


def test_a_forward_only_program_keeps_no_snapshot():
    """The snapshots a While takes for its while_grad: one an iteration
    (and one a replay in while_grad) in the training program, none in a
    forward-only one."""
    from paddle_tpu_torch.ops import control_flow_ops as cfo
    rng = np.random.RandomState(5)
    seqs = [rng.randn(3, 3).astype(np.float32)]
    taken, real = [], cfo._snap_env

    def snap(env):
        taken.append(1)
        return real(env)
    cfo._snap_env = snap
    try:
        for fn, feed, want in (
                (_dyn_rnn_forward, {"x": tlod.build_lod_tensor(seqs)}, 0),
                (_dyn_rnn_train, {"x": tlod.build_lod_tensor(seqs),
                                  "c": rng.randn(1, 4).astype(np.float32)},
                 6)):
            main, start, fetch = build(PORT, fn)
            del taken[:]
            run_port(main, start, [feed], [fetch[0].name], use_jit=False)
            assert len(taken) == want, (fn.__name__, len(taken))
    finally:
        cfo._snap_env = real


def test_verify_and_the_memory_preflight_run_on_a_while():
    """Under ``FLAGS.verify`` a DynamicRNN's training step verifies as
    the JAX package's does (one RuntimeWarning, the PT006 of the
    condition the block writes after a read, the same text) and its
    memory preflight prices the While's body: the predicted peak is the
    planner's plan of the step at the feeds' sizes."""
    from paddle_tpu.flags import flags_guard as jflags_guard
    from paddle_tpu_torch.analysis import memory as tmem
    from paddle_tpu_torch.flags import flags_guard
    rng = np.random.RandomState(11)
    seqs = [rng.randn(4, 3).astype(np.float32),
            rng.randn(2, 3).astype(np.float32)]
    c = rng.randn(2, 4).astype(np.float32)
    texts = {}
    for pkg, guard in ((JAX, jflags_guard), (PORT, flags_guard)):
        main, start, (loss,) = build(pkg, _dyn_rnn_train)
        feed = [{"x": LOD[pkg.name].build_lod_tensor(seqs), "c": c}]
        with guard(verify=True), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            run = run_jax if pkg is JAX else run_port
            run(main, start, feed, [loss.name])
        texts[pkg.name] = [str(m.message).split("\n", 1)[1] for m in w
                           if "verification warnings" in str(m.message)]
    assert texts["port"] == texts["jax"] and len(texts["port"]) == 1
    assert "PT006" in texts["port"][0]
    main, start, (loss,) = build(PORT, _dyn_rnn_train)
    exe, scope = TExecutor("cpu"), TScope()
    exe.run(start, scope=scope)
    with flags_guard(verify=True), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        exe.run(main, feed={"x": tlod.build_lod_tensor(seqs), "c": c},
                fetch_list=[loss.name], scope=scope)
    sizes = {n: np.asarray(scope.find_var(n)).nbytes
             for n in exe._state_inputs(main, scope, {})}
    sizes.update(x=6 * 3 * 4, c=2 * 4 * 4)
    plan = tmem.plan_memory(main, batch=6, fetches=[loss.name],
                            sizes_override=sizes, vmem=False)
    assert exe.stats["mem_predicted_peak_bytes"] == plan.peak_bytes > 0
