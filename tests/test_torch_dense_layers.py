"""The layer functions of the dense slice against the JAX package's: each
builds, through each package's layers DSL under its name guard, a
program whose ops have the same types, inputs, outputs and attrs, and
whose variables the same names, shapes, dtypes, LoD levels and flags
(``create_tensor``, ``create_parameter``, ``create_global_var``,
``concat``, ``ones``, ``zeros``, ``argmax``, ``argmin``, ``reverse``;
``smooth_l1``, ``sigmoid_cross_entropy_with_logits``, ``matmul``,
``mul``, ``dot``, ``slice``, ``cos_sim``, ``one_hot``, ``pad``,
``label_smooth``, ``transpose``, ``split``, ``expand``, ``squeeze``,
``unsqueeze``; ``scatter``, ``uniform_random``, ``gaussian_random``,
``isfinite``). A few run in both on the same feeds, their outputs within
1e-6 of max(1, |the JAX value|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_optim import (JAX, OP_TOL, PKGS, PORT, build, jax_run,  # noqa: E402
                         port_run, rel)


def _data(L, name, shape, dtype="float32", lod_level=0):
    return L.data(name=name, shape=shape, dtype=dtype,
                  append_batch_size=False, lod_level=lod_level)


def _x(L):
    return _data(L, "x", [4, 6])


BUILDERS = {
    "create_tensor": lambda L: L.create_tensor("float32", name="t0"),
    "create_parameter": lambda L: L.create_parameter(
        [3, 5], "float32", name="cp_w"),
    "create_parameter_bias": lambda L: L.create_parameter(
        [5], "float32", is_bias=True),
    "create_global_var": lambda L: L.create_global_var(
        [2, 2], 0.5, "float32", persistable=True, name="gv"),
    "concat": lambda L: L.concat([_x(L), _data(L, "y", [4, 2])], axis=1),
    "concat_nn": lambda L: L.concat_nn([_x(L), _data(L, "y", [4, 2])],
                                       axis=1),
    "concat_lod": lambda L: L.concat(
        [_data(L, "a", [5, 3], lod_level=1),
         _data(L, "b", [5, 2], lod_level=1)], axis=1),
    "ones": lambda L: L.ones([2, 3], "float32"),
    "zeros": lambda L: L.zeros([4], "int64"),
    "argmax": lambda L: L.argmax(_x(L), axis=1),
    "argmin": lambda L: L.argmin(_x(L)),
    "reverse": lambda L: L.reverse(_x(L), axis=1),
    "reverse_list": lambda L: L.reverse(_x(L), axis=[0, 1]),
    "smooth_l1": lambda L: L.smooth_l1(_x(L), _data(L, "y", [4, 6])),
    "smooth_l1_weights": lambda L: L.smooth_l1(
        _x(L), _data(L, "y", [4, 6]), inside_weight=_data(L, "iw", [4, 6]),
        outside_weight=_data(L, "ow", [4, 6]), sigma=3.0),
    "sigmoid_ce": lambda L: L.sigmoid_cross_entropy_with_logits(
        _x(L), _data(L, "y", [4, 6])),
    "matmul": lambda L: L.matmul(_data(L, "q", [2, 3, 4, 8]),
                                 _data(L, "k", [2, 3, 5, 8]),
                                 transpose_y=True, alpha=0.125),
    "matmul_vec": lambda L: L.matmul(_data(L, "v", [6]), _x(L),
                                     transpose_x=False, transpose_y=True),
    "mul": lambda L: L.mul(_data(L, "m", [2, 3, 4]), _data(L, "n", [12, 5]),
                           x_num_col_dims=1),
    "dot": lambda L: L.dot(_x(L), _data(L, "y", [4, 6])),
    "slice": lambda L: L.slice(_x(L), axes=[0, 1], starts=[1, -4],
                               ends=[10, -1]),
    "cos_sim": lambda L: L.cos_sim(_x(L), _data(L, "y", [4, 6])),
    "one_hot": lambda L: L.one_hot(_data(L, "ids", [4, 1], "int64"), 7),
    "pad": lambda L: L.pad(_x(L), [1, 0, 0, 2], pad_value=-1.0),
    "label_smooth": lambda L: L.label_smooth(_x(L), epsilon=0.2),
    "label_smooth_prior": lambda L: L.label_smooth(
        _x(L), prior_dist=_data(L, "p", [1, 6])),
    "transpose": lambda L: L.transpose(_x(L), [1, 0]),
    "split_num": lambda L: L.split(_x(L), 3, dim=-1),
    "split_sections": lambda L: L.split(_x(L), [1, 3], dim=0),
    "expand": lambda L: L.expand(_x(L), [2, 1]),
    "squeeze": lambda L: L.squeeze(_data(L, "s", [4, 1, 6]), [1]),
    "unsqueeze": lambda L: L.unsqueeze(_x(L), [0, 3]),
    "scatter": lambda L: L.scatter(_x(L), _data(L, "i", [2], "int64"),
                                   _data(L, "u", [2, 6])),
    "uniform_random": lambda L: L.uniform_random([3, 4], min=-0.5, max=2.0),
    "gaussian_random": lambda L: L.gaussian_random([5], mean=1.0, std=0.1),
    "isfinite": lambda L: L.isfinite(_x(L)),
}


def _program_of(main, start):
    """Everything the two programs must share, by block."""
    out = []
    for prog in (main, start):
        blk = prog.global_block()
        out.append((
            [(op.type, dict(op.inputs), dict(op.outputs), dict(op.attrs))
             for op in blk.ops],
            sorted((v.name, None if v.shape is None else tuple(v.shape),
                    None if v.dtype is None else str(v.dtype),
                    v.lod_level, v.persistable, v.stop_gradient)
                   for v in blk.vars.values())))
    return out


def _attrs_plain(prog):
    """Attrs compared as plain values (numpy scalars and arrays as
    lists)."""
    for ops, _ in prog:
        for _, _, _, attrs in ops:
            for k, v in attrs.items():
                if isinstance(v, np.ndarray):
                    attrs[k] = v.tolist()
    return prog


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layer_function_builds_the_jax_program(name):
    progs = {}
    for pkg in PKGS:
        main, start, _ = build(pkg, lambda p: BUILDERS[name](p.layers))
        progs[pkg.name] = _attrs_plain(_program_of(main, start))
    assert progs["port"] == progs["jax"]


def test_every_layer_function_of_the_slice_is_exported():
    """The names ROADMAP lists for item 4b, in the port's layers
    namespace as in JAX's."""
    for name in ("concat", "split", "slice", "transpose", "squeeze",
                 "unsqueeze", "expand", "pad", "one_hot", "argmax",
                 "argmin", "reverse", "scatter", "matmul", "mul", "dot",
                 "cos_sim", "label_smooth", "smooth_l1",
                 "sigmoid_cross_entropy_with_logits", "uniform_random",
                 "gaussian_random", "zeros", "ones", "create_tensor",
                 "create_parameter", "create_global_var", "isfinite"):
        assert callable(getattr(PORT.layers, name)), name
        assert callable(getattr(JAX.layers, name)), name


RUNS = ["smooth_l1_weights", "dot", "label_smooth_prior", "cos_sim",
        "split_sections", "slice", "pad", "matmul"]


@pytest.mark.parametrize("name", RUNS)
def test_layer_function_computes_what_jax_computes(name):
    rng = np.random.RandomState(len(name))
    got = {}
    for pkg in PKGS:
        main, _, out = build(pkg, lambda p: BUILDERS[name](p.layers))
        outs = out if isinstance(out, list) else [out]
        if pkg is JAX:
            blk = main.global_block()
            made = {n for op in blk.ops for n in op.output_arg_names}
            feed = {n: rng.randn(*blk.var(n).shape).astype(np.float32)
                    for op in blk.ops for n in op.input_arg_names
                    if n not in made}
        run = jax_run if pkg is JAX else port_run
        got[pkg.name] = run(main, {}, [feed], [o.name for o in outs])[0][0]
    for j, t in zip(got["jax"], got["port"]):
        assert t.shape == j.shape and rel(t, j) <= OP_TOL
