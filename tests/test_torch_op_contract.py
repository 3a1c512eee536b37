"""The JAX package's per-op contract suite run through the port: every
``CASES`` entry of ``tests/test_op_contract_suite.py`` whose op type the
port registers, its outputs against the case's numpy reference and,
where the case has ``grad``, the port's appended gradient against finite
differences, each with the case's own ``atol`` / ``rtol`` / ``grad_rel``
(``tests/torch_op_test.py``, the twin of ``tests/op_test.py``). Beside
them the port's twins of the suite's random-op property tests, of
``tests/test_op_contract_suite2.py``'s ``sampling_id`` and ``range``
tests, and of the ``shape`` case with the dtype the port gives it.

A case the port cannot pass for a deliberate difference would be left
out by name in ``EXCLUDED``, with its ROADMAP Queue 3 number; there is
none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_op_contract_suite import CASES  # noqa: E402
from torch_op_test import OpTest  # noqa: E402

import paddle_tpu_torch.ops  # noqa: E402,F401
from paddle_tpu_torch import layers as tlayers  # noqa: E402
from paddle_tpu_torch.core import ir as tir  # noqa: E402
from paddle_tpu_torch.core.executor import Executor as TExecutor  # noqa: E402
from paddle_tpu_torch.core.registry import registered_ops  # noqa: E402
from paddle_tpu_torch.core.scope import Scope as TScope  # noqa: E402
from paddle_tpu_torch.layers.layer_helper import LayerHelper  # noqa: E402

EXCLUDED = {}  # case name -> ROADMAP Queue 3 number
PORT_CASES = [c for c in CASES
              if c[1] in registered_ops() and c[0] not in EXCLUDED]
GRAD_CASES = [c for c in PORT_CASES if "grad" in c[2]]


class _Case(OpTest):
    def __init__(self, op_type, spec):
        self.op_type = op_type
        self._spec = spec

    def setup(self):
        self.inputs = self._spec["inputs"]
        self.outputs = self._spec["outputs"]
        self.attrs = dict(self._spec.get("attrs", {}))


@pytest.mark.parametrize("name,op_type,spec", PORT_CASES,
                         ids=[c[0] for c in PORT_CASES])
def test_output(name, op_type, spec):
    _Case(op_type, spec).check_output(atol=spec.get("atol", 1e-5),
                                      rtol=spec.get("rtol", 1e-5))


@pytest.mark.parametrize("name,op_type,spec", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_grad(name, op_type, spec):
    ins, out = spec["grad"]
    _Case(op_type, spec).check_grad(
        ins, out, max_relative_error=spec.get("grad_rel", 5e-3))


def test_the_sweep_covers_every_registered_case():
    """Every case whose op type the port registers runs: the op types of
    the dense slice and of the conv-net slice that the suite holds are
    among them."""
    assert len(PORT_CASES) >= 159 and len(GRAD_CASES) >= 62
    covered = {c[1] for c in PORT_CASES}
    for op in ("matmul", "concat", "split", "slice", "cos_sim", "scatter",
               "one_hot", "argsort", "rank_loss", "smooth_l1_loss",
               "prelu", "log_softmax", "maxout", "dropout",
               "depthwise_conv2d", "conv2d_transpose", "conv3d",
               "conv3d_transpose", "pool3d", "lrn", "l2_normalize",
               "auc", "precision_recall", "edit_distance"):
        assert op in covered, op


# -- random ops: properties ----------------------------------------------------

def _run_random(op_type, attrs, seed=7):
    """Two runs of a one-op program from one seed, each in a scope of
    its own."""
    main = tir.Program()
    main.random_seed = seed
    blk = main.global_block()
    blk.create_var(name="r_out", shape=None, dtype="float32")
    blk.append_op(type=op_type, inputs={}, outputs={"Out": ["r_out"]},
                  attrs=attrs)
    exe = TExecutor("cpu")
    a, = exe.run(main, fetch_list=["r_out"], scope=TScope())
    b, = exe.run(main, fetch_list=["r_out"], scope=TScope())
    return np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("op_type,attrs,check", [
    ("uniform_random", {"shape": [512, 8], "min": -2.0, "max": 3.0},
     lambda a: a.min() >= -2.0 and a.max() <= 3.0
     and abs(a.mean() - 0.5) < 0.15),
    ("gaussian_random", {"shape": [2048, 4], "mean": 1.5, "std": 0.5},
     lambda a: abs(a.mean() - 1.5) < 0.05 and abs(a.std() - 0.5) < 0.05),
    ("truncated_gaussian_random",
     {"shape": [2048, 4], "mean": 0.0, "std": 1.0},
     lambda a: np.abs(a).max() <= 2.0 + 1e-5 and abs(a.mean()) < 0.08),
], ids=["uniform_random", "gaussian_random", "truncated_gaussian_random"])
def test_random_op_properties(op_type, attrs, check):
    """The suite's property tests (``test_op_contract_suite.py:1433-
    1456``): shape, bounds and moments; a seeded rerun is equal."""
    a, b = _run_random(op_type, attrs)
    assert a.shape == tuple(attrs["shape"]) and check(a)
    np.testing.assert_array_equal(a, b)


def test_sampling_id_degenerate():
    """One-hot rows sample their hot index (``test_op_contract_suite2.py
    :604``)."""
    probs = np.zeros((4, 5), np.float32)
    probs[:, 3] = 1.0
    main, start = tir.Program(), tir.Program()
    with tir.program_guard(main, start):
        x = tlayers.data("x", shape=[5], dtype="float32")
        helper = LayerHelper("sid")
        out = helper.create_variable_for_type_inference("int64")
        helper.append_op(type="sampling_id", inputs={"X": [x]},
                         outputs={"Out": [out]})
    got, = TExecutor("cpu").run(main, feed={"x": probs}, fetch_list=[out],
                                scope=TScope())
    assert got.dtype == np.int64 and (got == 3).all()


def test_range_op():
    """``range`` of float bounds 1, 7, 2 then a scale
    (``test_op_contract_suite2.py:747``): a host op, so the program runs
    on the hybrid path."""
    main, start = tir.Program(), tir.Program()
    with tir.program_guard(main, start):
        helper = LayerHelper("rg")
        bounds = [tlayers.fill_constant([1], "float32", v)
                  for v in (1.0, 7.0, 2.0)]
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="range",
                         inputs={"Start": [bounds[0]], "End": [bounds[1]],
                                 "Step": [bounds[2]]},
                         outputs={"Out": [out]})
        y = tlayers.scale(out, scale=1.0)
    exe = TExecutor("cpu")
    got, raw = exe.run(main, fetch_list=[y, out], scope=TScope())
    np.testing.assert_allclose(got, [1.0, 3.0, 5.0])
    assert raw.dtype == np.int64 and raw.tolist() == [1, 3, 5]
    assert exe.stats["hybrid_runs"] == 1


def test_shape_case_is_int64():
    """The suite's ``shape`` case (``test_op_contract_suite.py:645``),
    with the int64 the port gives it (ROADMAP Queue 3 #26)."""
    spec = next(c[2] for c in CASES if c[0] == "shape")
    (name, want, got), = _Case("shape", spec).run_outputs()
    assert got.dtype == np.int64 and got.tolist() == want.tolist()
