"""OpTest of the port: the twin of ``tests/op_test.py`` for
``paddle_tpu_torch``. A case declares an op type, its inputs (numpy
arrays or LoD tensors of either package), its expected outputs and its
attrs; ``check_output`` builds the one-op program in the port and holds
every output to the expected one on the CPU; ``check_grad`` holds the
gradient the port's ``calc_gradient`` appends (the op's grad maker:
its explicit grad op or the generic replay) against central finite
differences of the mean of one output, with the reference harness's
``delta`` and relative-error rule.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core import backward as tbackward
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch import layers as tlayers


def _is_lod(v):
    return hasattr(v, "lod") and hasattr(v, "numpy") and \
        not isinstance(v, np.ndarray)


def to_port(v):
    """A case's input as the port feeds it: a LoD tensor of either
    package becomes the port's, anything else a numpy array."""
    if _is_lod(v):
        return tlod.LoDTensor(np.asarray(v.numpy()), v.lod())
    return np.asarray(v)


def _array(v):
    return np.asarray(v.numpy()) if _is_lod(v) else np.asarray(v)


class OpTest(object):
    op_type = None

    def setup(self):
        """Subclasses set self.inputs, self.outputs, self.attrs."""
        raise NotImplementedError

    def _build(self):
        self.attrs = {}
        self.setup()
        prog, start = tir.Program(), tir.Program()
        with tir.program_guard(prog, start):
            block = prog.global_block()
            in_slots, self._in_vars = {}, {}
            for slot, val in self.inputs.items():
                vals = val if isinstance(val, list) else [(slot, val)]
                names = []
                for name, v in vals:
                    arr = _array(v)
                    block.create_var(
                        name=name, shape=arr.shape, dtype=str(arr.dtype),
                        lod_level=len(v.lod()) if _is_lod(v) else 0)
                    names.append(name)
                    self._in_vars[name] = v
                in_slots[slot] = names
            out_slots, self._out_names = {}, {}
            for slot, val in self.outputs.items():
                vals = val if isinstance(val, list) else [(slot, val)]
                names = []
                for name, v in vals:
                    block.create_var(name=name)
                    names.append(name)
                    self._out_names.setdefault(slot, []).append((name, v))
                out_slots[slot] = names
            block.append_op(type=self.op_type, inputs=in_slots,
                            outputs=out_slots, attrs=self.attrs)
        return prog

    def _feed(self):
        return {n: to_port(v) for n, v in self._in_vars.items()}

    def run_outputs(self):
        """(expected, got) pairs of every output, as numpy."""
        prog = self._build()
        pairs = [p for ps in self._out_names.values() for p in ps]
        outs = TExecutor("cpu").run(prog, feed=self._feed(),
                                    fetch_list=[n for n, _ in pairs],
                                    scope=TScope())
        return [(name, np.asarray(want), _array(got))
                for (name, want), got in zip(pairs, outs)]

    def check_output(self, atol=1e-5, rtol=1e-5):
        for name, want, got in self.run_outputs():
            np.testing.assert_allclose(
                got, want, atol=atol, rtol=rtol,
                err_msg="output %s of %s" % (name, self.op_type))

    def check_grad(self, inputs_to_check, output_name, delta=5e-3,
                   max_relative_error=5e-3):
        """The appended gradient against central finite differences of
        mean(``output_name``), each input element moved by +-delta in
        float64 and fed in float32; the error of an element is relative
        to the larger magnitude of the two, or absolute below 1e-3."""
        prog = self._build()
        with tir.program_guard(prog):
            block = prog.global_block()
            loss = tlayers.mean(block.var(output_name))
            grads = tbackward.calc_gradient(
                loss, [block.var(n) for n in inputs_to_check])
        exe = TExecutor("cpu")
        analytic = exe.run(prog, feed=self._feed(),
                           fetch_list=[g.name for g in grads],
                           scope=TScope())
        for name, g in zip(inputs_to_check, analytic):
            base = self._in_vars[name]
            arr = _array(base).astype(np.float64)
            numeric = np.zeros_like(arr)
            flat, num_flat = arr.reshape(-1), numeric.reshape(-1)
            for i in range(flat.size):
                vals = []
                for sign in (+1, -1):
                    pert = flat.copy()
                    pert[i] += sign * delta
                    pv = pert.reshape(arr.shape).astype(np.float32)
                    feed = self._feed()
                    feed[name] = (tlod.LoDTensor(pv, base.lod())
                                  if _is_lod(base) else pv)
                    val, = exe.run(prog, feed=feed, fetch_list=[loss.name],
                                   scope=TScope(), use_jit=False)
                    vals.append(float(np.asarray(val).reshape(-1)[0]))
                num_flat[i] = (vals[0] - vals[1]) / (2 * delta)
            ga = _array(g).astype(np.float64)
            denom = np.maximum(np.abs(numeric), np.abs(ga))
            denom[denom < 1e-3] = 1.0
            rel = np.abs(ga - numeric) / denom
            assert rel.max() <= max_relative_error, (
                "grad of %s wrt %s: max rel err %.4g > %.4g"
                % (self.op_type, name, rel.max(), max_relative_error))
