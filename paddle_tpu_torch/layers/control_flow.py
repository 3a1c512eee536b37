"""The control flow layers (copy of ``paddle_tpu/layers/control_flow.py``):
While, StaticRNN, DynamicRNN, IfElse, Switch, the LoDTensorArray and
rank-table layers, the comparisons, beam search, Print.

A While's body reads and writes are declared on the op, so that
``append_backward`` reaches what the body reads and ``while_grad``
trains through the loop; its counters are concrete scalars, so the
loop unrolls into a compiled step (``ops/control_flow_ops.py``). The
same program builds in both packages, name for name.
"""
from __future__ import annotations

import contextlib

from ..core.types import VarType
from .layer_helper import LayerHelper

__all__ = [
    "While", "StaticRNN", "DynamicRNN", "IfElse", "Switch", "array_write",
    "array_read", "array_length", "create_array", "less_than", "less_equal",
    "greater_than", "greater_equal", "equal", "not_equal", "logical_and",
    "logical_or", "lod_rank_table", "max_sequence_len", "lod_tensor_to_array",
    "array_to_lod_tensor", "shrink_memory", "reorder_lod_tensor_by_rank",
    "beam_search", "beam_search_decode", "zeros_like",
    "split_lod_tensor", "merge_lod_tensor", "Print",
]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Print the tensor whenever it is accessed (a host op: a program
    holding one runs its device ops compiled between the prints).
    ``first_n`` caps how many times this op prints;
    ``summarize`` caps the printed element count.
    reference: layers/control_flow.py:149 Print -> operators/print_op.cc.
    ``print_phase='backward'`` is fully silent: the reference prints
    only gradients in that phase and this op is no-gradient here, so
    the faithful behavior is to emit nothing (not to print the forward
    tensor)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    out.lod_level = getattr(input, "lod_level", 0)
    helper.append_op(
        type="print", inputs={"In": [input]},
        outputs={"Out": [out]},
        attrs={"first_n": first_n, "summarize": summarize,
               "message": message or "",
               "print_tensor_name": print_tensor_name,
               "print_tensor_type": print_tensor_type,
               "print_tensor_shape": print_tensor_shape,
               "print_tensor_lod": print_tensor_lod,
               "print_phase": str(print_phase).upper()})
    return out


# -- compare / logical -------------------------------------------------------

def _cmp(op_type, x, y, cond=None, helper=None, attrs=None):
    """Append ``op_type(x, y)``; ``math_op_patch`` passes its helper and
    the ``axis`` attr, so that a comparison by operator builds the same
    program as in the JAX package."""
    if helper is None:
        helper = LayerHelper(op_type, **{"x": x, "y": y})
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
        cond.stop_gradient = True
    cond.shape = x.shape
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]}, attrs=attrs)
    return cond


def less_than(x, y, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp("not_equal", x, y, cond)


def logical_and(x, y, out=None):
    return _cmp("logical_and", x, y, out)


def logical_or(x, y, out=None):
    return _cmp("logical_or", x, y, out)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like", **locals())
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


# -- LoDTensorArray ----------------------------------------------------------

def create_array(dtype):
    helper = LayerHelper("array", **{"dtype": dtype})
    return helper.main_block.create_var(
        name="{0}.out".format(helper.name), dtype=dtype,
        type=VarType.LOD_TENSOR_ARRAY)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write", **locals())
    if array is None:
        array = helper.main_block.create_var(
            name="{0}.out".format(helper.name), dtype=x.dtype,
            type=VarType.LOD_TENSOR_ARRAY)
    if array.shape is None:
        array.shape = x.shape
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]},
                     outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", **locals())
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    out.shape = array.shape
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length", **locals())
    out = helper.create_variable_for_type_inference(dtype="int64")
    out.stop_gradient = True
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


# -- rank-table machinery ----------------------------------------------------

def lod_rank_table(x, level=0):
    helper = LayerHelper("lod_rank_table", **locals())
    table = helper.main_block.create_var(
        name="{0}.out".format(helper.name), type=VarType.LOD_RANK_TABLE,
        dtype="int32", stop_gradient=True)
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [table]}, attrs={"level": level})
    return table


def max_sequence_len(rank_table):
    helper = LayerHelper("max_seqence_length", **locals())
    res = helper.create_variable_for_type_inference(dtype="int64")
    res.stop_gradient = True
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [res]})
    return res


def lod_tensor_to_array(x, table):
    helper = LayerHelper("lod_tensor_to_array", **locals())
    array = helper.main_block.create_var(
        name="{0}.out".format(helper.name), dtype=x.dtype,
        type=VarType.LOD_TENSOR_ARRAY)
    array.shape = x.shape
    helper.append_op(type="lod_tensor_to_array",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [array]})
    return array


def array_to_lod_tensor(x, table):
    helper = LayerHelper("array_to_lod_tensor", **locals())
    tmp = helper.create_variable_for_type_inference(dtype=x.dtype)
    tmp.lod_level = 1
    tmp.shape = x.shape
    helper.append_op(type="array_to_lod_tensor",
                     inputs={"X": [x], "RankTable": [table]},
                     outputs={"Out": [tmp]})
    return tmp


def shrink_memory(x, i, table):
    helper = LayerHelper("shrink_memory", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.shape = x.shape
    helper.append_op(type="shrink_rnn_memory",
                     inputs={"X": [x], "I": [i], "RankTable": [table]},
                     outputs={"Out": [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    out.lod_level = x.lod_level
    out.shape = x.shape
    helper.append_op(type="reorder_lod_tensor_by_rank",
                     inputs={"X": [x], "RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


# -- While -------------------------------------------------------------------

class BlockGuard(object):
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.program.rollback()
        return exc_type is None


def _block_reads_writes(sub):
    """Outer vars a sub-block reads / writes (flat namespace)."""
    written, read = [], []
    for op in sub.ops:
        for n in op.input_arg_names:
            if n not in read and n not in written:
                read.append(n)
        for n in op.output_arg_names:
            if n not in written:
                written.append(n)
    return read, written


class While(object):
    """reference: layers/control_flow.py:607. Usage:
        cond = layers.less_than(i, n)
        w = While(cond)
        with w.block():
            ... ops; must update cond ...
    A condition on concrete counters unrolls into a compiled step; one
    computed from fed data runs the program on the per-op path.
    Reads/writes of the body are declared as op inputs/outputs so
    append_backward's path walk reaches upstream producers, and while_grad
    (per-iteration vjp BPTT) trains through the loop."""

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        read, written = _block_reads_writes(sub)
        parent_block.append_op(
            type="while",
            inputs={"Condition": [self.cond_var],
                    "X": [n for n in read if n != self.cond_var.name]},
            outputs={"Out": list(written)},
            attrs={"sub_block": sub.idx})


# -- StaticRNN ---------------------------------------------------------------

class StaticRNN(object):
    """Static-length RNN: the step block run once a time step by one
    ``recurrent`` op.
    reference: layers/control_flow.py StaticRNN:237 / operators/recurrent_op.
    Sequence inputs carry time on axis 0 ([T, batch, ...])."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None, is_reverse=False):
        self.helper = LayerHelper("static_rnn", name=name)
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.is_reverse = is_reverse
        self._x = []          # (outer var, inner var)
        self._mems = []       # (boot var, pre var, post var or None)
        self._outputs = []    # (inner var, outer var)
        self._sub = None

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self.status = StaticRNN.IN_RNN_BLOCK
        self._sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        self.status = StaticRNN.AFTER_RNN_BLOCK
        self._complete()

    def _assert_in_rnn(self):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError("this method must be called inside rnn.step()")

    def step_input(self, x):
        self._assert_in_rnn()
        inner = self._sub.create_var(
            name="%s@in@%d" % (self.helper.name, len(self._x)),
            dtype=x.dtype, shape=tuple(x.shape[1:]) if x.shape else None)
        self._x.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, dtype="float32"):
        self._assert_in_rnn()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init or (shape, batch_ref)")
            from . import tensor as _tensor
            parent = self.helper.main_program.blocks[self._sub.parent_idx]
            # create the boot var in the parent block
            with _in_block(self.helper.main_program, parent):
                init = _tensor.fill_constant_batch_size_like(
                    input=batch_ref, shape=([-1] + list(shape)),
                    dtype=dtype, value=value,
                    input_dim_idx=ref_batch_dim_idx,
                    output_dim_idx=init_batch_dim_idx)
        pre = self._sub.create_var(
            name="%s@mem@%d" % (self.helper.name, len(self._mems)),
            dtype=init.dtype, shape=init.shape)
        self._mems.append([init, pre, None])
        return pre

    def update_memory(self, mem, var):
        self._assert_in_rnn()
        for m in self._mems:
            if m[1] is mem:
                m[2] = var
                return
        raise ValueError("update_memory: unknown memory var")

    def step_output(self, o):
        self._assert_in_rnn()
        outer = self._sub.create_var(
            name="%s@out@%d" % (self.helper.name, len(self._outputs)),
            dtype=o.dtype)
        self._outputs.append((o, outer))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        for m in self._mems:
            if m[2] is None:
                raise ValueError("memory %s never updated" % m[1].name)
        # params = outer vars read by the step block but not defined in it
        inner_names = set()
        for op in self._sub.ops:
            inner_names.update(op.output_arg_names)
        inner_names.update(v.name for _, v in self._x)
        inner_names.update(m[1].name for m in self._mems)
        p_names = []
        for op in self._sub.ops:
            for n in op.input_arg_names:
                if n not in inner_names and n not in p_names:
                    p_names.append(n)
        parent = self.helper.main_program.blocks[self._sub.parent_idx]
        out_vars = []
        for (inner, outer) in self._outputs:
            ov = parent.create_var(name=outer.name, dtype=inner.dtype)
            out_vars.append(ov)
        final_mems = [
            parent.create_var(name="%s@final@%d" % (self.helper.name, i),
                              dtype=m[0].dtype)
            for i, m in enumerate(self._mems)]
        parent.append_op(
            type="recurrent",
            inputs={"X": [x for x, _ in self._x],
                    "Boot": [m[0] for m in self._mems],
                    "P": [parent._find_var_recursive(n) or n
                          for n in p_names]},
            outputs={"Out": out_vars, "FinalMems": final_mems},
            attrs={"sub_block": self._sub.idx,
                   "x_inner": [v.name for _, v in self._x],
                   "mem_pre": [m[1].name for m in self._mems],
                   "mem_post": [m[2].name for m in self._mems],
                   "p_names": p_names,
                   "out_inner": [o.name for o, _ in self._outputs],
                   "is_reverse": self.is_reverse})
        self._out_vars = out_vars

    def __call__(self, *args, **kwargs):
        if self.status != StaticRNN.AFTER_RNN_BLOCK:
            raise ValueError("RNN output can only be retrieved after step()")
        if len(self._out_vars) == 1:
            return self._out_vars[0]
        return self._out_vars


# -- DynamicRNN (eager, rank-table driven) ----------------------------------

@contextlib.contextmanager
def _in_block(program, block):
    """Temporarily emit ops into ``block``."""
    saved = program._current_block_idx
    program._current_block_idx = block.idx
    try:
        yield
    finally:
        program._current_block_idx = saved


class DynamicRNN(object):
    """Ragged-batch RNN over LoD input — the reference's While/rank-table
    construction (batch shrinks as short sequences end).
    reference: layers/control_flow.py:1349. Its loop unrolls into a
    compiled step: the trip count is the feed's longest sequence."""

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self.lod_rank_table = None
        self.max_seq_len = None
        self.step_idx = None
        self.zero_idx = None
        self.mem_dict = {}
        self.output_array = []
        self.outputs = []
        self.cond = None
        self.input_array = []
        self.mem_link = []
        self._outer_block = None

    @contextlib.contextmanager
    def block(self):
        from . import tensor as _tensor
        if self.status != DynamicRNN.BEFORE_RNN:
            raise ValueError("block() can only be executed once")
        self._outer_block = self.helper.main_program.current_block()
        self.step_idx = _tensor.fill_constant(shape=[1], dtype="int64",
                                              value=0, force_cpu=True)
        self.zero_idx = _tensor.fill_constant(shape=[1], dtype="int64",
                                              value=0, force_cpu=True)
        # cond starts true; the first step_input rewires it to
        # step_idx < max_seq_len, and the loop tail keeps it fresh
        self.cond = self.helper.main_block.create_var(
            name="%s.cond" % self.helper.name, dtype="bool")
        self.cond.stop_gradient = True
        zero = _tensor.fill_constant(shape=[1], dtype="int64", value=0)
        one = _tensor.fill_constant(shape=[1], dtype="int64", value=1)
        less_than(zero, one, cond=self.cond)
        self.status = DynamicRNN.IN_RNN
        w = While(self.cond)
        with w.block():
            yield
            increment(x=self.step_idx, value=1.0, in_place=True)
            for new_mem, mem_array in self.mem_link:
                array_write(x=new_mem, i=self.step_idx, array=mem_array)
            less_than(x=self.step_idx, y=self.max_seq_len, cond=self.cond)
        self.status = DynamicRNN.AFTER_RNN
        for each_array in self.output_array:
            self.outputs.append(
                array_to_lod_tensor(x=each_array, table=self.lod_rank_table))

    def step_input(self, x):
        self._assert_in_rnn_block_("step_input")
        prog = self.helper.main_program
        with _in_block(prog, self._outer_block):
            if self.lod_rank_table is None:
                self.lod_rank_table = lod_rank_table(x)
                self.max_seq_len = max_sequence_len(self.lod_rank_table)
                less_than(x=self.step_idx, y=self.max_seq_len,
                          cond=self.cond)
            input_array = lod_tensor_to_array(x, self.lod_rank_table)
        self.input_array.append((input_array, x.dtype))
        return array_read(array=input_array, i=self.step_idx)

    def static_input(self, x):
        self._assert_in_rnn_block_("static_input")
        if self.lod_rank_table is None:
            raise RuntimeError("static_input() must follow step_input()")
        with _in_block(self.helper.main_program, self._outer_block):
            return reorder_lod_tensor_by_rank(x, self.lod_rank_table)

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        self._assert_in_rnn_block_("memory")
        if self.lod_rank_table is None:
            raise RuntimeError("memory() must follow step_input()")
        prog = self.helper.main_program
        if init is not None:
            with _in_block(prog, self._outer_block):
                boot = reorder_lod_tensor_by_rank(init, self.lod_rank_table)
                mem_array = array_write(x=boot, i=self.zero_idx)
        else:
            from . import tensor as _tensor
            with _in_block(prog, self._outer_block):
                first_in, _ = self.input_array[0]
                first = array_read(array=first_in, i=self.zero_idx)
                boot = _tensor.fill_constant_batch_size_like(
                    input=first, shape=[-1] + list(shape), dtype=dtype,
                    value=value)
                mem_array = array_write(x=boot, i=self.zero_idx)
        retv = array_read(array=mem_array, i=self.step_idx)
        retv = shrink_memory(retv, self.step_idx, self.lod_rank_table)
        self.mem_dict[retv.name] = mem_array
        return retv

    def update_memory(self, ex_mem, new_mem):
        self._assert_in_rnn_block_("update_memory")
        mem_array = self.mem_dict.get(ex_mem.name)
        if mem_array is None:
            raise ValueError("update_memory: unknown memory")
        self.mem_link.append((new_mem, mem_array))

    def output(self, *outputs):
        self._assert_in_rnn_block_("output")
        for each in outputs:
            outside_array = array_write(x=each, i=self.step_idx)
            self.output_array.append(outside_array)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError("outputs can only be retrieved after the block")
        if len(self.outputs) == 1:
            return self.outputs[0]
        return self.outputs

    def _assert_in_rnn_block_(self, method):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("{0} can only be invoked inside rnn block"
                            .format(method))


# -- split/merge_lod_tensor + IfElse / Switch --------------------------------

def split_lod_tensor(input, mask, level=0):
    """Split ``input`` rows (or whole sequences at lod ``level``) by the
    boolean column ``mask`` into (true_branch, false_branch).

    reference: layers/control_flow.py:55 -> operators/split_lod_tensor_op.cc.
    Outputs keep input's full row capacity; selected rows are
    stably compacted to the front, the tail is zeros (see the op docstring
    in ops/control_flow_ops.py for the padding contract)."""
    helper = LayerHelper("split_lod_tensor", **locals())
    out_true = helper.create_variable_for_type_inference(input.dtype)
    out_false = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="split_lod_tensor",
        inputs={"X": [input], "Mask": [mask]},
        outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
        attrs={"level": level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    """Inverse of split_lod_tensor: reassemble rows by ``mask`` position.

    reference: layers/control_flow.py:101 -> operators/merge_lod_tensor_op.cc.
    ``x`` supplies the output's shape/LoD frame (the reference reads its lod;
    here it also carries lod_level for sequence merges)."""
    helper = LayerHelper("merge_lod_tensor", **locals())
    out = helper.create_variable_for_type_inference(in_true.dtype)
    helper.append_op(
        type="merge_lod_tensor",
        inputs={"X": [x], "Mask": [mask], "InTrue": [in_true],
                "InFalse": [in_false]},
        outputs={"Out": [out]},
        attrs={"level": level})
    return out


class IfElse(object):
    """Row-masked two-branch construct.

    reference: layers/control_flow.py:1247 IfElse — the condition is a
    boolean column over batch rows; ``input(x)`` yields the branch's masked
    slice via split_lod_tensor, ``output(...)`` registers branch results,
    and ``__call__`` merges them back row-by-row with merge_lod_tensor.

    The reference wraps each branch in a ConditionalBlock that the
    interpreter may skip at runtime; here BOTH branches run on
    fixed-capacity masked tensors, so the whole construct (and its
    gradient) is captured into one step — no host round-trip. Rows a
    branch does not own are zero-padded by split and never selected by
    merge, so values and grads match the reference's dynamic-row
    semantics for row-wise branch computation (the IfElse contract). A
    scalar (1-row) condition degenerates to classic if/else."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.output_table = ([], [])  # (false_outs, true_outs) — ref order
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    @contextlib.contextmanager
    def _guard(self, is_true):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("You cannot invoke IfElse.block() inside a block")
        self.status = (IfElse.IN_IF_ELSE_TRUE_BLOCKS if is_true
                       else IfElse.IN_IF_ELSE_FALSE_BLOCKS)
        try:
            yield
        finally:
            self.status = IfElse.OUT_IF_ELSE_BLOCKS
        if len(self.output_table[1 if is_true else 0]) == 0:
            raise ValueError("Must set output inside block")

    def true_block(self):
        return self._guard(True)

    def false_block(self):
        return self._guard(False)

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input must be called inside true/false blocks")
        if id(x) not in self.input_table:
            self.input_table[id(x)] = split_lod_tensor(x, self.cond, level=0)
        out_true, out_false = self.input_table[id(x)]
        return (out_true if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
                else out_false)

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output can only be invoked inside a block")
        table = self.output_table[
            1 if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else 0]
        table.extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ must be out of sub-block")
        false_len, true_len = map(len, self.output_table)
        if false_len == 0 and true_len == 0:
            raise ValueError(
                "Must invoke true_block/false_block before __call__")
        if false_len != true_len and false_len != 0 and true_len != 0:
            raise ValueError("The output side must be same")
        if false_len == 0 or true_len == 0:
            return list(self.output_table[0 if false_len != 0 else 1])
        return [
            merge_lod_tensor(in_true=true_var, in_false=false_var,
                             mask=self.cond, x=self.cond, level=0)
            for false_var, true_var in zip(*self.output_table)]


class Switch(object):
    """reference: layers/control_flow.py Switch — chained conditional
    blocks; each case runs iff its condition holds and no earlier case
    fired (implemented by chaining not-conds)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conds = []

    @contextlib.contextmanager
    def case(self, condition):
        program = self.helper.main_program
        parent = program.current_block()
        conds = [condition]
        for nc in self.pre_not_conds:
            conds.append(nc)
        notv = self.helper.create_variable_for_type_inference("bool")
        parent.append_op(type="logical_not", inputs={"X": [condition]},
                         outputs={"Out": [notv]})
        self.pre_not_conds.append(notv)
        sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        read, written = _block_reads_writes(sub)
        parent.append_op(type="conditional_block",
                         inputs={"Cond": conds, "X": read},
                         outputs={"Out": written},
                         attrs={"sub_block": sub.idx})

    @contextlib.contextmanager
    def default(self):
        program = self.helper.main_program
        parent = program.current_block()
        sub = program.create_block()
        try:
            yield
        finally:
            program.rollback()
        read, written = _block_reads_writes(sub)
        parent.append_op(type="conditional_block",
                         inputs={"Cond": list(self.pre_not_conds), "X": read},
                         outputs={"Out": written},
                         attrs={"sub_block": sub.idx})


# -- beam search --------------------------------------------------------------

def beam_search(pre_ids, ids, scores, beam_size, end_id, level=0):
    """reference: layers/nn.py beam_search -> operators/beam_search_op."""
    helper = LayerHelper("beam_search", **locals())
    selected_scores = helper.create_variable_for_type_inference("float32")
    selected_ids = helper.create_variable_for_type_inference("int64")
    selected_ids.lod_level = selected_scores.lod_level = 2
    helper.append_op(type="beam_search",
                     inputs={"pre_ids": [pre_ids], "ids": [ids],
                             "scores": [scores]},
                     outputs={"selected_ids": [selected_ids],
                              "selected_scores": [selected_scores]},
                     attrs={"level": level, "beam_size": beam_size,
                            "end_id": end_id})
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, name=None):
    """reference: layers/nn.py beam_search_decode."""
    helper = LayerHelper("beam_search_decode", **locals())
    sentence_ids = helper.create_variable_for_type_inference("int64")
    sentence_scores = helper.create_variable_for_type_inference("float32")
    sentence_ids.lod_level = sentence_scores.lod_level = 2
    helper.append_op(type="beam_search_decode",
                     inputs={"Ids": [ids], "Scores": [scores]},
                     outputs={"SentenceIds": [sentence_ids],
                              "SentenceScores": [sentence_scores]})
    return sentence_ids, sentence_scores


# increment lives in tensor.py in the reference; re-export for While loops
from .tensor import increment  # noqa: E402,F401
