"""Stateful evaluators accumulating metrics across batches (counterpart
of ``paddle_tpu/evaluator.py``: ``Evaluator`` :23, ``Accuracy`` :67,
``ChunkEvaluator`` :87, ``EditDistance`` :119).

The states are persistable vars of the main program: each batch's ops
add the batch's statistic to them inside the same step (captured with
it), ``reset`` zeroes them through a small program of its own, and
``eval`` reads them back from the scope. ``ChunkEvaluator``'s
``chunk_eval`` is a host op, so a program that holds one runs on the
Executor's hybrid path: its device segments captured, the op between
them."""
from __future__ import annotations

import numpy as np

from . import layers
from .core import ir, unique_name
from .core.scope import global_scope
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper

__all__ = ["Evaluator", "Accuracy", "ChunkEvaluator", "EditDistance"]


class Evaluator(object):
    """Subclasses create their states in ``__init__`` and append the ops
    that update them to the main program."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        """Zero every state, by a program of ``fill_constant`` ops run on
        ``executor`` in the global scope."""
        if reset_program is None:
            reset_program = ir.Program()
        with ir.program_guard(main_program=reset_program):
            for var in self.states:
                blk = reset_program.global_block()
                zv = blk.create_var(name=var.name, shape=var.shape,
                                    dtype=var.dtype, persistable=True)
                layers.fill_constant(shape=var.shape, dtype=var.dtype,
                                     value=0.0, out=zv)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def _create_state(self, suffix, dtype, shape):
        state = self.helper.create_global_variable(
            name=unique_name.generate(self.helper.name + "_" + suffix),
            shape=shape, dtype=dtype, persistable=True)
        self.helper.set_variable_initializer(state, ConstantInitializer(0.0))
        self.states.append(state)
        return state

    def _accumulate(self, state, batch_value):
        """state += batch_value, written back onto the state var."""
        self.helper.append_op(type="elementwise_add",
                              inputs={"X": [state], "Y": [batch_value]},
                              outputs={"Out": [state]})

    def _state_value(self, state):
        return global_scope().find_var(state.name).cpu().numpy()


class Accuracy(Evaluator):
    """Top-k accuracy over every batch since the last reset."""

    def __init__(self, input, label, k=1, **kwargs):
        super(Accuracy, self).__init__("accuracy", **kwargs)
        self.total = self._create_state("total", "int32", (1,))
        self.correct = self._create_state("correct", "int32", (1,))
        correct = self.helper.create_variable_for_type_inference("int32")
        total = self.helper.create_variable_for_type_inference("int32")
        acc = layers.accuracy(input, label, k=k, correct=correct, total=total)
        self._accumulate(self.total, total)
        self._accumulate(self.correct, correct)
        self.metrics.append(acc)

    def eval(self, executor, eval_program=None):
        total = float(self._state_value(self.total)[0])
        correct = float(self._state_value(self.correct)[0])
        return np.array(correct / max(total, 1.0), dtype="float32")


class ChunkEvaluator(Evaluator):
    """Chunk precision, recall and F1 (NER-style) over every batch since
    the last reset, from the accumulated chunk counts."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, **kwargs):
        super(ChunkEvaluator, self).__init__("chunk_eval", **kwargs)
        self.num_infer_chunks = self._create_state("num_infer", "int64", (1,))
        self.num_label_chunks = self._create_state("num_label", "int64", (1,))
        self.num_correct_chunks = self._create_state("num_correct", "int64",
                                                     (1,))
        (precision, recall, f1, num_infer, num_label,
         num_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types)
        self._accumulate(self.num_infer_chunks, num_infer)
        self._accumulate(self.num_label_chunks, num_label)
        self._accumulate(self.num_correct_chunks, num_correct)
        self.metrics.extend([precision, recall, f1])

    def eval(self, executor, eval_program=None):
        num_infer = float(self._state_value(self.num_infer_chunks)[0])
        num_label = float(self._state_value(self.num_label_chunks)[0])
        num_correct = float(self._state_value(self.num_correct_chunks)[0])
        precision = num_correct / num_infer if num_infer else 0.0
        recall = num_correct / num_label if num_label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if num_correct else 0.0)
        return (np.float32(precision), np.float32(recall), np.float32(f1))


class EditDistance(Evaluator):
    """The average edit distance and the share of sequences with an error,
    over every batch since the last reset."""

    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super(EditDistance, self).__init__("edit_distance", **kwargs)
        self.total_distance = self._create_state("total_distance", "float32",
                                                 (1,))
        self.seq_num = self._create_state("seq_num", "int64", (1,))
        self.instance_error = self._create_state("instance_error", "int64",
                                                 (1,))
        distances, seq_num = layers.edit_distance(
            input, label, ignored_tokens=ignored_tokens)
        zero = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        errors = layers.cast(
            layers.reduce_sum(
                layers.cast(distances > zero, "float32")), "int64")
        errors = layers.reshape(errors, shape=[1])
        total = layers.reshape(layers.reduce_sum(distances), shape=[1])
        self._accumulate(self.total_distance, total)
        self._accumulate(self.seq_num, seq_num)
        self._accumulate(self.instance_error, errors)
        self.metrics.append(distances)

    def eval(self, executor, eval_program=None):
        total = float(self._state_value(self.total_distance)[0])
        seq_num = float(self._state_value(self.seq_num)[0])
        err = float(self._state_value(self.instance_error)[0])
        avg = total / max(seq_num, 1.0)
        rate = err / max(seq_num, 1.0)
        return np.float32(avg), np.float32(rate)
