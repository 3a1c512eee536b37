"""Optimizers: ``minimize`` = ``append_backward`` + accumulators +
optimizer ops (counterpart of ``paddle_tpu/optimizer.py``: the
``Optimizer`` base, ``SGDOptimizer``, ``MomentumOptimizer`` :130 and
``AdamOptimizer`` :175).

Every parameter update is an op of the main program, run by the
Executor after the backward ops. Gradient clipping and regularization
are not ported yet; with neither configured the JAX package appends no
op for them either.
"""
from __future__ import annotations

from collections import defaultdict

from .core import ir, unique_name
from .core.backward import append_backward
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper

__all__ = ["Adam", "AdamOptimizer", "Momentum", "MomentumOptimizer",
           "Optimizer", "SGD", "SGDOptimizer"]


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None):
        if regularization is not None:
            raise NotImplementedError(
                "regularization is not ported to paddle_tpu_torch yet")
        self._learning_rate = learning_rate
        self._accumulators = defaultdict(dict)
        self._learning_rate_map = {}

    def _create_lr_var(self, program):
        if program in self._learning_rate_map:
            return self._learning_rate_map[program]
        if isinstance(self._learning_rate, ir.Variable):
            self._learning_rate_map[program] = self._learning_rate
            return self._learning_rate
        helper = LayerHelper("learning_rate")
        lr = helper.create_global_variable(
            name=unique_name.generate("learning_rate"), shape=(1,),
            dtype="float32", persistable=True)
        helper.set_variable_initializer(
            lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[program] = lr
        return lr

    def _global_learning_rate(self, program=None):
        program = program or ir.default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        """The global LR var, or a ``scale`` of it by the parameter's
        ``learning_rate`` attr."""
        param = param_and_grad[0]
        base = self._global_learning_rate()
        param_lr = getattr(param, "optimize_attr", {}).get("learning_rate",
                                                           1.0)
        if param_lr == 1.0:
            return base
        from . import layers
        return layers.scale(base, scale=float(param_lr))

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape or param.shape, dtype=dtype or param.dtype,
            persistable=True)
        helper.set_variable_initializer(var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        optimize_ops = self._create_optimization_pass(
            params_grads, loss, startup_program)
        return optimize_ops, params_grads

    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        block = loss.block
        with ir.program_guard(program, startup_program
                              or ir.default_startup_program()):
            self._create_lr_var(program)
            self._create_accumulators(block,
                                      [p for p, g in parameters_and_grads])
            optimize_ops = []
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if getattr(param_and_grad[0], "trainable", True):
                    optimize_ops.append(
                        self._append_optimize_op(block, param_and_grad))
            self._finish_update(block)
        return optimize_ops


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super(SGDOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]})


class MomentumOptimizer(Optimizer):
    """One ``velocity`` accumulator per parameter and a ``momentum`` op
    (``v = mu * v + g``, ``p -= lr * v``, or the Nesterov form)."""

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator("velocity", param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        helper = LayerHelper("adam")
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
        self._beta1_pow = helper.create_global_variable(
            name=unique_name.generate("beta1_pow_acc"), shape=(1,),
            dtype="float32", persistable=True)
        helper.set_variable_initializer(self._beta1_pow,
                                        ConstantInitializer(self._beta1))
        self._beta2_pow = helper.create_global_variable(
            name=unique_name.generate("beta2_pow_acc"), shape=(1,),
            dtype="float32", persistable=True)
        helper.set_variable_initializer(self._beta2_pow,
                                        ConstantInitializer(self._beta2))

    def _append_optimize_op(self, block, param_and_grad):
        m1 = self._get_accumulator("moment1", param_and_grad[0])
        m2 = self._get_accumulator("moment2", param_and_grad[0])
        return block.append_op(
            type="adam",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [self._beta1_pow],
                    "Beta2Pow": [self._beta2_pow],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "Moment1Out": [m1], "Moment2Out": [m2]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   # dense gradients only: the sparse lazy mode is not
                   # ported
                   "epsilon": self._epsilon, "lazy_mode": False})

    def _finish_update(self, block):
        """Advance the beta powers once a step (two ``scale`` ops)."""
        block.append_op(type="scale", inputs={"X": [self._beta1_pow]},
                        outputs={"Out": [self._beta1_pow]},
                        attrs={"scale": self._beta1})
        block.append_op(type="scale", inputs={"X": [self._beta2_pow]},
                        outputs={"Out": [self._beta2_pow]},
                        attrs={"scale": self._beta2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
