"""Optimizers: ``minimize`` = ``append_backward`` + gradient clipping +
regularization + accumulators + optimizer ops (counterpart of
``paddle_tpu/optimizer.py``: the ``Optimizer`` base, the nine optimizer
classes :110-357, ``ModelAverage`` :360 and the short aliases :423).

``minimize`` appends, in the JAX package's order, the clip ops of every
parameter that has a ``gradient_clip_attr`` (``clip.py``), the decay ops
of every parameter with a regularizer or of the optimizer's
``regularization`` (``regularizer.py``), then one update op a parameter
(``ops/optimizer_ops.py``). With neither clip nor regularizer set it
appends the update ops alone. ``learning_rate`` is a float or a
schedule's Variable (``learning_rate_decay.py``). Every update is an op
of the main program, run by the Executor after the backward ops.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .clip import append_gradient_clip_ops
from .core import ir, unique_name
from .core.backward import append_backward
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Adadelta", "AdadeltaOptimizer", "Adagrad", "AdagradOptimizer",
           "Adam", "AdamOptimizer", "Adamax", "AdamaxOptimizer",
           "DecayedAdagrad", "DecayedAdagradOptimizer", "Ftrl",
           "FtrlOptimizer", "ModelAverage", "Momentum", "MomentumOptimizer",
           "Optimizer", "RMSProp", "RMSPropOptimizer", "SGD",
           "SGDOptimizer"]


class Optimizer(object):
    """``LARS_weight_decay`` is accepted and ignored, as in the JAX
    package."""

    def __init__(self, learning_rate, regularization=None,
                 LARS_weight_decay=0.0):
        self._learning_rate = learning_rate
        self.regularization = regularization
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
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
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


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator("moment", param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    """``lazy_mode`` is passed to the op as its attr; on the dense
    gradients of the port it computes the plain update, as the JAX op
    does on a dense gradient."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

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
                   "epsilon": self._epsilon,
                   "lazy_mode": self._lazy_mode})

    def _finish_update(self, block):
        """Advance the beta powers once a step (two ``scale`` ops)."""
        block.append_op(type="scale", inputs={"X": [self._beta1_pow]},
                        outputs={"Out": [self._beta1_pow]},
                        attrs={"scale": self._beta1})
        block.append_op(type="scale", inputs={"X": [self._beta2_pow]},
                        outputs={"Out": [self._beta2_pow]},
                        attrs={"scale": self._beta2})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamaxOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        helper = LayerHelper("adamax")
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
        self._beta1_pow = helper.create_global_variable(
            name=unique_name.generate("beta1_pow_acc"), shape=(1,),
            dtype="float32", persistable=True)
        helper.set_variable_initializer(self._beta1_pow,
                                        ConstantInitializer(self._beta1))

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator("moment", param_and_grad[0])
        inf_norm = self._get_accumulator("inf_norm", param_and_grad[0])
        return block.append_op(
            type="adamax",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [self._beta1_pow],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block):
        block.append_op(type="scale", inputs={"X": [self._beta1_pow]},
                        outputs={"Out": [self._beta1_pow]},
                        attrs={"scale": self._beta1})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate,
                                                      **kwargs)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator("moment", param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """Its op reads no learning rate; the LR var is made all the same, as
    in the JAX package."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        ag = self._get_accumulator("avg_squared_grad", param_and_grad[0])
        au = self._get_accumulator("avg_squared_update", param_and_grad[0])
        return block.append_op(
            type="adadelta",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "AvgSquaredGrad": [ag], "AvgSquaredUpdate": [au]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "AvgSquaredGradOut": [ag], "AvgSquaredUpdateOut": [au]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)

    def _append_optimize_op(self, block, param_and_grad):
        mom = self._get_accumulator("momentum", param_and_grad[0])
        ms = self._get_accumulator("mean_square", param_and_grad[0])
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [mom], "MeanSquare": [ms],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [mom],
                     "MeanSquareOut": [ms]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator("squared", param_and_grad[0])
        lin = self._get_accumulator("linear", param_and_grad[0])
        return block.append_op(
            type="ftrl",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "SquaredAccumOut": [sq], "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class ModelAverage(object):
    """A running average of each trainable parameter, kept on the host in
    float64 (the JAX package's ``ModelAverage``): ``update()`` after a
    step folds the parameters in over a window of
    ``clip(rate * updates, min_window, max_window)`` updates, ``apply()``
    swaps the averages in for evaluation and ``restore()`` swaps the
    training values back.

    The parameters are read to the host with an explicit copy (``cpu()``)
    and written back with ``scope.set_var`` as tensors of their own
    dtype on their own device, so a compiled step copies them into its
    state before the next replay. The backup ``apply`` keeps is a copy:
    a state tensor itself would change under the next replay."""

    def __init__(self, average_window_rate=0.15, min_average_window=100,
                 max_average_window=10000, program=None, scope=None):
        from .core.scope import global_scope
        self.program = program or ir.default_main_program()
        self.scope = scope or global_scope()
        self.rate = average_window_rate
        self.min_window = min_average_window
        self.max_window = max_average_window
        self._avg = {}
        self._backup = None
        self._count = 0

    def _params(self):
        return [p.name for p in self.program.all_parameters()
                if getattr(p, "trainable", True)]

    def _host(self, name):
        return self.scope.find_var(name).detach().cpu().numpy()

    def update(self):
        self._count += 1
        window = min(max(self.rate * self._count, self.min_window),
                     self.max_window)
        n_eff = min(self._count, window)
        for n in self._params():
            v = self._host(n)
            if n not in self._avg:
                self._avg[n] = v.astype(np.float64).copy()
            else:
                self._avg[n] += (v - self._avg[n]) / n_eff

    def apply(self, executor=None, need_restore=True):
        if need_restore and self._backup is None:
            # a second apply() keeps the first backup: it would otherwise
            # back up the averages and lose the training values
            self._backup = {n: self.scope.find_var(n).detach().clone()
                            for n in self._params()}
        for n, a in self._avg.items():
            cur = self.scope.find_var(n)
            self.scope.set_var(n, torch.from_numpy(a).to(cur.dtype).to(
                cur.device))

    def restore(self, executor=None):
        if self._backup:
            for n, v in self._backup.items():
                self.scope.set_var(n, v)
            self._backup = None


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
