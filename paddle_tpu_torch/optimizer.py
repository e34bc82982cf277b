"""Optimizers: minimize = append_backward + accumulators + update OPS.

Counterpart of ``paddle_tpu/optimizer.py`` (python/paddle/fluid/
optimizer.py:41 Optimizer base parity): SGD, Momentum (Nesterov too),
LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp
(centered too), Ftrl and ModelAverage, with the reference's
learning-rate and accumulator names (``<param>_velocity_0``,
``<param>_moment1_0``, ``learning_rate_0``), so a JAX run's state carries
across by name (``convert.persistables_from_numpy``). Update rules are
ops (``ops/optimizer_ops.py``) that write their results back onto the
parameter and accumulator names; the executor stores them in the scope.
"""

from collections import defaultdict

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper


class Optimizer(object):
    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # -- learning rate ------------------------------------------------------
    def _create_global_learning_rate(self):
        program = framework.default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        self._learning_rate_map[program] = self.helper.create_global_variable(
            name=unique_name.generate("learning_rate"),
            shape=[1],
            dtype="float32",
            persistable=True,
            initializer=initializer.ConstantInitializer(
                float(self._learning_rate)),
        )

    def _global_learning_rate(self, program=None):
        program = program or framework.default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = (param.optimize_attr or {}).get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        from paddle_tpu_torch.layers import nn

        return nn.scale(base, scale=float(param_lr))

    # -- accumulators -------------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var = self.helper.create_global_variable(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape or list(param.shape),
            dtype=dtype or param.dtype,
            persistable=True,
            initializer=initializer.ConstantInitializer(float(fill_value)),
        )
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- hooks for subclasses ----------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- driver -------------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        block = program.global_block()
        self.helper = LayerHelper(self.__class__.__name__,
                                  startup_program=startup_program)
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        self._create_global_learning_rate()

        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            with program._optimized_guard(list(param_and_grad)):
                if param_and_grad[0].trainable:
                    optimize_ops.append(
                        self._append_optimize_op(block, param_and_grad))
        with program._optimized_guard([]):
            self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Backward, clip, regularize and update ops on ``loss``'s
        program; returns (optimize_ops, params_grads)."""
        from paddle_tpu_torch import clip as clip_mod
        from paddle_tpu_torch import regularizer as reg_mod

        with framework.program_guard(
                loss.block.program,
                startup_program or framework.default_startup_program()):
            params_grads = append_backward(loss, parameter_list, no_grad_set)
            params_grads = sorted(params_grads, key=lambda x: x[0].name)
            params_grads = clip_mod.append_gradient_clip_ops(params_grads)
            params_grads = reg_mod.append_regularization_ops(
                params_grads, self.regularization)
            optimize_ops = self._create_optimization_pass(
                params_grads, loss, startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super(SGDOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={
                "Param": [param_and_grad[0].name],
                "Grad": [param_and_grad[1].name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={"ParamOut": [param_and_grad[0].name]},
        )


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(
            self._velocity_acc_str, param_and_grad[0]
        )
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [param_and_grad[0].name],
                "Grad": [param_and_grad[1].name],
                "Velocity": [velocity.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={
                "ParamOut": [param_and_grad[0].name],
                "VelocityOut": [velocity.name],
            },
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class LarsMomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super(LarsMomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(
            self._velocity_acc_str, param_and_grad[0]
        )
        return block.append_op(
            type="lars_momentum",
            inputs={
                "Param": [param_and_grad[0].name],
                "Grad": [param_and_grad[1].name],
                "Velocity": [velocity.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={
                "ParamOut": [param_and_grad[0].name],
                "VelocityOut": [velocity.name],
            },
            attrs={
                "mu": self._momentum,
                "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
            },
        )


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={
                "Param": [param_and_grad[0].name],
                "Grad": [param_and_grad[1].name],
                "Moment": [moment.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={
                "ParamOut": [param_and_grad[0].name],
                "MomentOut": [moment.name],
            },
            attrs={"epsilon": self._epsilon},
        )


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator(self._beta2_pow_acc_str, p,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment1 = self._get_accumulator(self._moment1_acc_str, p)
        moment2 = self._get_accumulator(self._moment2_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, p)
        return block.append_op(
            type="adam",
            inputs={
                "Param": [p.name],
                "Grad": [param_and_grad[1].name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
                "Moment1": [moment1.name],
                "Moment2": [moment2.name],
                "Beta1Pow": [beta1_pow.name],
                "Beta2Pow": [beta2_pow.name],
            },
            outputs={
                "ParamOut": [p.name],
                "Moment1Out": [moment1.name],
                "Moment2Out": [moment2.name],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )

    def _finish_update(self, block, parameters_and_grads):
        """Scale the beta-pow accumulators (Adam._finish_update)."""
        for p, g in parameters_and_grads:
            if g is None:
                continue
            for acc_str, beta in [(self._beta1_pow_acc_str, self._beta1),
                                  (self._beta2_pow_acc_str, self._beta2)]:
                acc = self._get_accumulator(acc_str, p)
                block.append_op(
                    type="scale",
                    inputs={"X": [acc.name]},
                    outputs={"Out": [acc.name]},
                    attrs={"scale": beta},
                )


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamaxOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(
                self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1]
            )

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, p)
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [p.name],
                "Grad": [param_and_grad[1].name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
                "Moment": [moment.name],
                "InfNorm": [inf_norm.name],
                "Beta1Pow": [beta1_pow.name],
            },
            outputs={
                "ParamOut": [p.name],
                "MomentOut": [moment.name],
                "InfNormOut": [inf_norm.name],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )

    def _finish_update(self, block, parameters_and_grads):
        for p, g in parameters_and_grads:
            if g is None:
                continue
            acc = self._get_accumulator(self._beta1_pow_acc_str, p)
            block.append_op(
                type="scale",
                inputs={"X": [acc.name]},
                outputs={"Out": [acc.name]},
                attrs={"scale": self._beta1},
            )


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [param_and_grad[0].name],
                "Grad": [param_and_grad[1].name],
                "Moment": [moment.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={
                "ParamOut": [param_and_grad[0].name],
                "MomentOut": [moment.name],
            },
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        asg = self._get_accumulator(self._avg_squared_grad_acc_str, p)
        asu = self._get_accumulator(self._avg_squared_update_acc_str, p)
        return block.append_op(
            type="adadelta",
            inputs={
                "Param": [p.name],
                "Grad": [param_and_grad[1].name],
                "AvgSquaredGrad": [asg.name],
                "AvgSquaredUpdate": [asu.name],
            },
            outputs={
                "ParamOut": [p.name],
                "AvgSquaredGradOut": [asg.name],
                "AvgSquaredUpdateOut": [asu.name],
            },
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        momentum = self._get_accumulator(self._momentum_acc_str, p)
        mean_square = self._get_accumulator(self._mean_square_acc_str, p)
        mean_grad = self._get_accumulator(self._mean_grad_acc_str, p)
        return block.append_op(
            type="rmsprop",
            inputs={
                "Param": [p.name],
                "Grad": [param_and_grad[1].name],
                "Moment": [momentum.name],
                "MeanSquare": [mean_square.name],
                "MeanGrad": [mean_grad.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={
                "ParamOut": [p.name],
                "MomentOut": [momentum.name],
                "MeanSquareOut": [mean_square.name],
                "MeanGradOut": [mean_grad.name],
            },
            attrs={
                "epsilon": self._epsilon,
                "decay": self._rho,
                "momentum": self._momentum,
                "centered": self._centered,
            },
        )


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        squared = self._get_accumulator(self._squared_acc_str, p)
        linear = self._get_accumulator(self._linear_acc_str, p)
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [p.name],
                "Grad": [param_and_grad[1].name],
                "SquaredAccumulator": [squared.name],
                "LinearAccumulator": [linear.name],
                "LearningRate": [self._create_param_lr(param_and_grad).name],
            },
            outputs={
                "ParamOut": [p.name],
                "SquaredAccumOut": [squared.name],
                "LinearAccumOut": [linear.name],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class ModelAverage(Optimizer):
    """Maintains running averages of parameters for eval
    (optimizer.py:1313 parity) — apply()/restore() swap averaged params."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super(ModelAverage, self).__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._sum_vars = {}

    def _append_average_accumulate_op(self, param):
        self.helper = LayerHelper("model_average")
        sum_var = self._add_accumulator("sum", param)
        num_var = self._add_accumulator("num_acc", param, shape=[1],
                                        dtype="float32")
        block = framework.default_main_program().global_block()
        block.append_op(
            type="sum",
            inputs={"X": [sum_var.name, param.name]},
            outputs={"Out": [sum_var.name]},
        )
        block.append_op(
            type="increment",
            inputs={"X": [num_var.name]},
            outputs={"Out": [num_var.name]},
            attrs={"step": 1.0},
        )
        self._sum_vars[param.name] = (sum_var, num_var)

    def build(self, params):
        for p in params:
            self._append_average_accumulate_op(p)

    def apply(self, executor, scope=None):
        """Overwrite params with their running averages in the scope
        (sum / max(count, 1)); ``restore`` puts the params back."""
        import torch

        from paddle_tpu_torch.executor import global_scope

        def tensor(v):
            return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)

        scope = scope or global_scope()
        self._backup = {}
        for pname, (sum_var, num_var) in self._sum_vars.items():
            p = scope.get_value(pname)
            s = scope.get_value(sum_var.name)
            n = scope.get_value(num_var.name)
            if p is None or s is None or n is None:
                continue
            self._backup[pname] = p
            denom = max(float(tensor(n).reshape(-1)[0]), 1.0)
            p = tensor(p)
            scope.set_value(pname, (tensor(s).to(p.device) / denom).to(
                p.dtype))

    def restore(self, executor, scope=None):
        from paddle_tpu_torch.executor import global_scope

        scope = scope or global_scope()
        for pname, val in getattr(self, "_backup", {}).items():
            scope.set_value(pname, val)
        self._backup = {}


# Public aliases matching fluid.optimizer.
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
