"""Optimizers: minimize = append_backward + accumulators + update OPS.

Counterpart of ``paddle_tpu/optimizer.py`` (python/paddle/fluid/
optimizer.py:41 Optimizer base parity) for ``SGDOptimizer`` and
``AdamOptimizer``, with the reference's learning-rate and accumulator
names (``<param>_moment1_0``, ``learning_rate_0``), so a JAX run's state
carries across by name (``convert.persistables_from_numpy``). Update rules
are ops (``ops/optimizer_ops.py``) that write their results back onto the
parameter and accumulator names; the executor stores them in the scope.
The other optimizers of the JAX package are queued in ROADMAP.md.
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


# Public aliases matching fluid.optimizer.
SGD = SGDOptimizer
Adam = AdamOptimizer
