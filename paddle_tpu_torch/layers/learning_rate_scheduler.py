"""LR schedules as in-graph ops over a global step counter.

Counterpart of ``paddle_tpu/layers/learning_rate_scheduler.py``
(python/paddle/fluid/layers/learning_rate_scheduler.py parity: noam,
exponential, natural_exp, inverse_time, polynomial, piecewise, cosine).
Each schedule is computed in the step's program from the persistable
``@LR_DECAY_COUNTER@``, which one ``increment`` op advances a run.
"""

import math

from paddle_tpu_torch import framework
from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import nn, ops, tensor

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "cosine_decay",
    "append_LARS",
]

_DECAY_COUNTER = "@LR_DECAY_COUNTER@"


def _global_step_counter(counter_name=None, begin=0, step=1):
    """The program's shared step counter. The ``increment`` op is
    appended only when the counter is first created, so several call
    sites (two schedules, ``autoincreased_step_counter``) share one
    +step a run, the reference's is-new-var guard. Kept float32, as the
    JAX package keeps it (exact to 2**24 steps)."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or _DECAY_COUNTER
    gblock = helper.main_program.global_block()
    existed = gblock.has_var(name)
    counter = helper.create_global_variable(
        name=name, shape=[1], dtype="float32", persistable=True,
        initializer=init_mod.ConstantInitializer(float(begin - step)))
    if not existed:
        gblock.append_op(
            type="increment",
            inputs={"X": [counter.name]},
            outputs={"Out": [counter.name]},
            attrs={"step": float(step), framework.OP_ROLE_ATTR_NAME:
                   framework.OpRole.LRSched},
        )
    return counter


def noam_decay(d_model, warmup_steps):
    with framework.default_main_program()._lr_schedule_guard():
        step = _global_step_counter()
        a = step ** -0.5
        b = step * (warmup_steps ** -1.5)
        return (d_model ** -0.5) * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    with framework.default_main_program()._lr_schedule_guard():
        step = _global_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = ops.floor(div)
        return learning_rate * (decay_rate ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    with framework.default_main_program()._lr_schedule_guard():
        step = _global_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = ops.floor(div)
        return learning_rate * ops.exp(-1.0 * decay_rate * div)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    with framework.default_main_program()._lr_schedule_guard():
        step = _global_step_counter()
        div = step / float(decay_steps)
        if staircase:
            div = ops.floor(div)
        denom = div * decay_rate + 1.0
        return nn.elementwise_div(
            tensor.fill_constant([1], "float32", learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    with framework.default_main_program()._lr_schedule_guard():
        step = _global_step_counter()
        if cycle:
            div_res = ops.ceil(step / float(decay_steps))
            ones = tensor.fill_constant([1], "float32", 1.0)
            div_res = nn.elementwise_max(div_res, ones)
            frac = step / (div_res * float(decay_steps))
        else:
            capped = nn.elementwise_min(step, tensor.fill_constant(
                [1], "float32", float(decay_steps)))
            frac = capped * (1.0 / float(decay_steps))
        base = nn.elementwise_sub(tensor.fill_constant([1], "float32", 1.0),
                                  frac)
        powed = nn.elementwise_pow(base, tensor.fill_constant(
            [1], "float32", power))
        return powed * (learning_rate - end_learning_rate) \
            + end_learning_rate


def piecewise_decay(boundaries, values):
    """Piecewise constant: nested selects by ``less_than``, built from
    the last interval backwards."""
    from paddle_tpu_torch.layers.control_flow import less_than

    assert len(boundaries) + 1 == len(values)
    with framework.default_main_program()._lr_schedule_guard():
        step = _global_step_counter()
        lr = tensor.fill_constant([1], "float32", values[-1])
        for b, v in zip(reversed(boundaries), reversed(values[:-1])):
            cond = less_than(step, tensor.fill_constant([1], "float32",
                                                        float(b)))
            lr = _where(cond, tensor.fill_constant([1], "float32", v), lr)
        return lr


def _where(cond, a, b):
    cond_f = tensor.cast(cond, a.dtype)
    one = tensor.fill_constant([1], a.dtype, 1.0)
    return nn.elementwise_add(
        nn.elementwise_mul(a, cond_f),
        nn.elementwise_mul(b, nn.elementwise_sub(one, cond_f)))


def cosine_decay(learning_rate, step_each_epoch, epochs):
    with framework.default_main_program()._lr_schedule_guard():
        step = _global_step_counter()
        epoch = ops.floor(step / float(step_each_epoch))
        return (learning_rate
                * (ops.cos(epoch * (math.pi / float(epochs))) + 1.0) / 2.0)


def append_LARS(params_grads, learning_rate, weight_decay):
    raise NotImplementedError(
        "use optimizer.LarsMomentumOptimizer (lars_momentum op) instead")
