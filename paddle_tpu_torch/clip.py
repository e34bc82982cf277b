"""Gradient clipping appended as graph ops.

Counterpart of ``paddle_tpu/clip.py`` (python/paddle/fluid/clip.py
parity). ``append_gradient_clip_ops``, which ``Optimizer.minimize``
calls, passes every (param, grad) through the parameter's clip attr
(``set_gradient_clip`` sets it): ``GradientClipByValue`` appends a
``clip`` op, ``GradientClipByNorm`` a ``clip_by_norm`` op, and
``GradientClipByGlobalNorm`` scales each gradient of a group by
``clip / max(norm, clip)``, the norm taken over the whole group. With no
attr set (``NullGradientClipAttr``) the pair stays as it is.
"""

import copy

from paddle_tpu_torch import framework, layers

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
]


class BaseErrorClipAttr(object):
    pass


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


def _clipped_grad(grad, op_type, attrs):
    block = grad.block
    new_grad = block.create_var(name=grad.name + "@CLIP", dtype=grad.dtype,
                                shape=grad.shape)
    block.append_op(type=op_type, inputs={"X": [grad.name]},
                    outputs={"Out": [new_grad.name]}, attrs=attrs)
    return new_grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        return param, _clipped_grad(grad, "clip",
                                    {"min": self.min, "max": self.max})


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        return param, _clipped_grad(grad, "clip_by_norm",
                                    {"max_norm": self.clip_norm})


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError(
                "all parameters' clip_norm in a group must agree")
        sq = layers.reduce_sum(layers.square(grad))
        context[self.group_name].append(sq)
        self.context = context

    def _create_operators(self, param, grad):
        group = self.context[self.group_name]
        if not isinstance(group, framework.Variable):
            group_norm = layers.sqrt(layers.sums(group))
            clip_var = layers.fill_constant(shape=[1], dtype=group_norm.dtype,
                                            value=self.clip_norm)
            # scale = clip / max(norm, clip)
            self.context[self.group_name] = layers.elementwise_div(
                clip_var, layers.elementwise_max(clip_var, group_norm))
        return param, layers.elementwise_mul(grad,
                                             self.context[self.group_name])


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or framework.default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [program.global_block().var(p) if isinstance(p, str) else p
                  for p in param_list]
    for param in param_list:
        param.gradient_clip_attr = copy.deepcopy(clip)


def error_clip_callback(block, context):
    """A no-op, as in the JAX package: ``ErrorClipByValue`` is kept for
    its API."""


def append_gradient_clip_ops(param_grad):
    """Each (param, grad) through its clip attr, inside the optimizer's
    role guard (clip.py:128)."""
    context = {}
    for p, g in param_grad:
        if g is None:
            continue
        clip_attr = p.gradient_clip_attr or NullGradientClipAttr()
        with p.block.program._optimized_guard([p, g]):
            clip_attr._process_context(context=context, param=p, grad=g)

    res = []
    for p, g in param_grad:
        if g is None:
            res.append((p, g))
            continue
        clip_attr = p.gradient_clip_attr or NullGradientClipAttr()
        with p.block.program._optimized_guard([p, g]):
            res.append(clip_attr._create_operators(param=p, grad=g))
    return res
