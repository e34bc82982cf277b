"""Gradient clipping appended as graph ops.

Counterpart of ``paddle_tpu/clip.py`` (python/paddle/fluid/clip.py
parity) for what the training path runs: ``append_gradient_clip_ops``,
which ``Optimizer.minimize`` calls, passes every (param, grad) through the
parameter's clip attr, and with none set (``NullGradientClipAttr``) leaves
the pair as it is. The three clipping classes need ops this port does not
carry yet (``clip``, ``clip_by_norm``, ``square``, ``sqrt``,
``elementwise_max``) and raise when built; ROADMAP.md A11 ports them with
``set_gradient_clip`` and ``ErrorClipByValue``.
"""

__all__ = [
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "append_gradient_clip_ops",
]


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class _NotPorted(BaseGradientClipAttr):
    _ops = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "%s needs the %s op(s), which paddle_tpu_torch does not carry "
            "yet (ROADMAP.md A11)" % (type(self).__name__, self._ops))


class GradientClipByValue(_NotPorted):
    _ops = "clip"


class GradientClipByNorm(_NotPorted):
    _ops = "clip_by_norm"


class GradientClipByGlobalNorm(_NotPorted):
    _ops = "square, sqrt and elementwise_max"


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
