"""Weight-decay regularizers appended as grad-rewrite ops.

Counterpart of ``paddle_tpu/regularizer.py`` (python/paddle/fluid/
regularizer.py parity). ``append_regularization_ops``, which
``Optimizer.minimize`` calls, leaves a gradient as it is when neither the
parameter nor the optimizer names a regularizer, and otherwise appends
``grad + decay(param)`` as a ``sum`` op. ``L2Decay`` runs (``scale`` and
``sum``); ``L1Decay`` needs the ``sign`` op, which this port does not
carry yet (ROADMAP.md A11), and raises when built.
"""

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer",
           "append_regularization_ops"]


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale",
            inputs={"X": [param.name]},
            outputs={"Out": [decay.name]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        raise NotImplementedError(
            "L1Decay needs the sign op, which paddle_tpu_torch does not "
            "carry yet (ROADMAP.md A11)")


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad += decay(param); a parameter's own regularizer overrides the
    optimizer's (regularizer.py:49)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        with block.program._optimized_guard([param, grad]):
            regularizer = param.regularizer or regularization
            if regularizer is None:
                params_and_grads.append((param, grad))
                continue
            term = regularizer(param, grad, block)
            new_grad = block.create_var(
                name=grad.name + "@REGULARIZED", dtype=param.dtype,
                shape=param.shape)
            block.append_op(
                type="sum",
                inputs={"X": [grad.name, term.name]},
                outputs={"Out": [new_grad.name]},
            )
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
