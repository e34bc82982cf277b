"""Thin layer wrappers generated from the op schemas.

Counterpart of ``paddle_tpu/layers/ops.py`` (layer_function_generator.py
role) for the single-input, single-output ops: the activations, plus
``cumsum``, ``clip``, ``clip_by_norm`` and ``maxout``. Keyword arguments
that name one of the op's attrs become that attr.
"""

from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.layer_helper import LayerHelper

_UNARY_ACTIVATIONS = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "tanh",
    "tanh_shrink",
    "softshrink",
    "sqrt",
    "rsqrt",
    "abs",
    "ceil",
    "floor",
    "cos",
    "sin",
    "round",
    "reciprocal",
    "log",
    "square",
    "softplus",
    "softsign",
    "relu",
    "relu6",
    "gelu",
    "elu",
    "leaky_relu",
    "soft_relu",
    "brelu",
    "pow",
    "stanh",
    "hard_sigmoid",
    "hard_shrink",
    "thresholded_relu",
    "swish",
    "sign",
    "log_softmax",
]

__all__ = list(_UNARY_ACTIVATIONS) + ["cumsum", "clip", "clip_by_norm",
                                      "maxout"]


def _make_unary(op_type):
    opdef = op_registry.get_op_def(op_type)

    def layer_fn(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        attrs = {k: kwargs[k] for k in opdef.attrs if k in kwargs}
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer_fn.__name__ = op_type
    layer_fn.__doc__ = "Generated layer for operator %r." % op_type
    return layer_fn


for _name in __all__:
    globals()[_name] = _make_unary(_name)
