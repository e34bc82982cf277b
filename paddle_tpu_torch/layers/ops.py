"""Thin layer wrappers for single-in/single-out ops.

Counterpart of ``paddle_tpu/layers/ops.py`` (generated from op schemas)
for the activations the port runs.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["relu", "log_softmax", "sigmoid", "tanh"]


def _unary(op_type):
    def fn(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    fn.__name__ = op_type
    return fn


relu = _unary("relu")
log_softmax = _unary("log_softmax")
sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
