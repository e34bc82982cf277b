"""Helpers shared by layers + Variable operator sugar.

Counterpart of ``paddle_tpu/layers/math_ops.py``.
"""

from paddle_tpu_torch import framework
from paddle_tpu_torch.layer_helper import LayerHelper


def to_variable_like(value, ref):
    """Wrap a Python scalar as a fill_constant var of ``ref``'s dtype."""
    from paddle_tpu_torch.layers import tensor as tensor_layers

    if isinstance(value, framework.Variable):
        return value
    if not isinstance(value, (int, float, bool)):
        raise TypeError(
            "only Variables and Python scalars combine with a Variable in "
            "this slice of the port, got %r" % type(value).__name__)
    return tensor_layers.fill_constant(shape=[1], dtype=ref.dtype,
                                       value=float(value))


def elementwise_binary(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    y = to_variable_like(y, x)
    x = to_variable_like(x, y)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return helper.append_activation(out)


def elementwise_binary_reversed(op_type, var, other, axis=-1):
    """other <op> var, for __rsub__/__rtruediv__."""
    other = to_variable_like(other, var)
    return elementwise_binary(op_type, other, var, axis=axis)
