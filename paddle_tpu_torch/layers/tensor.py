"""Tensor layers: fill_constant, assign, concat, sums, create_parameter.

Counterpart of ``paddle_tpu/layers/tensor.py`` for the layers this slice
calls.
"""

from paddle_tpu_torch import framework
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["assign", "concat", "create_parameter", "fill_constant", "sums"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name, param_attr=attr)
    return helper.create_parameter(helper.param_attr, shape, dtype, is_bias,
                                   default_initializer)


def assign(input, output=None):
    if not isinstance(input, framework.Variable):
        raise TypeError(
            "assign takes a Variable in this slice of the port (the "
            "assign_value form for numpy arrays is not ported yet)")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    out.stop_gradient = True
    return out
