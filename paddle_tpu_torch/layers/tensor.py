"""Tensor layers: fill_constant, assign (and assign_numpy), concat, sums,
create_parameter.

Counterpart of ``paddle_tpu/layers/tensor.py`` for the layers this slice
calls.
"""

import numpy as np

from paddle_tpu_torch import framework
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["assign", "assign_numpy", "concat", "create_parameter",
           "fill_constant", "sums"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name, param_attr=attr)
    return helper.create_parameter(helper.param_attr, shape, dtype, is_bias,
                                   default_initializer)


def assign(input, output=None):
    """Copy a Variable (``assign``), or a numpy array into the program
    (``assign_value``)."""
    if not isinstance(input, framework.Variable):
        return assign_numpy(np.asarray(input), output=output)
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def assign_numpy(arr, output=None):
    helper = LayerHelper("assign_value")
    arr = np.asarray(arr)
    if output is None:
        output = helper.create_variable_for_type_inference(str(arr.dtype))
    helper.append_op(
        type="assign_value",
        outputs={"Out": [output]},
        attrs={"shape": list(arr.shape), "dtype": str(arr.dtype),
               "values": arr.flatten().tolist()},
    )
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
