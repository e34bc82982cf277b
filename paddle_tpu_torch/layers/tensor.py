"""Tensor layers: fill_constant (and its batch-size-like, ones, zeros,
zeros_like), assign (and assign_numpy), cast, concat, sums,
create_parameter, reverse, argmax, argmin, argsort, range,
pad_constant_like, crop.

Counterpart of ``paddle_tpu/layers/tensor.py`` for the layers whose ops
the port registers.
"""

import numpy as np

from paddle_tpu_torch import framework
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["assign", "assign_numpy", "cast", "concat", "create_parameter",
           "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
           "zeros_like", "sums", "reverse", "argmax", "argmin", "argsort",
           "range", "pad_constant_like", "crop"]


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value),
               "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx},
    )
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    if isinstance(axis, int):
        axis = [axis]
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(axis)})
    return out


def _arg_layer(op_type):
    def fn(x, axis=0):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference("int64")
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return out

    fn.__name__ = op_type.replace("_", "")
    return fn


argmax = _arg_layer("arg_max")
argmin = _arg_layer("arg_min")


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    ids = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def range(start, end, step, dtype):
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="range", outputs={"Out": [out]},
                     attrs={"start": start, "end": end, "step": step,
                            "dtype": dtype})
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """Pad y on the high side of each dim up to x's shape
    (pad_constant_like_op.cc)."""
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(y.dtype)
    helper.append_op(type="pad_constant_like", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"pad_value": float(pad_value)})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """Static crop (crop_op.cc): ``shape`` from ``offsets`` (zeros by
    default), both lists."""
    if shape is None or not isinstance(shape, (list, tuple)):
        raise TypeError("crop: shape must be a static list/tuple")
    offsets = list(offsets) if offsets is not None else [0] * len(shape)
    helper = LayerHelper("crop", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="crop", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "offsets": offsets})
    return out
