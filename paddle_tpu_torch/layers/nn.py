"""Core NN layers.

Counterpart of ``paddle_tpu/layers/nn.py`` for the layers this slice
calls, with the reference's names, signatures and parameter naming.
"""

import math

import numpy as np

from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers.ops import relu  # noqa: F401  (re-export)
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = [
    "conv2d",
    "pool2d",
    "mul",
    "dropout",
    "dynamic_update_slice",
    "one_hot",
    "fc",
    "embedding",
    "layer_norm",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_min",
    "reduce_sum",
    "scale",
    "reshape",
    "transpose",
    "gather",
    "relu",
    "softmax",
    "mean",
    "topk",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer (nn.py:88-136): one mul per input, each with
    its own weight, a ``sum`` of the products when there are several,
    then the bias and the activation."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = helper.param_attr
    if not isinstance(param_attrs, (list, tuple)):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for inp, attr in zip(inputs, param_attrs):
        in_features = 1
        for d in inp.shape[num_flatten_dims:]:
            in_features *= int(d)
        w = helper.create_parameter(attr=attr, shape=[in_features, size],
                                    dtype=inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    """2-D convolution over NCHW (nn.py:210): the filter is
    ``<name>.w_0``, the bias ``<name>.w_1``, added on axis 1."""
    helper = LayerHelper("conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    num_channels = int(input.shape[1])
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=input.dtype,
        default_initializer=init_mod.NormalInitializer(
            0.0, math.sqrt(2.0 / fan_in)))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups},
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    """2-D max or average pooling over NCHW (nn.py:362)."""
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="mul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup_table layer."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=list(size),
                                dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    if padding_idx is None:
        padding_idx = -1
    elif padding_idx < 0:
        padding_idx = size[0] + padding_idx
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx},
    )
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Dropout layer (nn.py:175): a nonzero ``seed`` pins the op's draws."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "fix_seed": seed is not None,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation},
    )
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_size = int(np.prod([int(d) for d in input.shape[begin_norm_axis:]]))
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            attr=helper.param_attr, shape=[norm_size], dtype=dtype,
            default_initializer=init_mod.ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr or ParamAttr(), shape=[norm_size],
            dtype=dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def _elementwise_layer(op_type):
    def fn(x, y, axis=-1, act=None, name=None):
        from paddle_tpu_torch.layers.math_ops import elementwise_binary

        return elementwise_binary(op_type, x, y, axis=axis, act=act,
                                  name=name)

    fn.__name__ = op_type
    return fn


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_min = _elementwise_layer("elementwise_min")


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": [dim] if isinstance(dim, int) else list(dim),
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type="reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def dynamic_update_slice(x, update, index, axis=0, out=None, name=None):
    """Write ``update`` into ``x`` at position ``index`` (a [1] int
    tensor) along ``axis``. Pass ``out=x`` bound to a persistable var for
    the in-place state-update form the executor threads across runs."""
    helper = LayerHelper("dynamic_update_slice", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="dynamic_update_slice",
        inputs={"X": [x], "Update": [update], "Index": [index]},
        outputs={"Out": [out]},
        attrs={"axis": int(axis)},
    )
    return out


def softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices
