"""Core NN layers.

Counterpart of ``paddle_tpu/layers/nn.py`` for the layers this slice
calls, with the reference's names, signatures and parameter naming.
"""

import math

import numpy as np

from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers.ops import log, relu  # noqa: F401  (re-export)
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
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "matmul",
    "batch_norm",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "scale",
    "reshape",
    "transpose",
    "gather",
    "relu",
    "log",
    "softmax",
    "mean",
    "topk",
    "random_crop",
    "lrn",
    "split",
    "squeeze",
    "unsqueeze",
    "flatten",
    "stack",
    "unstack",
    "expand",
    "slice",
    "shape",
    "batched_gather",
    "scatter",
    "pad",
    "pad2d",
    "hash",
    "conv3d",
    "conv2d_transpose",
    "conv3d_transpose",
    "depthwise_conv2d",
    "pool3d",
    "group_norm",
    "l2_normalize",
    "prelu",
    "image_resize",
    "resize_bilinear",
    "image_resize_short",
    "im2sequence",
    "cos_sim",
    "multiplex",
    "bilinear_tensor_product",
    "mean_iou",
    "dice_loss",
    "autoincreased_step_counter",
    "affine_channel",
    "affine_grid",
    "grid_sampler",
    "lod_reset",
    "fake_quantize_abs_max",
    "sequence_expand",
    "Print",
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
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def _reduce_layer(op_type):
    def fn(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            attrs = {"dim": [dim] if isinstance(dim, int) else list(dim),
                     "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    fn.__name__ = op_type
    return fn


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Batch norm with its moving statistics as persistable vars
    (nn.py:399): MeanOut / VarianceOut are bound to the same names, and
    the executor writes the new tensors back into the scope."""
    from paddle_tpu_torch import unique_name

    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channels = int(input.shape[1] if data_layout == "NCHW"
                   else input.shape[-1])
    scale = helper.create_parameter(
        attr=helper.param_attr, shape=[channels], dtype=dtype,
        default_initializer=init_mod.ConstantInitializer(1.0))
    bias = helper.create_parameter(
        attr=helper.bias_attr or ParamAttr(), shape=[channels], dtype=dtype,
        is_bias=True)
    mean = helper.create_global_variable(
        name=moving_mean_name or unique_name.generate(helper.name + ".mean"),
        shape=[channels], dtype=dtype, persistable=True,
        initializer=init_mod.ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name or unique_name.generate(
            helper.name + ".var"),
        shape=[channels], dtype=dtype, persistable=True,
        initializer=init_mod.ConstantInitializer(1.0))
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


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


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both", name=None):
    """Debug print of a tensor when the op runs (print_op.cc surface):
    the message (default: the input's name), then the value."""
    helper = LayerHelper("print", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="print", inputs={"In": [input]},
                     outputs={"Out": [out]},
                     attrs={"message": message or input.name})
    return out


def random_crop(x, shape, seed=None, name=None):
    """Random crop of the trailing dims to ``shape`` (random_crop_op.cc).
    The op draws from the program's threefry stream; a ``seed`` pins
    it (fix_seed semantics) and is also threaded as the Seed tensor."""
    from paddle_tpu_torch.layers import tensor as tensor_layers

    helper = LayerHelper("random_crop", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    seed_var = tensor_layers.fill_constant(
        shape=[1], dtype="int64", value=int(seed or 0))
    seed_out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="random_crop",
        inputs={"X": [x], "Seed": [seed_var]},
        outputs={"Out": [out], "SeedOut": [seed_out]},
        attrs={"shape": list(shape), "seed": int(seed or 0)},
    )
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    from paddle_tpu_torch.ops.common import normalize_axis

    helper = LayerHelper("split", name=name)
    dim = normalize_axis(dim, len(input.shape), "split dim")
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num if num else len(sections))]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "num": num, "sections": sections})
    return outs


def _x_to_out(op_type, x, attrs, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    return _x_to_out("squeeze", input, {"axes": list(axes)}, name)


def unsqueeze(input, axes, name=None):
    return _x_to_out("unsqueeze", input, {"axes": list(axes)}, name)


def flatten(x, axis=1, name=None):
    return _x_to_out("flatten", x, {"axis": axis}, name)


def expand(x, expand_times, name=None):
    return _x_to_out("expand", x, {"expand_times": list(expand_times)},
                     name)


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": list(x)},
                     outputs={"Y": [out]}, attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = int(x.shape[axis])
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]},
                     outputs={"Y": outs}, attrs={"axis": axis, "num": num})
    return outs


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32",
                                                    stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def batched_gather(input, index):
    """Per-batch gather along dim 1: out[n, s] = input[n, index[n, s]];
    negative indices (padding) clamp to row 0."""
    helper = LayerHelper("batched_gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="batched_gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings),
                            "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value),
                            "data_format": data_format})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    """num_hash integer hashes per input row, mod hash_size
    (hash_op.cc)."""
    helper = LayerHelper("hash", name=name)
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="hash", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"num_hash": num_hash, "mod_by": hash_size})
    return out


def _triple(v):
    return [v, v, v] if isinstance(v, int) else list(v)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None, name=None):
    """3-D convolution over NCDHW (nn.py:264)."""
    helper = LayerHelper("conv3d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    num_channels = int(input.shape[1])
    filter_shape = [num_filters, num_channels // groups] + _triple(
        filter_size)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv3d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _triple(stride), "paddings": _triple(padding),
               "dilations": _triple(dilation), "groups": groups},
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def depthwise_conv2d(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    """A convolution with one group per input channel (nn.py:296)."""
    helper = LayerHelper("depthwise_conv2d", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_filters, 1] + _pair(filter_size),
        dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="depthwise_conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation),
               "groups": int(input.shape[1])},
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def _conv_transpose_layer(op_type, nd, input, num_filters, output_size,
                          filter_size, padding, stride, dilation, groups,
                          param_attr, bias_attr, act, name):
    helper = LayerHelper(op_type, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    groups = groups or 1
    if filter_size is None:
        raise ValueError("filter_size must be given for %s" % op_type)
    spread = _pair if nd == 2 else _triple
    filter_shape = [int(input.shape[1]), num_filters // groups] + spread(
        filter_size)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    if output_size is not None and isinstance(output_size, int):
        output_size = [output_size] * nd
    helper.append_op(
        type=op_type,
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": spread(stride), "paddings": spread(padding),
               "dilations": spread(dilation), "groups": groups,
               "output_size": list(output_size or [])},
    )
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """2-D transposed convolution (nn.py:326); the filter ``[in_c,
    num_filters / groups, kh, kw]``."""
    return _conv_transpose_layer(
        "conv2d_transpose", 2, input, num_filters, output_size, filter_size,
        padding, stride, dilation, groups, param_attr, bias_attr, act, name)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, act=None, name=None):
    """3-D transposed convolution (nn.py:1199)."""
    return _conv_transpose_layer(
        "conv3d_transpose", 3, input, num_filters, output_size, filter_size,
        padding, stride, dilation, groups, param_attr, bias_attr, act, name)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    """NCDHW 3-D pooling (nn.py:1008)."""
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool3d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _triple(pool_size),
               "strides": _triple(pool_stride),
               "paddings": _triple(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive},
    )
    return out


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    """Group normalization (nn.py:519): scale (ones) and bias
    ``[channels]``."""
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    channels = int(input.shape[1])
    s = helper.create_parameter(
        attr=helper.param_attr, shape=[channels], dtype=dtype,
        default_initializer=init_mod.ConstantInitializer(1.0))
    b = helper.create_parameter(
        attr=helper.bias_attr or ParamAttr(), shape=[channels], dtype=dtype,
        is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="group_norm",
        inputs={"X": [input], "Scale": [s], "Bias": [b]},
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "groups": groups},
    )
    return helper.append_activation(out)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op(
        type="l2_normalize",
        inputs={"X": [x]},
        outputs={"Out": [out], "Norm": [norm]},
        attrs={"axis": axis, "epsilon": epsilon},
    )
    return out


def prelu(x, mode, param_attr=None, name=None):
    """PReLU with one alpha (``all``), one a channel or one an element
    (nn.py:911), alpha initialised to 0.25."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [int(x.shape[1])]
    else:
        alpha_shape = [int(d) for d in x.shape[1:]]
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=init_mod.ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="prelu",
        inputs={"X": [x], "Alpha": [alpha]},
        outputs={"Out": [out]},
        attrs={"mode": mode},
    )
    return out


def image_resize(input, out_shape=None, scale=None, resample="BILINEAR",
                 name=None):
    """bilinear_interp or nearest_interp to ``out_shape`` or ``scale``
    times the input (nn.py:937)."""
    helper = LayerHelper("image_resize", name=name)
    if out_shape is None:
        h = int(int(input.shape[2]) * scale)
        w = int(int(input.shape[3]) * scale)
    else:
        h, w = int(out_shape[0]), int(out_shape[1])
    op_type = ("bilinear_interp" if resample.upper() == "BILINEAR"
               else "nearest_interp")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"out_h": h, "out_w": w},
    )
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, "BILINEAR", name)


def image_resize_short(input, out_short_len, resample="BILINEAR",
                       name=None):
    """Resize so the short side is ``out_short_len``, keeping the aspect
    ratio; the long side rounds half up, as the reference does
    (nn.py:1310)."""
    in_h, in_w = int(input.shape[2]), int(input.shape[3])
    if in_h < in_w:
        out_h = out_short_len
        out_w = int(in_w * out_short_len / float(in_h) + 0.5)
    else:
        out_w = out_short_len
        out_h = int(in_h * out_short_len / float(in_w) + 0.5)
    return image_resize(input, out_shape=[out_h, out_w], resample=resample,
                        name=name)


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """Each filter-sized patch a row, ``[N * oh * ow, C * kh * kw]``
    (nn.py:960); ``padding`` of 2 (up and left, repeated) or 4."""
    helper = LayerHelper("im2sequence", name=name)
    p = _pair(padding)
    if len(p) == 2:
        p = p + p
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="im2sequence",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"kernels": _pair(filter_size), "strides": _pair(stride),
               "paddings": p},
    )
    return out


def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity (cos_sim_op.cc); Y may be [1, D]."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(
        type="cos_sim",
        inputs={"X": [X], "Y": [Y]},
        outputs={"Out": [out], "XNorm": [xnorm], "YNorm": [ynorm]},
    )
    return out


def multiplex(inputs, index, name=None):
    """Row-wise select among candidate tensors (multiplex_op.cc)."""
    helper = LayerHelper("multiplex", name=name)
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(
        type="multiplex",
        inputs={"Ids": [index], "X": list(inputs)},
        outputs={"Out": [out]},
    )
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out_k = x^T W_k y (bilinear_tensor_product_op.cc) with a learned
    ``[size, Mx, My]`` weight, an optional ``[1, size]`` bias and
    activation."""
    helper = LayerHelper("bilinear_tensor_product", name=name,
                         param_attr=param_attr, bias_attr=bias_attr, act=act)
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, x.shape[-1], y.shape[-1]],
                                dtype=x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if helper.bias_attr is not None:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=x.dtype,
            is_bias=True)]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def mean_iou(input, label, num_classes, name=None):
    """Segmentation mean IoU (mean_iou_op.cc): (mean IoU, wrong,
    correct), the last two for streaming accumulation."""
    helper = LayerHelper("mean_iou", name=name)
    miou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int32")
    correct = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="mean_iou",
        inputs={"Predictions": [input], "Labels": [label]},
        outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                 "OutCorrect": [correct]},
        attrs={"num_classes": num_classes},
    )
    return miou, wrong, correct


def dice_loss(input, label, epsilon=1e-5, name=None):
    """Dice loss (nn.py:1279): integer class labels one-hot over the last
    dim of ``input``, float labels taken as masks; over the last dim,
    then the mean over samples."""
    from paddle_tpu_torch.layers import tensor as tensor_layers

    if str(label.dtype).startswith("int"):
        label = one_hot(label, depth=int(input.shape[-1]))
        if len(label.shape) > len(input.shape):
            label = squeeze(label, axes=[len(input.shape) - 1])
    label = tensor_layers.cast(label, input.dtype)
    reduce_dim = len(input.shape) - 1
    inse = reduce_sum(elementwise_mul(input, label), dim=reduce_dim)
    denominator = elementwise_add(reduce_sum(input, dim=reduce_dim),
                                  reduce_sum(label, dim=reduce_dim))
    dice_score = scale(
        elementwise_div(scale(inse, scale=2.0), elementwise_add(
            denominator, tensor_layers.fill_constant([1], input.dtype,
                                                     epsilon))),
        scale=-1.0, bias=1.0)
    return reduce_mean(dice_score)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A persistable step counter incremented once a run (nn.py:1327),
    on the LR schedulers' counter machinery."""
    from paddle_tpu_torch.layers import learning_rate_scheduler as lrs

    return lrs._global_step_counter(
        counter_name=counter_name or "@STEP_COUNTER@", begin=begin,
        step=step)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None):
    """Per-channel affine (nn.py:1033): out = scale_c * x + bias_c, the
    conv + frozen-BN idiom. Without scale / bias, per-channel parameters
    are created (1 and 0: the identity until trained)."""
    helper = LayerHelper("affine_channel", name=name)
    channels = int(x.shape[1] if data_layout == "NCHW" else x.shape[-1])
    if scale is None:
        scale = helper.create_parameter(
            attr=None, shape=[channels], dtype=x.dtype,
            default_initializer=init_mod.ConstantInitializer(1.0))
    if bias is None:
        bias = helper.create_parameter(
            attr=None, shape=[channels], dtype=x.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="affine_channel",
        inputs={"X": [x], "Scale": [scale], "Bias": [bias]},
        outputs={"Out": [out]},
        attrs={"data_layout": data_layout})
    return out


def affine_grid(theta, out_shape, name=None):
    """Affine sampling grid of a spatial transformer (nn.py:1060);
    out_shape is static."""
    helper = LayerHelper("affine_grid", name=name)
    out = helper.create_variable_for_type_inference(theta.dtype)
    if not isinstance(out_shape, (list, tuple)):
        raise TypeError("affine_grid: out_shape must be a static list/tuple "
                        "(XLA needs static shapes)")
    helper.append_op(
        type="affine_grid",
        inputs={"Theta": [theta]},
        outputs={"Output": [out]},
        attrs={"output_shape": list(out_shape)})
    return out


def grid_sampler(x, grid, name=None):
    """Bilinear sampling of x at normalized grid coordinates
    (nn.py:1077)."""
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="grid_sampler",
        inputs={"X": [x], "Grid": [grid]},
        outputs={"Output": [out]})
    return out


def lod_reset(x, target_lod=None, name=None):
    """Re-segment a padded sequence batch (nn.py:1161): (out, length),
    the re-chunked [B', T', ...] tensor and its Length column. The
    segmentation is the static target_lod."""
    if not target_lod:
        raise ValueError(
            "lod_reset: target_lod is required (the reference's "
            "runtime-Y segmenter cannot exist under static XLA shapes)")
    helper = LayerHelper("lod_reset", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="lod_reset",
        inputs={"X": [x]},
        outputs={"Out": [out], "Length": [length]},
        attrs={"target_lod": list(target_lod)})
    return out, length


def fake_quantize_abs_max(x, bit_length=8, name=None):
    """QAT fake quantization (nn.py:1184): (quantized, scale); gradients
    pass straight through the rounding."""
    helper = LayerHelper("fake_quantize_abs_max", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    scale = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="fake_quantize_abs_max",
        inputs={"X": [x]},
        outputs={"Out": [out], "OutScale": [scale]},
        attrs={"bit_length": bit_length})
    return out, scale


def sequence_expand(x, y, ref_level=-1, name=None):
    """Each row of x repeated across y's time dimension, then flattened
    (nn.py:1338; y supplies max_len)."""
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"ref_level": ref_level})
    return out
