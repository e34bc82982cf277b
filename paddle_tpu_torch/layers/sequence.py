"""Sequence layers over the padded ``[batch, max_len, ...]`` layout with
an explicit length.

Counterpart of ``paddle_tpu/layers/sequence.py``, with its names,
signatures and ``length=`` arguments.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "sequence_reshape",
    "sequence_pool",
    "sequence_softmax",
    "sequence_reverse",
    "sequence_mask",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_conv",
    "sequence_concat",
    "sequence_expand_as",
    "sequence_pad",
    "sequence_unpad",
    "sequence_slice",
    "sequence_erase",
    "sequence_enumerate",
    "sequence_scatter",
]


def _seq_op(op_type, x, length, out_slot, attrs=None, extra_outputs=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if length is not None:
        inputs["Length"] = [length]
    outputs = {out_slot: [out]}
    for slot in extra_outputs or []:
        outputs[slot] = [
            helper.create_variable_for_type_inference("int32", stop_gradient=True)
        ]
    helper.append_op(type=op_type, inputs=inputs, outputs=outputs, attrs=attrs or {})
    return out


def sequence_pool(input, pool_type, length=None):
    return _seq_op(
        "sequence_pool",
        input,
        length,
        "Out",
        attrs={"pooltype": pool_type.upper()},
        extra_outputs=["MaxIndex"],
    )


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_softmax(input, length=None, use_cudnn=False, name=None):
    return _seq_op("sequence_softmax", input, length, "Out")


def sequence_reverse(x, length=None, name=None):
    return _seq_op("sequence_reverse", x, length, "Y")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="sequence_mask",
        inputs={"X": [x]},
        outputs={"Y": [out]},
        attrs={"maxlen": maxlen if maxlen is not None else -1, "out_dtype": dtype},
    )
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, length=None, bias_attr=None, param_attr=None,
                  act=None):
    """Context-window convolution over time (sequence_conv_op.cc)."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    dtype = input.dtype
    filter_shape = [filter_size * int(input.shape[-1]), num_filters]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype
    )
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [input], "Filter": [filter_param]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_conv",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={
            "contextLength": filter_size,
            "contextStart": -int(filter_size // 2),
            "contextStride": filter_stride,
        },
    )
    pre_act = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_concat(input, lengths=None, name=None):
    """Concatenate valid prefixes along time (sequence_concat_op.cc)."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    out_len = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True
    )
    inputs = {"X": list(input)}
    if lengths is not None:
        inputs["Length"] = list(lengths)
    helper.append_op(
        type="sequence_concat",
        inputs=inputs,
        outputs={"Out": [out], "OutLength": [out_len]},
    )
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand_as",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
    )
    return out


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True
    )
    inputs = {"X": [x], "PadValue": [pad_value]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_pad",
        inputs=inputs,
        outputs={"Out": [out], "OutLength": [out_len]},
        attrs={"padded_length": maxlen if maxlen is not None else -1},
    )
    return out, out_len


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_unpad",
        inputs={"X": [x], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def sequence_erase(input, tokens, length=None, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True
    )
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_erase",
        inputs=inputs,
        outputs={"Out": [out], "OutLength": [out_len]},
        attrs={"tokens": list(tokens)},
    )
    return out, out_len


def sequence_enumerate(input, win_size, pad_value=0, length=None, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True
    )
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="sequence_enumerate",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"win_size": int(win_size), "pad_value": pad_value},
    )
    return out


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]},
    )
    return out


def sequence_reshape(input, new_dim):
    """Re-chunk the trailing feature dim (sequence_reshape_op.cc); on the
    padded layout [B, T, D] -> [B, T*D/new_dim, new_dim]."""
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_reshape",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"new_dim": new_dim},
    )
    return out
