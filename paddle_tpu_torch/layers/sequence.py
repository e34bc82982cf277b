"""Sequence layers: sequence_mask, sequence_pool.

Counterpart of ``paddle_tpu/layers/sequence.py`` for the layers this
slice calls.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["sequence_mask", "sequence_pool"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="sequence_mask",
        inputs={"X": [x]},
        outputs={"Y": [out]},
        attrs={"maxlen": maxlen if maxlen is not None else -1,
               "out_dtype": dtype},
    )
    return out


def sequence_pool(input, pool_type, length=None):
    """Pool each padded sequence ``[B, T, d]`` over its valid steps
    (``length`` ``[B]``; all T when absent): sum, average, sqrt, max,
    last or first."""
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(type="sequence_pool", inputs=inputs,
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    return out
