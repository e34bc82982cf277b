"""Sequence layers: sequence_mask.

Counterpart of ``paddle_tpu/layers/sequence.py`` for the layers this
slice calls.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["sequence_mask"]


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
