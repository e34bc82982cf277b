"""Control-flow layers: increment.

Counterpart of ``paddle_tpu/layers/control_flow.py`` for the layers this
slice calls.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["increment"]


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(
        x.dtype)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out
