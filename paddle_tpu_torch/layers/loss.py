"""Loss layers: softmax_with_cross_entropy, cross_entropy.

Counterpart of ``paddle_tpu/layers/loss.py`` for the layers this slice
calls.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["softmax_with_cross_entropy", "cross_entropy"]


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "numeric_stable_mode": numeric_stable_mode},
    )
    if return_softmax:
        return loss, softmax
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out
