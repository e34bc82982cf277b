"""Metric layers: accuracy.

Counterpart of ``paddle_tpu/layers/metric_op.py`` for the layer this
slice calls.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    from paddle_tpu_torch.layers.nn import topk

    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]},
    )
    return acc_out
