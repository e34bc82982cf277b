"""Metric layers: accuracy, auc, precision_recall.

Counterpart of ``paddle_tpu/layers/metric_op.py``.
"""

from paddle_tpu_torch import initializer as init_mod
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["accuracy", "auc", "precision_recall"]


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


def auc(input, label, curve="ROC", num_thresholds=200, topk=1, slide_steps=1):
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        name=unique_name.generate("auc.stat_pos"),
        shape=[num_thresholds],
        dtype="int64",
        persistable=True,
        initializer=init_mod.ConstantInitializer(0),
    )
    stat_neg = helper.create_global_variable(
        name=unique_name.generate("auc.stat_neg"),
        shape=[num_thresholds],
        dtype="int64",
        persistable=True,
        initializer=init_mod.ConstantInitializer(0),
    )
    auc_out = helper.create_variable_for_type_inference("float32",
                                                        stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={
            "Predict": [input],
            "Label": [label],
            "StatPos": [stat_pos],
            "StatNeg": [stat_neg],
        },
        outputs={
            "AUC": [auc_out],
            "StatPosOut": [stat_pos],
            "StatNegOut": [stat_neg],
        },
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    return auc_out, [stat_pos, stat_neg]


def precision_recall(input, label, class_number, weights=None):
    """Multi-class precision/recall/F1 with accumulated state
    (precision_recall_op.cc). ``input`` is class probabilities [N, C];
    returns (batch_metrics [6], accum_metrics [6], states [C, 4] persistable)
    where metrics are [macro-P, macro-R, macro-F1, micro-P, micro-R,
    micro-F1] and states accumulate [TP, FP, TN, FN] per class."""
    from paddle_tpu_torch.layers.nn import topk

    helper = LayerHelper("precision_recall")
    max_probs, idx = topk(input, k=1)
    states = helper.create_global_variable(
        name=unique_name.generate("precision_recall.states"),
        shape=[class_number, 4],
        dtype="float32",
        persistable=True,
        initializer=init_mod.ConstantInitializer(0),
    )
    batch_metrics = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    accum_metrics = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    inputs = {
        "MaxProbs": [max_probs],
        "Indices": [idx],
        "Labels": [label],
        "StatesInfo": [states],
    }
    if weights is not None:
        inputs["Weights"] = [weights]
    helper.append_op(
        type="precision_recall",
        inputs=inputs,
        outputs={
            "BatchMetrics": [batch_metrics],
            "AccumMetrics": [accum_metrics],
            "AccumStatesInfo": [states],
        },
        attrs={"class_number": class_number},
    )
    return batch_metrics, accum_metrics, states
