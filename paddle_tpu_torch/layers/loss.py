"""Loss layers (parts of layers/nn.py + layers/detection.py in fluid).

Counterpart of ``paddle_tpu/layers/loss.py``, every name of its
``__all__`` with its signature.
"""

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "cross_entropy",
    "softmax_with_cross_entropy",
    "fused_label_smooth_ce",
    "sigmoid_cross_entropy_with_logits",
    "square_error_cost",
    "smooth_l1",
    "huber_loss",
    "log_loss",
    "hinge_loss",
    "rank_loss",
    "margin_rank_loss",
    "kldiv_loss",
]


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


def fused_label_smooth_ce(logits, label, epsilon=0.0, name=None):
    """Label-smoothed cross entropy in one fused op over the vocabulary
    axis (ops/loss_ops.py ``fused_label_smooth_ce``): the factored
    smoothing term, the logits kept in their network dtype (bf16 under
    AMP) with float32-accumulated reductions. Returns the float32
    [N, 1] loss. The Transformer's head takes it under
    ``FLAGS_fused_ce``."""
    helper = LayerHelper("fused_label_smooth_ce", name=name)
    loss = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="fused_label_smooth_ce",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Loss": [loss]},
        attrs={"epsilon": float(epsilon)},
    )
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


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index},
    )
    return out


def square_error_cost(input, label):
    """(input - label)^2, elementwise: an ``elementwise_sub`` and a
    ``square``."""
    helper = LayerHelper("square_error_cost")
    diff = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="elementwise_sub",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [diff]},
        attrs={"axis": -1},
    )
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square", inputs={"X": [diff]},
                     outputs={"Out": [out]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    loss = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(
        type="smooth_l1_loss",
        inputs=inputs,
        outputs={"Diff": [diff], "Out": [loss]},
        attrs={"sigma": sigma if sigma is not None else 1.0},
    )
    return loss


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    residual = helper.create_variable_for_type_inference(input.dtype,
                                                         stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input], "Y": [label]},
        outputs={"Residual": [residual], "Out": [out]},
        attrs={"delta": delta},
    )
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="log_loss",
        inputs={"Predicted": [input], "Labels": [label]},
        outputs={"Loss": [out]},
        attrs={"epsilon": epsilon},
    )
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="hinge_loss",
        inputs={"Logits": [input], "Labels": [label]},
        outputs={"Loss": [out]},
    )
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(
        type="rank_loss",
        inputs={"Label": [label], "Left": [left], "Right": [right]},
        outputs={"Out": [out]},
    )
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    act = helper.create_variable_for_type_inference(left.dtype,
                                                    stop_gradient=True)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(
        type="margin_rank_loss",
        inputs={"Label": [label], "X1": [left], "X2": [right]},
        outputs={"Activated": [act], "Out": [out]},
        attrs={"margin": margin},
    )
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="kldiv_loss",
        inputs={"X": [x], "Target": [target]},
        outputs={"Loss": [out]},
        attrs={"reduction": reduction},
    )
    return out
