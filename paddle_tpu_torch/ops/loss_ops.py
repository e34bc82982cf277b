"""Loss ops: softmax_with_cross_entropy, fused_label_smooth_ce,
cross_entropy and the regression and ranking losses
(sigmoid_cross_entropy_with_logits, bce_loss, squared_l2_distance,
squared_l2_norm, smooth_l1_loss, huber_loss, log_loss, hinge_loss,
rank_loss, margin_rank_loss, kldiv_loss, modified_huber_loss).

Counterpart of ``paddle_tpu/ops/loss_ops.py``, every op type of it;
their grads are the registry's ``<type>_grad`` ops, which reach
``FusedLabelSmoothCE``'s own backward for the fused op. A ``max`` with a
constant is ``torch.maximum`` against a tensor of it, whose gradient
splits a tie in halves as ``jnp.maximum``'s does.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.op_registry import register_op


def _lower_softmax_xent(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    log_softmax = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * log_softmax, dim=-1, keepdim=True)
    else:
        if label.dim() > 1 and label.shape[-1] == 1:
            label = label.squeeze(-1)
        lbl = label.to(torch.int64)
        loss = -torch.gather(log_softmax, -1, lbl[..., None])
        ignore = attrs.get("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where((lbl == ignore)[..., None],
                               torch.zeros_like(loss), loss)
    return {"Softmax": torch.exp(log_softmax), "Loss": loss}


register_op(
    "softmax_with_cross_entropy",
    inputs=["Logits", "Label"],
    outputs=["Softmax", "Loss"],
    attrs={"soft_label": False, "ignore_index": -100,
           "numeric_stable_mode": True},
    lower=_lower_softmax_xent,
    no_grad_inputs=("Label",),
    intermediate_outputs=("Softmax",),
)


class FusedLabelSmoothCE(torch.autograd.Function):
    """Label-smoothed cross entropy over the last axis of ``x`` [N, V]
    (paddle_tpu/ops/loss_ops.py:47-107), in the factored identity

        L = lse - (1 - eps) * x_y - (eps / V) * sum_i x_i

    with the max in ``x``'s dtype and the sum of exponentials and the sum
    of the logits accumulated in float32: a float32 [N, 1] loss, and no
    float32 [N, V] tensor when ``x`` is bf16. The backward is the
    reference's one expression, in ``x``'s dtype:

        dL/dx_i = (softmax_i - eps / V - (1 - eps) * 1[i = y]) * g

    The JAX package computes this op outside any Pallas kernel, so these
    are torch ops on the card too (a fused hand kernel is ROADMAP queue B
    work)."""

    @staticmethod
    def forward(ctx, x, label, eps):
        vocab = x.shape[-1]
        m = torch.amax(x, dim=-1, keepdim=True)
        s = torch.exp(x - m).float().sum(dim=-1, keepdim=True)
        lse = m.float() + torch.log(s)
        xy = torch.gather(x, -1, label[..., None]).float()
        sumx = x.float().sum(dim=-1, keepdim=True)
        ctx.save_for_backward(x, label, m, s)
        ctx.eps = eps
        return lse - (1.0 - eps) * xy - (eps / vocab) * sumx

    @staticmethod
    def backward(ctx, g):
        x, label, m, s = ctx.saved_tensors
        eps, vocab = ctx.eps, x.shape[-1]
        # ((softmax - eps/V) - (1-eps) 1[i=y]) g, the reference's order of
        # operations, in place on one [N, V] tensor: the label's term is
        # subtracted at the label only (no one-hot tensor), as the
        # reference's (1 - eps) * onehot, rounded to x's dtype, is there
        dx = torch.exp(x - m)
        dx /= s.to(x.dtype)
        dx -= eps / vocab
        dx.scatter_add_(-1, label[..., None], torch.full(
            label.shape + (1,), -(1.0 - eps), dtype=x.dtype,
            device=x.device))
        dx *= g.to(x.dtype)
        return dx, None, None


def _lower_fused_label_smooth_ce(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    if label.dim() > 1 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return {"Loss": FusedLabelSmoothCE.apply(
        logits, label.to(torch.int64), float(attrs.get("epsilon", 0.0)))}


register_op(
    "fused_label_smooth_ce",
    inputs=["Logits", "Label"],
    outputs=["Loss"],
    attrs={"epsilon": 0.0},
    lower=_lower_fused_label_smooth_ce,
    no_grad_inputs=("Label",),
)


def _lower_cross_entropy(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        return -torch.sum(label * torch.log(torch.clamp_min(x, eps)),
                          dim=-1, keepdim=True)
    if label.dim() > 1 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    p = torch.gather(x, -1, label.to(torch.int64)[..., None])
    return -torch.log(torch.clamp_min(p, eps))


register_op(
    "cross_entropy",
    inputs=["X", "Label"],
    outputs=["Y"],
    attrs={"soft_label": False, "ignore_index": -100},
    lower=_lower_cross_entropy,
    no_grad_inputs=("Label",),
)


def _max(x, c):
    """``jnp.maximum(x, c)`` for a number ``c``, its tie gradient too."""
    return torch.maximum(x, torch.full_like(x, c))


def _rest_axes(t):
    return tuple(range(1, t.dim()))


register_op(
    "sigmoid_cross_entropy_with_logits",
    inputs=["X", "Label"],
    outputs=["Out"],
    attrs={"ignore_index": -100},
    lower=lambda ctx, ins, attrs: _max(ins["X"][0], 0.0)
    - ins["X"][0] * ins["Label"][0]
    + torch.log1p(torch.exp(-torch.abs(ins["X"][0]))),
    no_grad_inputs=("Label",),
)

register_op(
    "bce_loss",
    inputs=["X", "Label"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: -(
        ins["Label"][0] * torch.log(_max(ins["X"][0], 1e-12))
        + (1.0 - ins["Label"][0]) * torch.log(_max(1.0 - ins["X"][0],
                                                   1e-12))),
    no_grad_inputs=("Label",),
)


def _lower_squared_l2_distance(ctx, ins, attrs):
    d = ins["X"][0] - ins["Y"][0]
    return {"sub_result": d,
            "Out": torch.sum(torch.square(d), dim=_rest_axes(d))[..., None]}


register_op(
    "squared_l2_distance",
    inputs=["X", "Y"],
    outputs=["sub_result", "Out"],
    lower=_lower_squared_l2_distance,
    intermediate_outputs=("sub_result",),
)

register_op(
    "squared_l2_norm",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.sum(
        torch.square(ins["X"][0])).reshape(1),
)


def _lower_smooth_l1(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    sigma2 = sigma * sigma
    d = x - y
    if "InsideWeight" in ins:
        d = d * ins["InsideWeight"][0]
    abs_d = torch.abs(d)
    loss = torch.where(abs_d < 1.0 / sigma2, 0.5 * sigma2 * torch.square(d),
                       abs_d - 0.5 / sigma2)
    if "OutsideWeight" in ins:
        loss = loss * ins["OutsideWeight"][0]
    return {"Diff": d,
            "Out": torch.sum(loss, dim=_rest_axes(loss))[..., None]}


register_op(
    "smooth_l1_loss",
    inputs=["X", "Y", "InsideWeight", "OutsideWeight"],
    outputs=["Diff", "Out"],
    attrs={"sigma": 1.0},
    lower=_lower_smooth_l1,
    no_grad_inputs=("InsideWeight", "OutsideWeight"),
    intermediate_outputs=("Diff",),
)


def _lower_huber(ctx, ins, attrs):
    d = ins["Y"][0] - ins["X"][0]
    delta = attrs.get("delta", 1.0)
    abs_d = torch.abs(d)
    loss = torch.where(abs_d <= delta, 0.5 * torch.square(d),
                       delta * (abs_d - 0.5 * delta))
    return {"Residual": d, "Out": loss}


register_op(
    "huber_loss",
    inputs=["X", "Y"],
    outputs=["Residual", "Out"],
    attrs={"delta": 1.0},
    lower=_lower_huber,
    intermediate_outputs=("Residual",),
)


def _lower_log_loss(ctx, ins, attrs):
    p, lbl = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return (-lbl * torch.log(p + eps)
            - (1.0 - lbl) * torch.log(1.0 - p + eps))


register_op(
    "log_loss",
    inputs=["Predicted", "Labels"],
    outputs=["Loss"],
    attrs={"epsilon": 1e-4},
    lower=_lower_log_loss,
    no_grad_inputs=("Labels",),
)

register_op(
    "hinge_loss",
    inputs=["Logits", "Labels"],
    outputs=["Loss"],
    lower=lambda ctx, ins, attrs: torch.maximum(
        torch.zeros_like(ins["Logits"][0]),
        1.0 - (2.0 * ins["Labels"][0] - 1.0) * ins["Logits"][0]),
    no_grad_inputs=("Labels",),
)

register_op(
    "rank_loss",
    inputs=["Label", "Left", "Right"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.log1p(
        torch.exp(ins["Left"][0] - ins["Right"][0]))
    - ins["Label"][0] * (ins["Left"][0] - ins["Right"][0]),
    no_grad_inputs=("Label",),
)


def _lower_margin_rank(ctx, ins, attrs):
    label, x1, x2 = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    z = -label * (x1 - x2) + attrs.get("margin", 0.0)
    out = torch.maximum(torch.zeros_like(z), z)
    return {"Activated": (out > 0).to(x1.dtype), "Out": out}


register_op(
    "margin_rank_loss",
    inputs=["Label", "X1", "X2"],
    outputs=["Activated", "Out"],
    attrs={"margin": 0.0},
    lower=_lower_margin_rank,
    no_grad_inputs=("Label",),
    intermediate_outputs=("Activated",),
)


def _lower_kldiv(ctx, ins, attrs):
    x, t = ins["X"][0], ins["Target"][0]
    loss = t * (torch.log(_max(t, 1e-12)) - x)
    red = attrs.get("reduction", "mean")
    if red == "mean":
        return torch.mean(loss).reshape(1)
    if red == "sum":
        return torch.sum(loss).reshape(1)
    if red == "batchmean":
        # XLA divides by the constant as a product with its float32
        # reciprocal
        return (torch.sum(loss)
                * float(np.float32(1) / np.float32(x.shape[0]))).reshape(1)
    return loss


register_op(
    "kldiv_loss",
    inputs=["X", "Target"],
    outputs=["Loss"],
    attrs={"reduction": "mean"},
    lower=_lower_kldiv,
    no_grad_inputs=("Target",),
)


def _lower_modified_huber_loss(ctx, ins, attrs):
    """modified_huber_loss_op.cc: labels {0, 1} as {-1, +1}; with
    z = (2y - 1) x, max(0, 1 - z)^2 for z >= -1, else -4z."""
    x = ins["X"][0].reshape(-1)
    y = ins["Y"][0].reshape(-1).to(x.dtype)
    z = (2.0 * y - 1.0) * x
    loss = torch.where(z >= -1.0, torch.square(_max(1.0 - z, 0.0)),
                       -4.0 * z)
    shape = (x.shape[0], 1)
    return {"Out": loss.reshape(shape), "IntermediateVal": z.reshape(shape)}


register_op(
    "modified_huber_loss",
    inputs=["X", "Y"],
    outputs=["Out", "IntermediateVal"],
    lower=_lower_modified_huber_loss,
    no_grad_inputs=("Y",),
    intermediate_outputs=("IntermediateVal",),
)
