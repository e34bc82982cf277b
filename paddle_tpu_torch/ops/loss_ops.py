"""Loss ops: softmax_with_cross_entropy, cross_entropy.

Counterpart of ``paddle_tpu/ops/loss_ops.py`` for the ops the port runs;
their grads are the registry's ``<type>_grad`` ops.
"""

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
