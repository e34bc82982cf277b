"""Loss ops: softmax_with_cross_entropy.

Counterpart of ``paddle_tpu/ops/loss_ops.py`` for the ops this slice
runs. Only the forward is ported; the training slice adds the grads.
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
