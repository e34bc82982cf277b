"""In-graph metric ops: accuracy.

Counterpart of ``paddle_tpu/ops/metric_ops.py`` for the op this slice
runs (accuracy_op.cc parity): the share of rows whose label is among the
top-k indices.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op


def _lower_accuracy(ctx, ins, attrs):
    indices, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() > 1 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    hit = (indices == label[:, None].to(indices.dtype)).any(dim=1)
    correct = hit.sum().to(torch.int32).reshape(1)
    total = torch.full((1,), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    return {"Accuracy": correct.float() / total.float(), "Correct": correct,
            "Total": total}


register_op(
    "accuracy",
    inputs=["Out", "Indices", "Label"],
    outputs=["Accuracy", "Correct", "Total"],
    lower=_lower_accuracy,
    grad=None,
)
