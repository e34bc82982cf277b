"""Neural-network ops: layer_norm.

Counterpart of ``paddle_tpu/ops/nn_ops.py`` for the ops this slice runs.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op


def _lower_layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = float(attrs.get("epsilon", 1e-5))
    axes = tuple(range(begin, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": y, "Mean": mean.reshape(lead), "Variance": var.reshape(lead)}


register_op(
    "layer_norm",
    inputs=["X", "Scale", "Bias"],
    outputs=["Y", "Mean", "Variance"],
    attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
    lower=_lower_layer_norm,
    intermediate_outputs=("Mean", "Variance"),
)
