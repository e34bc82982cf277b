"""Sequence ops: sequence_mask.

Counterpart of ``paddle_tpu/ops/sequence_ops.py`` for the ops this slice
runs.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype


def _lower_sequence_mask(ctx, ins, attrs):
    lens = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen <= 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    steps = torch.arange(maxlen, device=lens.device)
    return (steps[None, :] < lens[:, None]).to(
        device_dtype(attrs.get("out_dtype", "int64")))


register_op(
    "sequence_mask",
    inputs=["X"],
    outputs=["Y"],
    attrs={"maxlen": -1, "out_dtype": "int64"},
    lower=_lower_sequence_mask,
    grad=None,
)
