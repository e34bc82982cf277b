"""Activation ops: relu.

Counterpart of ``paddle_tpu/ops/activation_ops.py`` for the ops this
slice runs.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op

register_op(
    "relu",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.relu(ins["X"][0]),
)
