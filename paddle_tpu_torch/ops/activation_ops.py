"""Activation ops: relu, log_softmax, sigmoid, tanh and softmax.

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

register_op(
    "log_softmax",
    inputs=["X"],
    outputs=["Out"],
    attrs={"axis": -1},
    lower=lambda ctx, ins, attrs: torch.log_softmax(
        ins["X"][0], dim=attrs.get("axis", -1)),
)

for _name, _fn in (("sigmoid", torch.sigmoid), ("tanh", torch.tanh)):
    register_op(_name, inputs=["X"], outputs=["Out"],
                lower=lambda ctx, ins, attrs, fn=_fn: fn(ins["X"][0]))

register_op(
    "softmax",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.softmax(ins["X"][0], dim=-1),
)
