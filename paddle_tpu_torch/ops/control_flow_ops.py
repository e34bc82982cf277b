"""Control-flow ops: increment.

Counterpart of ``paddle_tpu/ops/control_flow_ops.py`` for the ops this
slice runs.
"""

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.ops.common import scalar_like

register_op(
    "increment",
    inputs=["X"],
    outputs=["Out"],
    attrs={"step": 1.0},
    lower=lambda ctx, ins, attrs: ins["X"][0] + scalar_like(
        attrs.get("step", 1.0), ins["X"][0]),
    grad=None,
)
