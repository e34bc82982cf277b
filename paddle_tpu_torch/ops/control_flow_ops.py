"""Comparison and logical ops, increment, is_empty and where_select.

Counterpart of ``paddle_tpu/ops/control_flow_ops.py`` for its elementwise
ops (the sub-block ops are A11's). The comparisons broadcast as numpy
does and ignore their ``axis`` attr, as the JAX package's do.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.ops.common import scalar_like

for _name, _fn in [
        ("less_than", torch.lt),
        ("less_equal", torch.le),
        ("greater_than", torch.gt),
        ("greater_equal", torch.ge),
        ("equal", torch.eq),
        ("not_equal", torch.ne)]:
    register_op(
        _name,
        inputs=["X", "Y"],
        outputs=["Out"],
        attrs={"axis": -1},
        lower=(lambda f: lambda ctx, ins, attrs: f(ins["X"][0],
                                                   ins["Y"][0]))(_fn),
        grad=None,
    )

for _name, _fn in [
        ("logical_and", torch.logical_and),
        ("logical_or", torch.logical_or),
        ("logical_xor", torch.logical_xor)]:
    register_op(
        _name,
        inputs=["X", "Y"],
        outputs=["Out"],
        lower=(lambda f: lambda ctx, ins, attrs: f(ins["X"][0],
                                                   ins["Y"][0]))(_fn),
        grad=None,
    )

register_op(
    "logical_not",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.logical_not(ins["X"][0]),
    grad=None,
)

register_op(
    "increment",
    inputs=["X"],
    outputs=["Out"],
    attrs={"step": 1.0},
    lower=lambda ctx, ins, attrs: ins["X"][0] + scalar_like(
        attrs.get("step", 1.0), ins["X"][0]),
    grad=None,
)

register_op(
    "is_empty",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.full(
        (1,), ins["X"][0].numel() == 0, dtype=torch.bool,
        device=ins["X"][0].device),
    grad=None,
)


def _lower_where_select(ctx, ins, attrs):
    """Batch-element select: Cond [batch, 1] picks X rows, else Y rows
    (the dense merge behind the IfElse layer)."""
    x, y = ins["X"][0], ins["Y"][0]
    c = ins["Cond"][0].reshape((-1,) + (1,) * (x.dim() - 1)).to(torch.bool)
    return torch.where(c, x, y)


register_op(
    "where_select",
    inputs=["Cond", "X", "Y"],
    outputs=["Out"],
    lower=_lower_where_select,
    no_grad_inputs=("Cond",),
)
