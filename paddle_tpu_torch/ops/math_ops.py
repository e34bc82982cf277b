"""Dense math ops: mul / elementwise (add, sub, mul, div, min) / sum / scale /
reduce_sum / mean.

Counterpart of ``paddle_tpu/ops/math_ops.py`` for the ops this slice
runs. A plain matrix product goes to ``torch.matmul`` (fp32, TF32 off),
as the JAX package leaves it to XLA.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.ops.common import (
    broadcast_y,
    flatten_to_2d,
    reduce_axes,
    scalar_like,
)


def _lower_mul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    out = flatten_to_2d(x, xn) @ flatten_to_2d(y, yn)
    return out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))


register_op(
    "mul",
    inputs=["X", "Y"],
    outputs=["Out"],
    attrs={"x_num_col_dims": 1, "y_num_col_dims": 1},
    lower=_lower_mul,
)


def _elementwise(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        return fn(x, broadcast_y(x, y, attrs.get("axis", -1)))

    return lower


for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_min", torch.minimum),
]:
    register_op(
        _name,
        inputs=["X", "Y"],
        outputs=["Out"],
        attrs={"axis": -1},
        lower=_elementwise(_fn),
    )


# ``sum`` adds its inputs left to right; backward.py emits it to add up
# the gradient contributions of a variable read more than once
register_op(
    "sum",
    inputs=["*X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: sum(ins["X"][1:], ins["X"][0]),
)


def _lower_scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = scalar_like(attrs.get("scale", 1.0), x)
    bias = scalar_like(attrs.get("bias", 0.0), x)
    if attrs.get("bias_after_scale", True):
        return x * scale + bias
    return (x + bias) * scale


register_op(
    "scale",
    inputs=["X"],
    outputs=["Out"],
    attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True},
    lower=_lower_scale,
)


def _lower_reduce_sum(ctx, ins, attrs):
    x = ins["X"][0]
    axes = reduce_axes(x.dim(), attrs.get("dim", [0]),
                       attrs.get("reduce_all", False))
    out = torch.sum(x, dim=axes, keepdim=attrs.get("keep_dim", False))
    if out.dim() == 0:
        out = out.reshape(1)
    return out


register_op(
    "reduce_sum",
    inputs=["X"],
    outputs=["Out"],
    attrs={"dim": [0], "keep_dim": False, "reduce_all": False},
    lower=_lower_reduce_sum,
)

register_op(
    "mean",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.mean(ins["X"][0]).reshape(1),
)
