"""Random initializer ops: uniform_random and gaussian_random.

Counterpart of ``paddle_tpu/ops/random_ops.py`` for the initializers.
Each draw uses the op's own ``torch.Generator`` (``LowerContext.rng``),
seeded from the run seed and the op id, or from a nonzero ``seed`` attr.
Torch's bits are not jax's: parity tests copy parameters across instead
of comparing draws.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype


def _empty(ctx, attrs):
    return torch.empty(tuple(attrs["shape"]),
                       dtype=device_dtype(attrs.get("dtype")),
                       device=ctx.device)


register_op(
    "uniform_random",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
           "dtype": "float32"},
    lower=lambda ctx, ins, attrs: _empty(ctx, attrs).uniform_(
        attrs.get("min", -1.0), attrs.get("max", 1.0),
        generator=ctx.rng()),
    grad=None,
)

register_op(
    "gaussian_random",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
           "dtype": "float32"},
    lower=lambda ctx, ins, attrs: _empty(ctx, attrs).normal_(
        attrs.get("mean", 0.0), attrs.get("std", 1.0),
        generator=ctx.rng()),
    grad=None,
)
