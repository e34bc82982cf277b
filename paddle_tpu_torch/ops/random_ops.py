"""Random ops: uniform_random, gaussian_random and dropout.

Counterpart of ``paddle_tpu/ops/random_ops.py`` for the initializers and
dropout. Each draw uses the op's own ``torch.Generator``
(``LowerContext.rng``), seeded from the run seed and the op's
``__rng_id__``, or from a nonzero ``seed`` attr; a ``dropout_grad`` op
carries its forward's ``__rng_id__``, so it replays the same mask.
Torch's bits are not jax's: parity tests copy parameters across and run
dropout at 0 instead of comparing draws.
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


def _lower_dropout(ctx, ins, attrs):
    """Downgrade-in-infer by default (train: ``x * mask``; test:
    ``x * (1 - p)``); ``upscale_in_train`` scales the kept entries by
    ``1 / (1 - p)`` in training and passes ``x`` through in test."""
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    upscale = attrs.get("dropout_implementation",
                        "downgrade_in_infer") == "upscale_in_train"
    if ctx.is_test:
        return {"Out": x if upscale else x * (1.0 - p),
                "Mask": torch.ones_like(x)}
    keep = torch.rand(x.shape, generator=ctx.rng(),
                      device=x.device) < (1.0 - p)
    mask = keep.to(x.dtype)
    if not upscale:
        out = x * mask
    elif p >= 1.0:
        out = torch.zeros_like(x)
    else:
        out = x * mask / (1.0 - p)
    return {"Out": out, "Mask": mask}


register_op(
    "dropout",
    inputs=["X"],
    outputs=["Out", "Mask"],
    attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0,
           "fix_seed": False,
           "dropout_implementation": "downgrade_in_infer"},
    lower=_lower_dropout,
    intermediate_outputs=("Mask",),
)
