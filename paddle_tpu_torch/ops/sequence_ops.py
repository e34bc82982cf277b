"""Sequence ops: sequence_mask, sequence_pool.

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


def _lower_sequence_pool(ctx, ins, attrs):
    x = ins["X"][0]  # [batch, max_len, d]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    mask = None
    if ins.get("Length"):
        lens = ins["Length"][0].reshape(-1)
        mask = torch.arange(x.shape[1], device=x.device)[None, :] \
            < lens[:, None]
        m = mask[..., None].to(x.dtype)
        count = torch.clamp_min(m.sum(dim=1), 1.0)
    else:
        m = torch.ones_like(x[..., :1])
        count = float(x.shape[1])
    if ptype == "SUM":
        out = (x * m).sum(dim=1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(dim=1) / count
    elif ptype == "SQRT":
        out = (x * m).sum(dim=1) / count ** 0.5
    elif ptype == "MAX":
        # padded steps take the -1e38 sentinel; amax splits the gradient
        # among ties as jnp.max does
        out = torch.amax(torch.where(m > 0, x, torch.full_like(x, -1e38)),
                         dim=1)
    elif ptype == "LAST":
        if mask is not None:
            idx = torch.clamp_min(mask.to(torch.int64).sum(dim=1) - 1, 0)
            out = torch.gather(x, 1, idx[:, None, None].expand(
                -1, 1, x.shape[2]))[:, 0]
        else:
            out = x[:, -1]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %s" % ptype)
    return {"Out": out, "MaxIndex": torch.zeros((1,), dtype=torch.int32,
                                                device=x.device)}


register_op(
    "sequence_pool",
    inputs=["X", "Length"],
    outputs=["Out", "MaxIndex"],
    attrs={"pooltype": "AVERAGE"},
    lower=_lower_sequence_pool,
    no_grad_inputs=("Length",),
    intermediate_outputs=("MaxIndex",),
)
