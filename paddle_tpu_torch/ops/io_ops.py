"""IO ops: assign_value and random_data_generator.

Counterpart of ``paddle_tpu/ops/io_ops.py`` (its first part; ``print``
and the graph-level ``save`` / ``load`` pair are not ported yet).
``random_data_generator`` draws a synthetic batch on the device from
the op's key, as the JAX package's does: one ``split`` per slot,
``uniform`` for float slots and ``randint`` for integer ones, so both
packages draw the same batch from the same seed.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype


def _lower_assign_value(ctx, ins, attrs):
    dtype = device_dtype(attrs.get("dtype"))
    arr = np.asarray(attrs["values"]).reshape(
        [int(d) for d in attrs["shape"]])
    return torch.as_tensor(arr).to(device=ctx.device, dtype=dtype)


register_op(
    "assign_value",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [], "dtype": "float32", "values": []},
    lower=_lower_assign_value,
    grad=None,
)


def _lower_random_data_generator(ctx, ins, attrs):
    """Float slots ~ U[min, max), integer slots ~ U{int_min, int_max}
    (inclusive); slot ``i`` draws from ``split(key, slots)[i]``, that is
    ``fold_in(key, i)``. Integer slots are drawn as the JAX package's
    int32 and kept in the slot's dtype (int64 stays int64 here)."""
    shape_concat = [int(d) for d in attrs["shape_concat"]]
    ranks = [int(r) for r in attrs["ranks"]]
    dtypes = list(attrs["dtypes"])
    lo, hi = float(attrs.get("min", 0.0)), float(attrs.get("max", 1.0))
    ilo, ihi = int(attrs.get("int_min", 0)), int(attrs.get("int_max", 1))
    key = ctx.rng()
    outs, off = [], 0
    for i, rank in enumerate(ranks):
        shape = tuple(shape_concat[off:off + rank])
        off += rank
        dt = device_dtype(dtypes[i])
        if key is None:
            outs.append(torch.empty(shape, dtype=dt, device=ctx.device))
            continue
        sub = prng.as_chain(key).fold_in(i)
        if dt.is_floating_point:
            outs.append(prng.uniform(sub, shape, lo, hi,
                                     device=ctx.device).to(dt))
        else:
            outs.append(prng.randint(sub, shape, ilo, ihi + 1,
                                     device=ctx.device).to(dt))
    return {"Out": outs}


register_op(
    "random_data_generator",
    inputs=[],
    outputs=["*Out"],
    attrs={"shape_concat": [], "ranks": [], "dtypes": [], "min": 0.0,
           "max": 1.0, "int_min": 0, "int_max": 1},
    lower=_lower_random_data_generator,
    grad=None,
)
