"""Tensor manipulation ops: fill / assign / reshape / transpose / concat /
gather / lookup_table / one_hot / dynamic_update_slice / top_k.

Counterpart of ``paddle_tpu/ops/tensor_ops.py`` for the ops this slice
runs. Every lowering here is shape-pure (no value is read on the host),
so build-time shape inference runs it on ``meta`` tensors.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype
from paddle_tpu_torch.ops.common import scalar_like


def _lower_fill_constant(ctx, ins, attrs):
    dtype = device_dtype(attrs.get("dtype"))
    out = torch.empty(tuple(attrs["shape"]), dtype=dtype, device=ctx.device)
    # jnp.full truncates a float value for an integer dtype
    return out.fill_(scalar_like(attrs["value"], out))


register_op(
    "fill_constant",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [1], "dtype": "float32", "value": 0.0,
           "force_cpu": False},
    lower=_lower_fill_constant,
    grad=None,
)

# assign copies: ops that update state in place (paged_kv_write,
# dynamic_update_slice onto its own input) must never find a second
# variable name bound to the tensor they write
def _lower_one_hot(ctx, ins, attrs):
    x = ins["X"][0]
    if x.dim() > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    # jax.nn.one_hot's semantics (an id outside [0, depth) gives a zero
    # row), as a comparison: no value is read on the host
    classes = torch.arange(int(attrs["depth"]), device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


register_op(
    "one_hot",
    inputs=["X"],
    outputs=["Out"],
    attrs={"depth": 1},
    lower=_lower_one_hot,
    grad=None,
)

register_op(
    "assign",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: ins["X"][0].clone(),
)


def _lower_reshape(ctx, ins, attrs):
    x = ins["X"][0]
    # Paddle semantics: 0 copies the input dim at that position; -1 infers
    out = [int(x.shape[i]) if d == 0 else int(d)
           for i, d in enumerate(attrs["shape"])]
    return x.reshape(out)


register_op(
    "reshape",
    inputs=["X"],
    outputs=["Out"],
    attrs={"shape": [], "inplace": False},
    lower=_lower_reshape,
)


def _lower_transpose(ctx, ins, attrs):
    x = ins["X"][0]
    perm = attrs["axis"] or list(range(x.dim()))[::-1]
    return x.permute(*perm)


register_op(
    "transpose",
    inputs=["X"],
    outputs=["Out"],
    attrs={"axis": []},
    lower=_lower_transpose,
)

register_op(
    "concat",
    inputs=["*X"],
    outputs=["Out"],
    attrs={"axis": 0},
    lower=lambda ctx, ins, attrs: torch.cat(ins["X"],
                                            dim=attrs.get("axis", 0)),
)


def _take_rows(x, idx):
    """``jnp.take(x, idx, axis=0)``: rows of x picked by an int tensor of
    any shape; the result has shape ``idx.shape + x.shape[1:]``."""
    out = x.index_select(0, idx.reshape(-1).to(torch.int64))
    return out.reshape(tuple(idx.shape) + tuple(x.shape[1:]))


register_op(
    "gather",
    inputs=["X", "Index"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: _take_rows(ins["X"][0], ins["Index"][0]),
    no_grad_inputs=("Index",),
)


def _lower_lookup_table(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = _take_rows(w, ids)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


register_op(
    "lookup_table",
    inputs=["W", "Ids"],
    outputs=["Out"],
    attrs={"is_sparse": False, "is_distributed": False, "padding_idx": -1},
    lower=_lower_lookup_table,
    no_grad_inputs=("Ids",),
)


def _lower_dynamic_update_slice(ctx, ins, attrs):
    """Place Update into X at position Index along ``axis``; the start
    clamps to ``[0, X.shape[axis] - Update.shape[axis]]`` like the XLA
    dynamic-update-slice the reference lowers to. When the op writes its
    result back onto its own input variable (the in-place state
    convention, ``out=x``), X is updated in place: a state row write
    then costs the row, not a copy of the whole state tensor."""
    x = ins["X"][0]
    upd = ins["Update"][0].to(x.dtype)
    axis = int(attrs.get("axis", 0))
    n, u = int(x.shape[axis]), int(upd.shape[axis])
    start = ins["Index"][0].reshape(()).to(torch.int64).clamp(0, max(n - u, 0))
    rows = start + torch.arange(u, device=x.device)
    op = ctx.op
    if op is not None and op.output("Out") == op.input("X"):
        return x.index_copy_(axis, rows, upd)
    return x.index_copy(axis, rows, upd)


register_op(
    "dynamic_update_slice",
    inputs=["X", "Update", "Index"],
    outputs=["Out"],
    attrs={"axis": 0},
    lower=_lower_dynamic_update_slice,
    no_grad_inputs=("Index",),
)


def _lower_top_k(ctx, ins, attrs):
    vals, idx = torch.topk(ins["X"][0], int(attrs.get("k", 1)), dim=-1)
    return {"Out": vals, "Indices": idx}


register_op(
    "top_k",
    inputs=["X"],
    outputs=["Out", "Indices"],
    attrs={"k": 1},
    lower=_lower_top_k,
    intermediate_outputs=("Indices",),
)
