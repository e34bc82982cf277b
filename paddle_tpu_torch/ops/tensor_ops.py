"""Tensor manipulation ops: fill / cast / reshape / transpose / concat /
split / squeeze / stack / expand / slice / crop / gather / scatter / pad
/ one_hot / lookup_table / top_k / argsort / arg_max / range / hash /
dynamic_update_slice.

Counterpart of ``paddle_tpu/ops/tensor_ops.py``, every op type it
registers. Every lowering here is shape-pure (no value is read on the
host), so build-time shape inference runs it on ``meta`` tensors. Index
outputs are int64 (the JAX package's are int32: x64 is off there).
"""

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype
from paddle_tpu_torch.ops.common import normalize_axis, scalar_like


def _full(shape, value, dtype, device):
    out = torch.empty(tuple(shape), dtype=device_dtype(dtype), device=device)
    # jnp.full truncates a float value for an integer dtype
    return out.fill_(scalar_like(value, out))


register_op(
    "fill_constant",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [1], "dtype": "float32", "value": 0.0,
           "force_cpu": False},
    lower=lambda ctx, ins, attrs: _full(attrs["shape"], attrs["value"],
                                        attrs.get("dtype"), ctx.device),
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


def _lower_fill_batch_like(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = int(
        ref.shape[attrs.get("input_dim_idx", 0)])
    return _full(shape, attrs["value"], attrs.get("dtype"), ref.device)


register_op(
    "fill_constant_batch_size_like",
    inputs=["Input"],
    outputs=["Out"],
    attrs={"shape": [1], "dtype": "float32", "value": 0.0,
           "input_dim_idx": 0, "output_dim_idx": 0},
    lower=_lower_fill_batch_like,
    grad=None,
)

register_op(
    "fill_zeros_like",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.zeros_like(ins["X"][0]),
    grad=None,
)


def _lower_fill(ctx, ins, attrs):
    """fill_op.cc: an explicit value list as a tensor of the attr shape
    and dtype."""
    vals = torch.as_tensor(np.asarray(attrs["value"], np.float64),
                           device=ctx.device).to(
                               device_dtype(attrs.get("dtype")))
    return vals.reshape(tuple(attrs["shape"]))


register_op(
    "fill",
    inputs=[],
    outputs=["Out"],
    attrs={"value": [], "shape": [], "dtype": "float32", "force_cpu": False},
    lower=_lower_fill,
    grad=None,
)

register_op(
    "cast",
    inputs=["X"],
    outputs=["Out"],
    attrs={"in_dtype": "float32", "out_dtype": "float32"},
    lower=lambda ctx, ins, attrs: ins["X"][0].to(
        device_dtype(attrs["out_dtype"])),
)

register_op(
    "shape",
    inputs=["Input"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.tensor(
        list(ins["Input"][0].shape), dtype=torch.int32,
        device=ins["Input"][0].device),
    grad=None,
)


def _xshape(x):
    """The ``*2`` ops' XShape output: an empty tensor whose shape after
    its leading 0 is the input's, as the JAX package makes it."""
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


def _with_xshape(fn):
    return lambda ctx, ins, attrs: {"Out": fn(ctx, ins, attrs),
                                    "XShape": _xshape(ins["X"][0])}


register_op(
    "reshape2",
    inputs=["X"],
    outputs=["Out", "XShape"],
    attrs={"shape": []},
    lower=_with_xshape(_lower_reshape),
    intermediate_outputs=("XShape",),
)

register_op(
    "transpose2",
    inputs=["X"],
    outputs=["Out", "XShape"],
    attrs={"axis": []},
    lower=_with_xshape(_lower_transpose),
    intermediate_outputs=("XShape",),
)


def _lower_split(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0)
    if int(x.shape[axis]) % num:
        raise ValueError("split: dim %d of size %d does not divide into %d "
                         "equal parts" % (axis, int(x.shape[axis]), num))
    return {"Out": list(torch.split(x, int(x.shape[axis]) // num,
                                    dim=axis))}


def _split_grad_maker(op, out_grads, wanted):
    # d(split)/dX = concat of output grads (pieces with no downstream
    # gradient arrive zero-filled by backward.py's maker path)
    return [{"type": "concat",
             "inputs": {"X": out_grads["Out"]},
             "outputs": {"Out": wanted["X"]},
             "attrs": {"axis": op.attrs.get("axis", 0)}}]


register_op(
    "split",
    inputs=["X"],
    outputs=["*Out"],
    attrs={"axis": 0, "num": 0, "sections": []},
    lower=_lower_split,
    grad=_split_grad_maker,
)


def _squeeze(x, axes):
    if not axes:
        return torch.squeeze(x)
    axes = tuple(normalize_axis(a, x.dim(), "squeeze axis") for a in axes)
    return torch.squeeze(x, dim=tuple(a for a in axes if x.shape[a] == 1))


def _unsqueeze(x, axes):
    """jnp.expand_dims: the axes name positions of the output, a negative
    one counted from the output's end."""
    out_nd = x.dim() + len(axes)
    where = sorted(normalize_axis(a, out_nd, "unsqueeze axis")
                   for a in axes)
    if len(set(where)) != len(where):
        raise ValueError("unsqueeze: repeated axis in %s" % (axes,))
    shape = list(x.shape)
    for a in where:
        shape.insert(a, 1)
    return x.reshape(shape)


def _flatten(x, axis):
    rows = 1
    for d in x.shape[:axis]:
        rows *= int(d)
    return x.reshape(rows, -1)


for _name, _fn, _attr, _default in [
        ("squeeze", _squeeze, "axes", []),
        ("unsqueeze", _unsqueeze, "axes", []),
        ("flatten", _flatten, "axis", 1)]:
    _lower = (lambda f, a, dv: lambda ctx, ins, attrs: f(
        ins["X"][0], attrs.get(a, dv)))(_fn, _attr, _default)
    register_op(_name, inputs=["X"], outputs=["Out"],
                attrs={_attr: _default}, lower=_lower)
    register_op(_name + "2", inputs=["X"], outputs=["Out", "XShape"],
                attrs={_attr: _default}, lower=_with_xshape(_lower),
                intermediate_outputs=("XShape",))

register_op(
    "stack",
    inputs=["*X"],
    outputs=["Y"],
    attrs={"axis": 0},
    lower=lambda ctx, ins, attrs: torch.stack(ins["X"],
                                              dim=attrs.get("axis", 0)),
)


def _unstack_grad_maker(op, out_grads, wanted):
    # pieces without a downstream gradient arrive zero-filled
    return [{"type": "stack",
             "inputs": {"X": out_grads["Y"]},
             "outputs": {"Y": wanted["X"]},
             "attrs": {"axis": op.attrs.get("axis", 0)}}]


register_op(
    "unstack",
    inputs=["X"],
    outputs=["*Y"],
    attrs={"axis": 0, "num": 0},
    lower=lambda ctx, ins, attrs: {
        "Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))},
    grad=_unstack_grad_maker,
)

register_op(
    "expand",
    inputs=["X"],
    outputs=["Out"],
    attrs={"expand_times": []},
    # jnp.tile's semantics, which torch's tile shares
    lower=lambda ctx, ins, attrs: ins["X"][0].tile(
        tuple(attrs["expand_times"])),
)


def _lower_slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return x[tuple(idx)]


register_op(
    "slice",
    inputs=["Input"],
    outputs=["Out"],
    attrs={"axes": [], "starts": [], "ends": []},
    lower=_lower_slice,
)


def _lower_crop(ctx, ins, attrs):
    """lax.dynamic_slice: each start clamps so the window fits."""
    x = ins["X"][0]
    idx = []
    for d, off, size in zip(x.shape, attrs["offsets"], attrs["shape"]):
        st = min(max(int(off), 0), int(d) - int(size))
        idx.append(slice(st, st + int(size)))
    return x[tuple(idx)]


register_op(
    "crop",
    inputs=["X"],
    outputs=["Out"],
    attrs={"offsets": [], "shape": []},
    lower=_lower_crop,
)


def _lower_scatter(ctx, ins, attrs):
    """``X.at[Ids].set(Updates)`` (``.add`` without overwrite)."""
    x, ids = ins["X"][0], ins["Ids"][0].to(torch.int64)
    upd = ins["Updates"][0].to(x.dtype)
    return x.index_put((ids,), upd,
                       accumulate=not attrs.get("overwrite", True))


register_op(
    "scatter",
    inputs=["X", "Ids", "Updates"],
    outputs=["Out"],
    attrs={"overwrite": True},
    lower=_lower_scatter,
    no_grad_inputs=("Ids",),
)


def _torch_pads(pairs):
    """[(lo, hi)] per dim, first dim first, as F.pad takes them: last
    dim first, flattened."""
    out = []
    for lo, hi in reversed(pairs):
        out += [int(lo), int(hi)]
    return out


def _lower_pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return F.pad(x, _torch_pads(pairs), value=attrs.get("pad_value", 0.0))


register_op(
    "pad",
    inputs=["X"],
    outputs=["Out"],
    attrs={"paddings": [], "pad_value": 0.0},
    lower=_lower_pad,
)


def _lower_pad2d(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    mode = attrs.get("mode", "constant")
    pads = _torch_pads([(p[0], p[1]), (p[2], p[3])])
    if mode == "constant":
        out = F.pad(x, pads, value=attrs.get("pad_value", 0.0))
    else:
        # jnp.pad's "reflect" and "edge"
        out = F.pad(x, pads, mode={"reflect": "reflect",
                                   "edge": "replicate"}[mode])
    return out.permute(0, 2, 3, 1) if nhwc else out


register_op(
    "pad2d",
    inputs=["X"],
    outputs=["Out"],
    attrs={"paddings": [0, 0, 0, 0], "mode": "constant", "pad_value": 0.0,
           "data_format": "NCHW"},
    lower=_lower_pad2d,
)


def _lower_pad_constant_like(ctx, ins, attrs):
    """Pad Y up to X's shape on the high side of every dim
    (pad_constant_like_op.cc, which enforces X.dims >= Y.dims)."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() != y.dim():
        raise ValueError(
            "pad_constant_like: rank mismatch (X %dd vs Y %dd)"
            % (x.dim(), y.dim()))
    pairs = []
    for d, (xd, yd) in enumerate(zip(x.shape, y.shape)):
        if int(yd) > int(xd):
            raise ValueError(
                "pad_constant_like: Y dim %d (%d) exceeds X dim (%d)"
                % (d, int(yd), int(xd)))
        pairs.append((0, int(xd) - int(yd)))
    return F.pad(y, _torch_pads(pairs), value=attrs.get("pad_value", 0.0))


register_op(
    "pad_constant_like",
    inputs=["X", "Y"],
    outputs=["Out"],
    attrs={"pad_value": 0.0},
    lower=_lower_pad_constant_like,
    no_grad_inputs=("X",),
)


def _lower_argsort(ctx, ins, attrs):
    vals, idx = torch.sort(ins["X"][0], dim=attrs.get("axis", -1),
                           stable=True)
    return {"Out": vals, "Indices": idx}


register_op(
    "argsort",
    inputs=["X"],
    outputs=["Out", "Indices"],
    attrs={"axis": -1},
    lower=_lower_argsort,
    grad=None,
)

# torch.argmax / argmin return the first of tied indices, as jnp's do
register_op(
    "arg_max",
    inputs=["X"],
    outputs=["Out"],
    attrs={"axis": 0},
    lower=lambda ctx, ins, attrs: torch.argmax(ins["X"][0],
                                               dim=attrs.get("axis", 0)),
    grad=None,
)

register_op(
    "arg_min",
    inputs=["X"],
    outputs=["Out"],
    attrs={"axis": 0},
    lower=lambda ctx, ins, attrs: torch.argmin(ins["X"][0],
                                               dim=attrs.get("axis", 0)),
    grad=None,
)

register_op(
    "reverse",
    inputs=["X"],
    outputs=["Out"],
    attrs={"axis": []},
    lower=lambda ctx, ins, attrs: torch.flip(ins["X"][0],
                                             dims=tuple(attrs["axis"])),
)

register_op(
    "range",
    inputs=[],
    outputs=["Out"],
    attrs={"start": 0, "end": 1, "step": 1, "dtype": "int64"},
    lower=lambda ctx, ins, attrs: torch.arange(
        attrs["start"], attrs["end"], attrs["step"],
        dtype=device_dtype(attrs.get("dtype", "int64")), device=ctx.device),
    grad=None,
)


def _lower_batched_gather(ctx, ins, attrs):
    """out[n, s] = X[n, Index[n, s]]; negative indices (padding) clamp to
    row 0."""
    x = ins["X"][0]  # [N, A, ...]
    idx = ins["Index"][0].to(torch.int64).clamp_min(0)  # [N, S]
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.take_along_dim(
        x, idx.expand(tuple(idx.shape[:2]) + tuple(x.shape[2:])), dim=1)


register_op(
    "batched_gather",
    inputs=["X", "Index"],
    outputs=["Out"],
    lower=_lower_batched_gather,
    no_grad_inputs=("Index",),
)

_U32 = 0xFFFFFFFF


def _mul_u32(h, c):
    """``h * c`` mod 2**32 for uint32 values held in int64 lanes: c split
    in 16-bit halves, so no product leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + ((h * hi) & 0xFFFF) * 65536) & _U32


def _mix(h):
    """The JAX package's murmur3-finalizer mixer on uint32 lanes."""
    h = _mul_u32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul_u32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def _lower_hash(ctx, ins, attrs):
    """hash_op.cc's contract (num_hash hashes of each input row, mod
    mod_by) with the JAX package's mixer, bucket for bucket: its uint32
    arithmetic emulated in int64 lanes."""
    x = ins["X"][0]
    num_hash = attrs.get("num_hash", 1)
    mod_by = attrs.get("mod_by", 100000)
    if not 0 < mod_by <= 2 ** 31 - 1:
        raise ValueError(
            "hash: mod_by %d out of the int32 bucket range (TPU x32 "
            "config); use mod_by <= 2**31-1" % mod_by)
    rows = x.reshape(int(x.shape[0]), -1).to(torch.int64) & _U32
    outs = []
    for slot in range(num_hash):
        h = torch.full((int(rows.shape[0]),),
                       (slot * 0x9E3779B9 + 1) & _U32, dtype=torch.int64,
                       device=x.device)
        for j in range(int(rows.shape[1])):
            h = _mix(h ^ rows[:, j])
        outs.append(h % mod_by)
    return torch.stack(outs, dim=1)[:, :, None]  # [N, num_hash, 1]


register_op(
    "hash",
    inputs=["X"],
    outputs=["Out"],
    attrs={"num_hash": 1, "mod_by": 100000},
    lower=_lower_hash,
    grad=None,
)
