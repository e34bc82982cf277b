"""Sequence ops over the padded ``[B, T, ...]`` layout with an optional
``Length`` input.

Counterpart of ``paddle_tpu/ops/sequence_ops.py`` (the reference's
sequence_* ops, lod_reset, lod_rank_table and
reorder_lod_tensor_by_rank): every shape is static, row compaction is a
stable sort (``compact_rows``), and no lowering reads a value back to the
host. ``sequence_conv`` is one product over the stacked shifted copies.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype
from paddle_tpu_torch.ops.common import compact_rows, optional_lengths


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


def _mask_from(ins, x):
    """[B, T] validity mask from the optional Length input (None without
    one)."""
    if not ins.get("Length"):
        return None
    lens = ins["Length"][0].reshape(-1)
    return torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]


def _trail(mask, x):
    """``mask`` [B, T] shaped to broadcast against ``x`` [B, T, ...]."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))


def _lower_sequence_softmax(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T]
    mask = _mask_from(ins, x)
    if mask is None:
        return torch.softmax(x, dim=-1)
    masked = torch.where(mask, x, torch.full_like(x, -1e38))
    sm = torch.softmax(masked, dim=-1)
    return torch.where(mask, sm, torch.zeros_like(sm))


register_op(
    "sequence_softmax",
    inputs=["X", "Length"],
    outputs=["Out"],
    lower=_lower_sequence_softmax,
    no_grad_inputs=("Length",),
)


def _lower_sequence_reverse(ctx, ins, attrs):
    x = ins["X"][0]
    if not ins.get("Length"):
        return torch.flip(x, dims=[1])
    lens = ins["Length"][0].reshape(-1).to(torch.int64)
    steps = torch.arange(x.shape[1], device=x.device)[None, :]
    # len - 1 - t on the valid steps, t on the padding
    idx = torch.where(steps < lens[:, None], lens[:, None] - 1 - steps,
                      steps)
    idx = _trail(idx, x).expand(x.shape)
    return torch.gather(x, 1, idx)


register_op(
    "sequence_reverse",
    inputs=["X", "Length"],
    outputs=["Y"],
    lower=_lower_sequence_reverse,
    no_grad_inputs=("Length",),
)


def _lower_sequence_expand(ctx, ins, attrs):
    """Each row of X repeated Y's T times, then flattened: a broadcast,
    not a LoD walk."""
    x = ins["X"][0]
    t = ins["Y"][0].shape[1]
    feat = tuple(x.shape[1:])
    return x[:, None].expand((x.shape[0], t) + feat).reshape((-1,) + feat)


register_op(
    "sequence_expand",
    inputs=["X", "Y"],
    outputs=["Out"],
    attrs={"ref_level": -1},
    lower=_lower_sequence_expand,
    no_grad_inputs=("Y",),
)


def _lower_sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time: the shifted copies of x
    (zero outside the sequence) stacked on the feature axis, then one
    product with the [ctx_len * D, M] filter."""
    x = ins["X"][0]  # [B, T, D]
    filt = ins["Filter"][0]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len // 2)))
    if int(attrs.get("contextStride", 1)) != 1:
        raise NotImplementedError(
            "sequence_conv contextStride != 1 (the reference op enforces "
            "stride 1 as well, sequence_conv_op.cc)")
    t = x.shape[1]
    mask = None
    if ins.get("Length"):
        lens = optional_lengths(ins, x)
        mask = (torch.arange(t, device=x.device)[None, :]
                < lens[:, None]).to(x.dtype)
        x = x * mask[:, :, None]
    steps = torch.arange(t, device=x.device)
    cols = []
    for j in range(ctx_len):
        off = ctx_start + j
        shifted = torch.roll(x, -off, dims=1)
        ok = ((steps + off >= 0) & (steps + off < t))[None, :, None]
        cols.append(torch.where(ok, shifted, torch.zeros_like(shifted)))
    out = torch.cat(cols, dim=2) @ filt  # [B, T, M]
    if mask is not None:
        out = out * mask[:, :, None]
    return {"Out": out}


register_op(
    "sequence_conv",
    inputs=["X", "Filter", "Length"],
    outputs=["Out"],
    attrs={"contextLength": 3, "contextStart": -1, "contextStride": 1},
    lower=_lower_sequence_conv,
    no_grad_inputs=("Length",),
)


def _take_time(x, idx):
    """x [B, T, ...] gathered along time by idx [B, T']."""
    return torch.gather(x, 1, _trail(idx, x).expand(
        tuple(idx.shape) + tuple(x.shape[2:])))


def _lower_sequence_concat(ctx, ins, attrs):
    """Row i of the output is x[i, :lx] ++ y[i, :ly], re-padded to the
    summed T."""
    xs = ins["X"]
    lens = ins.get("Length", [])
    out = xs[0]
    b = out.shape[0]
    out_len = (lens[0].reshape(-1).to(torch.int32) if lens else
               torch.full((b,), out.shape[1], dtype=torch.int32,
                          device=out.device))
    for k, nxt in enumerate(xs[1:], start=1):
        t1, t2 = out.shape[1], nxt.shape[1]
        n_len = (lens[k].reshape(-1).to(torch.int32) if k < len(lens) else
                 torch.full((b,), t2, dtype=torch.int32, device=out.device))
        j = torch.arange(t1 + t2, device=out.device)[None, :]
        from_first = j < out_len[:, None]
        g1 = _take_time(out, torch.clamp(j, 0, t1 - 1).expand(b, -1))
        g2 = _take_time(nxt, torch.clamp(j - out_len[:, None], 0, t2 - 1))
        merged = torch.where(_trail(from_first, g1), g1, g2)
        total = out_len + n_len
        valid = j < total[:, None]
        merged = torch.where(_trail(valid, merged), merged,
                             torch.zeros_like(merged))
        out, out_len = merged, total
    return {"Out": out, "OutLength": out_len[:, None]}


register_op(
    "sequence_concat",
    inputs=["*X", "*Length"],
    outputs=["Out", "OutLength"],
    lower=_lower_sequence_concat,
    no_grad_inputs=("Length",),
    intermediate_outputs=("OutLength",),
)


def _lower_sequence_expand_as(ctx, ins, attrs):
    """Each row of X ([B, D], or [B, 1, D]: its first step) tiled to Y's
    T."""
    x = ins["X"][0]
    t = ins["Y"][0].shape[1]
    if x.dim() == 2:
        return {"Out": x[:, None, :].expand(x.shape[0], t, x.shape[1])}
    return {"Out": x[:, :1, :].expand(x.shape[0], t, x.shape[2])}


register_op(
    "sequence_expand_as",
    inputs=["X", "Y"],
    outputs=["Out"],
    lower=_lower_sequence_expand_as,
    no_grad_inputs=("Y",),
)


def _pad_time(x, n):
    """x [B, T, ...] with n zero steps appended."""
    tail = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=x.dtype,
                       device=x.device)
    return torch.cat([x, tail], dim=1)


def _lower_sequence_pad(ctx, ins, attrs):
    """Re-pad [B, T, ...] to padded_length (truncating too) with PadValue
    past each row's length."""
    x = ins["X"][0]
    pad_value = ins["PadValue"][0].reshape(-1)[0]
    lens = optional_lengths(ins, x)
    padded_len = int(attrs.get("padded_length", -1))
    t = x.shape[1]
    if padded_len > 0 and padded_len != t:
        if padded_len > t:
            x = _pad_time(x, padded_len - t)
        else:
            x = x[:, :padded_len]
        t = padded_len
    lens = torch.clamp_max(lens, t)  # truncation clips row lengths too
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    out = torch.where(_trail(valid, x), x, pad_value.to(x.dtype))
    return {"Out": out,
            "OutLength": lens[:, None].to(device_dtype("int64"))}


register_op(
    "sequence_pad",
    inputs=["X", "PadValue", "Length"],
    outputs=["Out", "OutLength"],
    attrs={"padded_length": -1},
    lower=_lower_sequence_pad,
    no_grad_inputs=("PadValue", "Length"),
    intermediate_outputs=("OutLength",),
)


def _lower_sequence_unpad(ctx, ins, attrs):
    """Zero everything past Length (the padded stand-in for re-packing)."""
    x = ins["X"][0]
    lens = optional_lengths(ins, x)
    valid = torch.arange(x.shape[1], device=x.device)[None, :] \
        < lens[:, None]
    return {"Out": torch.where(_trail(valid, x), x, torch.zeros_like(x))}


register_op(
    "sequence_unpad",
    inputs=["X", "Length"],
    outputs=["Out"],
    lower=_lower_sequence_unpad,
    no_grad_inputs=("Length",),
)


def _lower_sequence_slice(ctx, ins, attrs):
    """Per row the window [offset, offset + length), left-aligned and
    re-padded."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1).to(torch.int64)
    length = ins["Length"][0].reshape(-1).to(torch.int64)
    j = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.clamp(j + offset[:, None], 0, x.shape[1] - 1)
    gathered = _take_time(x, src)
    valid = j < length[:, None]
    return {"Out": torch.where(_trail(valid, gathered), gathered,
                               torch.zeros_like(gathered))}


register_op(
    "sequence_slice",
    inputs=["X", "Offset", "Length"],
    outputs=["Out"],
    lower=_lower_sequence_slice,
    no_grad_inputs=("Offset", "Length"),
)


def _lower_sequence_erase(ctx, ins, attrs):
    """Drop the listed tokens, compact each row left, pad with 0."""
    x = ins["X"][0]  # [B, T] int
    lens = optional_lengths(ins, x)
    keep = torch.arange(x.shape[1], device=x.device)[None, :] \
        < lens[:, None]
    for tok in attrs.get("tokens", []):
        keep = keep & (x != tok)
    out, n_keep = compact_rows(x, keep, 0)
    return {"Out": out, "OutLength": n_keep[:, None]}


register_op(
    "sequence_erase",
    inputs=["X", "Length"],
    outputs=["Out", "OutLength"],
    attrs={"tokens": []},
    lower=_lower_sequence_erase,
    grad=None,
)


def _lower_sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of win_size ids, pad_value past each row's
    length."""
    x = ins["X"][0]  # [B, T] int
    win = int(attrs.get("win_size", 2))
    pad_value = attrs.get("pad_value", 0)
    t = x.shape[1]
    lens = optional_lengths(ins, x)
    ar = torch.arange(t, device=x.device)
    pad = torch.full_like(x, pad_value)
    cols = []
    for j in range(win):
        shifted = x[:, torch.clamp(ar + j, 0, t - 1)]
        ok = (ar + j)[None, :] < lens[:, None]
        cols.append(torch.where(ok, shifted, pad))
    out = torch.stack(cols, dim=2)  # [B, T, win]
    valid = ar[None, :, None] < lens[:, None, None]
    return {"Out": torch.where(valid, out, torch.full_like(out, pad_value))}


register_op(
    "sequence_enumerate",
    inputs=["X", "Length"],
    outputs=["Out"],
    attrs={"win_size": 2, "pad_value": 0},
    lower=_lower_sequence_enumerate,
    grad=None,
)


def _lower_sequence_scatter(ctx, ins, attrs):
    """Per row, Updates added into X at the time steps Ids."""
    x = ins["X"][0]  # [B, T, ...] or [B, T]
    ids = ins["Ids"][0].to(torch.int64)  # [B, N]
    upd = ins["Updates"][0]
    if x.dim() == 3 and upd.dim() == 2:
        upd = upd[..., None]
    shape = tuple(ids.shape) + tuple(x.shape[2:])
    return {"Out": x.scatter_add(1, _trail(ids, x).expand(shape),
                                 upd.expand(shape))}


register_op(
    "sequence_scatter",
    inputs=["X", "Ids", "Updates"],
    outputs=["Out"],
    lower=_lower_sequence_scatter,
    no_grad_inputs=("Ids",),
)


def _lower_sequence_reshape(ctx, ins, attrs):
    """Re-chunk the feature dim: [B, T, D] -> [B, T * D / new_dim,
    new_dim] (the caller scales its Length the same way)."""
    x = ins["X"][0]
    new_dim = attrs["new_dim"]
    b, t, d = x.shape
    if new_dim <= 0 or (t * d) % new_dim != 0:
        raise ValueError(
            "sequence_reshape: T*D = %d not divisible by new_dim %d"
            % (t * d, new_dim))
    return x.reshape(b, (t * d) // new_dim, new_dim)


register_op(
    "sequence_reshape",
    inputs=["X"],
    outputs=["Out"],
    attrs={"new_dim": 1},
    lower=_lower_sequence_reshape,
)


def _lod_rows(target):
    """The static re-segmentation of ``target`` (a LoD offset tuple): the
    [B', T'] source rows, their validity and the lengths, built on the
    host."""
    lens = [e - s for s, e in zip(target[:-1], target[1:])]
    nb, nt = len(lens), max(lens)
    rows = np.zeros((nb, nt), np.int64)
    valid = np.zeros((nb, nt), bool)
    for i, (s, n) in enumerate(zip(target[:-1], lens)):
        rows[i, :n] = np.arange(s, s + n)
        valid[i, :n] = True
    return rows, valid, np.asarray(lens, np.int64)


def _lower_lod_reset(ctx, ins, attrs):
    """Re-segment a padded batch: its B * T rows re-chunked by the static
    target_lod attr into [B', T', ...] with a Length output (the
    reference's reset-from-Y form needs a run-time segmentation)."""
    x = ins["X"][0]
    target = tuple(int(v) for v in attrs.get("target_lod", []))
    if len(target) < 2 or target[0] != 0:
        raise ValueError("lod_reset: invalid target lod %r" % (target,))
    b, t = x.shape[0], x.shape[1]
    feat = tuple(x.shape[2:])
    total = b * t
    if target[-1] != total:
        raise ValueError("lod_reset: target lod covers %d rows, input has %d"
                         % (target[-1], total))
    rows, valid, lens = _lod_rows(target)
    nb, nt = rows.shape
    flat = x.reshape((total,) + feat)
    out = flat[torch.from_numpy(rows.reshape(-1)).to(x.device)].reshape(
        (nb, nt) + feat)
    mask = torch.from_numpy(valid).to(x.device)
    out = out * mask.reshape((nb, nt) + (1,) * len(feat)).to(out.dtype)
    return {"Out": out,
            "Length": torch.from_numpy(lens).to(x.device)[:, None]}


register_op(
    "lod_reset",
    inputs=["X"],
    outputs=["Out", "Length"],
    attrs={"target_lod": []},
    lower=_lower_lod_reset,
    intermediate_outputs=("Length",),
)


def _lower_lod_rank_table(ctx, ins, attrs):
    """A stable descending sort of the lengths: ties keep their order
    (the reference table's rule)."""
    lens = ins["Length"][0].reshape(-1).to(torch.int64)
    order = torch.argsort(-lens, stable=True)
    return {"Index": order, "SortedLength": lens[order]}


register_op(
    "lod_rank_table",
    inputs=["Length"],
    outputs=["Index", "SortedLength"],
    lower=_lower_lod_rank_table,
    grad=None,
)


def _lower_reorder_by_rank(ctx, ins, attrs):
    idx = ins["RankIndex"][0].reshape(-1).to(torch.int64)
    return torch.index_select(ins["X"][0], 0, idx)


register_op(
    "reorder_lod_tensor_by_rank",
    inputs=["X", "RankIndex"],
    outputs=["Out"],
    lower=_lower_reorder_by_rank,
    no_grad_inputs=("RankIndex",),
)
