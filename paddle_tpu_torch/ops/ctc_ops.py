"""CTC loss and alignment, and the edit distance.

Counterpart of ``paddle_tpu/ops/ctc_ops.py`` (warpctc_op.cc,
ctc_align_op.cc, edit_distance_op.cc parity), with the same inputs,
outputs and attrs. ``warpctc``'s lattice (log space, ``_NEG = -1e30``)
and gradient run in the port's own kernel (``kernels/ctc.py``, K5
``ctc_loss``: one launch on the card for the loss and dLogits); its
``WarpCTCGrad`` output is zeros, as the JAX op returns it. ``ctc_align``
compacts each row with a stable sort (``compact_rows``), and
``edit_distance`` keeps the JAX op's prefix-min row update
(``ctc_ops.py:141-189``), one row a step in torch ops: it runs only in
evaluation.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.kernels.ctc import ctc_loss
from paddle_tpu_torch.ops.common import compact_rows, optional_lengths


def _lower_warpctc(ctx, ins, attrs):
    logits = ins["Logits"][0]  # [B, T, V] raw activations
    b = logits.shape[0]
    label = ins["Label"][0].reshape(b, -1)
    t_len = optional_lengths(ins, logits, "LogitsLength")
    l_len = optional_lengths(ins, label, "LabelLength")
    loss = ctc_loss(logits, label, t_len, l_len, int(attrs.get("blank", 0)),
                    bool(attrs.get("norm_by_times", False)))
    return {"Loss": loss[:, None], "WarpCTCGrad": torch.zeros_like(logits)}


register_op(
    "warpctc",
    inputs=["Logits", "Label", "LogitsLength", "LabelLength"],
    outputs=["Loss", "WarpCTCGrad"],
    attrs={"blank": 0, "norm_by_times": False},
    lower=_lower_warpctc,
    no_grad_inputs=("Label", "LogitsLength", "LabelLength"),
    intermediate_outputs=("WarpCTCGrad",),
)


def _lower_ctc_align(ctx, ins, attrs):
    x = ins["Input"][0]  # [B, T] int paths
    blank = int(attrs.get("blank", 0))
    b, t = x.shape
    lens = optional_lengths(ins, x, "InputLength")
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=x.dtype,
                                 device=x.device), x[:, :-1]], 1)
    keep = valid & (x != blank) & (x != prev)
    out, n_keep = compact_rows(x, keep, blank)
    return {"Output": out, "OutputLength": n_keep[:, None]}


register_op(
    "ctc_align",
    inputs=["Input", "InputLength"],
    outputs=["Output", "OutputLength"],
    attrs={"blank": 0, "merge_repeated": True},
    lower=_lower_ctc_align,
    grad=None,
)


def _lower_edit_distance(ctx, ins, attrs):
    hyp = ins["Hyps"][0]  # [B, T1] int
    ref = ins["Refs"][0]  # [B, T2] int
    b, t1 = hyp.shape
    t2 = ref.shape[1]
    dev = hyp.device
    h_len = optional_lengths(ins, hyp, "HypsLength")
    r_len = optional_lengths(ins, ref, "RefsLength")
    big = float(t1 + t2 + 1)
    ar2 = torch.arange(t2 + 1, dtype=torch.float32, device=dev)
    # column j > r_len stays at big so it never wins the final gather
    col_valid = torch.arange(t2 + 1, device=dev)[None, :] <= r_len[:, None]
    row = torch.where(col_valid, ar2[None, :], torch.full((), big,
                                                          device=dev))
    big_col = torch.full((b, 1), big, device=dev)
    first = torch.arange(t2 + 1, device=dev)[None, :] == 0
    for i in range(1, t1 + 1):
        sub_cost = (ref != hyp[:, i - 1:i]).to(torch.float32)
        tmp = torch.minimum(row + 1.0, torch.cat([big_col, row[:, :-1]
                                                  + sub_cost], 1))
        tmp = torch.minimum(tmp, torch.where(first, torch.full(
            (), float(i), device=dev), torch.full((), big, device=dev)))
        # insertions run left to right: a prefix-min of (tmp - j)
        shifted = torch.cummin(tmp - ar2[None, :], dim=1).values \
            + ar2[None, :]
        new = torch.minimum(tmp, shifted)
        live = (i <= h_len)[:, None]
        row = torch.where(live & col_valid, new, torch.where(
            live, torch.full((), big, device=dev), row))
    dist = torch.gather(row, 1, r_len[:, None])[:, 0]
    if attrs.get("normalized", False):
        dist = dist / torch.clamp_min(r_len.to(torch.float32), 1.0)
    return {"Out": dist[:, None],
            "SequenceNum": torch.full((1,), b, dtype=torch.int64,
                                      device=dev)}


register_op(
    "edit_distance",
    inputs=["Hyps", "Refs", "HypsLength", "RefsLength"],
    outputs=["Out", "SequenceNum"],
    attrs={"normalized": False},
    lower=_lower_edit_distance,
    grad=None,
)
