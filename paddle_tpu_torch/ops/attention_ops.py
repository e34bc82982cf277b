"""Attention ops: scaled_dot_product_attention, grouped_cross_attention,
paged_attention, paged_tree_attention, the paged KV writes and
add_position_encoding.

Counterpart of ``paddle_tpu/ops/attention_ops.py`` for the ops this slice
runs. The attention ops call the hand-written kernels
(``kernels/flash_attention.py``, ``kernels/paged_attention.py``): on a
CUDA tensor they launch the kernel, on a CPU tensor they run its plain
version. ``FLAGS_attention_impl`` / ``FLAGS_paged_attention`` /
``FLAGS_tree_attention`` (or the op's ``impl`` attr) set to
``reference`` are refused for CUDA tensors:
the port has no path from the card to the plain versions.

The paged KV writes (``paged_kv_write``, ``paged_kv_prefill``,
``paged_copy_page``) are XLA scatters in the reference and torch
indexing here. They update the pool tensors IN PLACE: each binds
``KOut``/``VOut`` back onto its pool variables, so the executor's scope
keeps the very tensors that were written, and no per-layer, per-token
copy of a pool is made.
"""

import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.kernels.flash_attention import flash_attention
from paddle_tpu_torch.kernels.paged_attention import (
    paged_attention,
    paged_kv_write,
    paged_tree_attention,
)


def _kernel_impl(attrs, flag, x):
    """The op's ``impl`` attr, or the flag for "auto". ``reference`` on a
    CUDA tensor raises rather than leaving the card's kernel."""
    impl = attrs.get("impl", "auto")
    if impl == "auto":
        impl = flags.get(flag)
    if impl == "reference" and x.device.type == "cuda":
        raise ValueError(
            "FLAGS_%s=reference (or impl='reference') is refused for CUDA "
            "tensors: paddle_tpu_torch runs the hand-written kernel on the "
            "card and has no path there to the plain version" % flag)
    if impl not in ("auto", "pallas", "reference"):
        raise ValueError("FLAGS_%s must be auto, pallas or reference, got "
                         "%r" % (flag, impl))
    return impl


def _same_shape_as_q(block, op):
    q = block._find_var_recursive(op.input("Q")[0])
    for name in op.output("Out"):
        out = block._find_var_recursive(name)
        if out is not None and q is not None:
            out.shape = tuple(q.shape) if q.shape is not None else None
            out.dtype = q.dtype


def _lower_sdpa(ctx, ins, attrs):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]  # [B, H, T|S, d]
    if attrs.get("seq_parallel_axis", ""):
        raise NotImplementedError(
            "scaled_dot_product_attention: seq_parallel_axis (ring "
            "attention) comes with the multi-GPU slice (ROADMAP.md A10)")
    _kernel_impl(attrs, "attention_impl", q)
    mask = ins.get("Mask", [None])[0]
    return flash_attention(
        q, k, v, causal=attrs.get("causal", False),
        sm_scale=attrs.get("sm_scale", 0.0) or None, mask=mask,
        kv_group=int(attrs.get("kv_group", 1)),
        window=int(attrs.get("window", 0)))


register_op(
    "scaled_dot_product_attention",
    inputs=["Q", "K", "V", "Mask"],
    outputs=["Out"],
    attrs={"causal": False, "sm_scale": 0.0, "impl": "auto",
           "seq_parallel_axis": "", "kv_group": 1, "window": 0},
    lower=_lower_sdpa,
    no_grad_inputs=("Mask",),
    infer_shape=_same_shape_as_q,
)


def _lower_paged_attention(ctx, ins, attrs):
    q = ins["Q"][0]  # [S, H, 1, dh]
    _kernel_impl(attrs, "paged_attention", q)
    S = q.shape[0]
    table = ins["PageTable"][0].reshape(S, -1).to(torch.int64).contiguous()
    lengths = ins["Lengths"][0].reshape(-1).to(torch.int64).contiguous()
    out = paged_attention(
        q[:, :, 0, :].contiguous(), ins["KPool"][0], ins["VPool"][0],
        table, lengths, sm_scale=attrs.get("sm_scale", 0.0) or None)
    return out[:, :, None, :]


register_op(
    "paged_attention",
    inputs=["Q", "KPool", "VPool", "PageTable", "Lengths"],
    outputs=["Out"],
    attrs={"sm_scale": 0.0, "impl": "auto"},
    lower=_lower_paged_attention,
    grad=None,
    no_grad_inputs=("PageTable", "Lengths"),
    infer_shape=_same_shape_as_q,
)


def _lower_paged_tree_attention(ctx, ins, attrs):
    """Speculative tree-verify attention: N tree nodes per slot, laid out
    linearly in the slot's write pages, each attending the committed
    prefix plus its own ancestor path (``kernels/paged_attention.py``
    ``paged_tree_attention``). ``FLAGS_tree_attention=reference`` names
    the plain version, which CPU tensors run anyway."""
    q = ins["Q"][0]  # [S, H, N, dh]
    _kernel_impl(attrs, "tree_attention", q)
    S, _, N, _ = q.shape
    table = ins["PageTable"][0].reshape(S, -1).to(torch.int64).contiguous()
    base = ins["BaseLens"][0].reshape(-1).to(torch.int64).contiguous()
    anc = ins["Anc"][0].reshape(S, N, N).to(torch.int64).contiguous()
    return paged_tree_attention(
        q.contiguous(), ins["KPool"][0], ins["VPool"][0], table, base, anc,
        sm_scale=attrs.get("sm_scale", 0.0) or None,
        max_length=int(attrs.get("max_length", 0)) or None)


register_op(
    "paged_tree_attention",
    inputs=["Q", "KPool", "VPool", "PageTable", "BaseLens", "Anc"],
    outputs=["Out"],
    attrs={"sm_scale": 0.0, "impl": "auto", "max_length": 0},
    lower=_lower_paged_tree_attention,
    grad=None,
    no_grad_inputs=("PageTable", "BaseLens", "Anc"),
    infer_shape=_same_shape_as_q,
)


def _lower_grouped_cross_attention(ctx, ins, attrs):
    """Each slot attends over its GROUP's cross K/V row: the group rows
    are gathered to ``[S, H, T_src, dh]`` (the reference's
    ``k_pool[gof]``, attention_ops.py:227-229) and handed to the flash
    kernel with the slot's query rows (one in the decode step, the tree's
    N in the verify step) and the group's key mask."""
    q = ins["Q"][0]  # [S, H, 1 or N, dh]
    _kernel_impl(attrs, "attention_impl", q)
    gof = ins["GroupOf"][0].reshape(-1).to(torch.int64)
    k = ins["KPool"][0].index_select(0, gof)
    v = ins["VPool"][0].index_select(0, gof)
    mask = ins["Mask"][0].index_select(0, gof)  # [S, T_src]
    return flash_attention(q, k, v, mask=mask,
                           sm_scale=attrs.get("sm_scale", 0.0) or None)


register_op(
    "grouped_cross_attention",
    inputs=["Q", "KPool", "VPool", "GroupOf", "Mask"],
    outputs=["Out"],
    attrs={"sm_scale": 0.0, "impl": "auto"},
    lower=_lower_grouped_cross_attention,
    grad=None,
    no_grad_inputs=("GroupOf", "Mask"),
    infer_shape=_same_shape_as_q,
)


def _lower_paged_copy_page(ctx, ins, attrs):
    """``pool[dst] = pool[src]`` for the K and the V pool, in place (the
    copy half of copy-on-write). The source page is read into a new
    tensor first, so ``src == dst`` (the session's trash-page warmup) is
    a no-op."""
    k_pool, v_pool = ins["KPool"][0], ins["VPool"][0]
    src = ins["Src"][0].reshape(1).to(torch.int64)
    dst = ins["Dst"][0].reshape(1).to(torch.int64)
    for pool in (k_pool, v_pool):
        pool.index_copy_(0, dst, pool.index_select(0, src))
    return {"KOut": k_pool, "VOut": v_pool}


register_op(
    "paged_copy_page",
    inputs=["KPool", "VPool", "Src", "Dst"],
    outputs=["KOut", "VOut"],
    lower=_lower_paged_copy_page,
    grad=None,
    no_grad_inputs=("Src", "Dst"),
)


def _lower_paged_kv_prefill(ctx, ins, attrs):
    """A forced prefix's ``[1, H, T, dh]`` K/V rows land in the slot's
    pages in one op, in place: position ``p`` goes to
    ``(page_row[p // page_size], p % page_size)`` when
    ``write_from <= p < len - 1``; every other position (cache-hit and
    pad) routes to the trash page 0."""
    k_pool, v_pool = ins["KPool"][0], ins["VPool"][0]
    k_new, v_new = ins["KNew"][0], ins["VNew"][0]
    row = ins["PageRow"][0].reshape(-1).to(torch.int64)
    wf = ins["WriteFrom"][0].reshape(()).to(torch.int64)
    ln = ins["Len"][0].reshape(()).to(torch.int64)
    ps = k_pool.shape[2]
    p = torch.arange(k_new.shape[2], device=k_pool.device)
    live = (p >= wf) & (p < ln - 1)
    pages = torch.where(live, row[p // ps], torch.zeros_like(p))
    offs = p % ps
    k_pool[pages, :, offs, :] = k_new[0].transpose(0, 1).to(k_pool.dtype)
    v_pool[pages, :, offs, :] = v_new[0].transpose(0, 1).to(v_pool.dtype)
    return {"KOut": k_pool, "VOut": v_pool}


register_op(
    "paged_kv_prefill",
    inputs=["KPool", "VPool", "KNew", "VNew", "PageRow", "WriteFrom",
            "Len"],
    outputs=["KOut", "VOut"],
    lower=_lower_paged_kv_prefill,
    grad=None,
    no_grad_inputs=("PageRow", "WriteFrom", "Len"),
)


def _lower_paged_kv_write(ctx, ins, attrs):
    k_new = ins["KNew"][0]  # [S, H, 1, dh]
    v_new = ins["VNew"][0]
    table = ins["PageTable"][0].reshape(k_new.shape[0], -1)
    k_out, v_out = paged_kv_write(
        ins["KPool"][0], ins["VPool"][0], k_new[:, :, 0, :],
        v_new[:, :, 0, :], table, ins["Pos"][0])
    return {"KOut": k_out, "VOut": v_out}


register_op(
    "paged_kv_write",
    inputs=["KPool", "VPool", "KNew", "VNew", "PageTable", "Pos"],
    outputs=["KOut", "VOut"],
    lower=_lower_paged_kv_write,
    grad=None,
    no_grad_inputs=("PageTable", "Pos"),
)


def _lower_position_encoding(ctx, ins, attrs):
    """Sinusoid position table added to the input [B, T, D], computed in
    float32 as the reference does."""
    x = ins["X"][0]
    T, D = x.shape[1], x.shape[2]
    pos = torch.arange(T, dtype=torch.float32, device=x.device)[:, None]
    i = torch.arange(D // 2, dtype=torch.float32, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * i / D)
    table = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    return alpha * x + beta * table.to(x.dtype)[None, :, :]


register_op(
    "add_position_encoding",
    inputs=["X"],
    outputs=["Out"],
    attrs={"alpha": 1.0, "beta": 1.0},
    lower=_lower_position_encoding,
)
