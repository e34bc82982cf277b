"""Ragged paged-attention decode: a hand-written CUDA kernel and its plain
PyTorch version, plus the pool write and the page accounting.

Counterpart of ``paddle_tpu/kernels/paged_attention.py``. The KV cache is
a page pool ``[num_pages, H, page_size, dh]`` shared by every slot
through a per-slot page table ``[S, pages_per_slot]``; a length vector
``[S]`` says how many tokens each slot holds. ``paged_attention``
launches ``csrc/paged_decode.cu`` (which replaces the TPU's
``_paged_decode_kernel``) for CUDA tensors and runs
``paged_attention_plain`` for CPU tensors, and for nothing else. The JAX
package's once-per-process fallback to its reference path
(paged_attention.py:50-91) is deliberately not carried over: a kernel
that fails here raises.

``paged_kv_write`` updates the pools IN PLACE (the JAX version returns
new pools): the executor binds the result back onto the same scope
variables, and writing in place saves a whole pool copy per layer per
token.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels.build import Kernel

NEG_INF = -1e30
MASKED_ROW_M = -1e29
MAX_HEAD_DIM = 128

PAGED_DECODE = Kernel("paddle_paged_decode_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p,
])


def pages_for(length, page_size):
    """Pages a slot with ``length`` resident tokens occupies."""
    return -(-int(length) // int(page_size))


def paged_attention_plain(q, k_pool, v_pool, page_table, lengths,
                          sm_scale=None):
    """The kernel's function in plain PyTorch: gather each slot's pages
    through the table into ``[S, H, npp * page_size, dh]``, mask
    positions at or past the slot's length, softmax, weighted sum.
    q ``[S, H, dh]``; returns ``[S, H, dh]``; a length-0 slot gives 0."""
    S, H, dh = q.shape
    ps = k_pool.shape[2]
    npp = page_table.shape[1]
    if sm_scale is None:
        sm_scale = dh ** -0.5
    table = page_table.to(torch.int64)
    ks = k_pool[table].permute(0, 2, 1, 3, 4).reshape(S, H, npp * ps, dh)
    vs = v_pool[table].permute(0, 2, 1, 3, 4).reshape(S, H, npp * ps, dh)
    s = torch.einsum("shd,shtd->sht", q.float() * sm_scale, ks.float())
    pos = torch.arange(npp * ps, device=q.device)[None, None, :]
    valid = pos < lengths.to(torch.int64).reshape(S, 1, 1)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("sht,shtd->shd", p, vs.float())
    dead = (lengths.reshape(S) <= 0)[:, None, None]
    return torch.where(dead, torch.zeros_like(out), out).to(q.dtype)


def _check(q, k_pool, v_pool, page_table, lengths):
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError("paged_attention: %s is on %s; the kernel "
                             "needs every input on one CUDA device"
                             % (name, t.device))
        if not t.is_contiguous():
            raise ValueError("paged_attention: %s must be contiguous"
                             % name)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.float32:
            raise TypeError("paged_attention: %s is %s; this kernel takes "
                            "float32 only" % (name, t.dtype))
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int64:
            raise TypeError("paged_attention: %s must be int64, got %s"
                            % (name, t.dtype))
    S, H, dh = q.shape
    if (k_pool.dim() != 4 or k_pool.shape != v_pool.shape
            or k_pool.shape[1] != H or k_pool.shape[3] != dh
            or page_table.dim() != 2 or page_table.shape[0] != S
            or tuple(lengths.shape) != (S,)):
        raise ValueError(
            "paged_attention: shapes q %s, pools %s, table %s, lengths %s "
            "do not fit q [S,H,dh], pools [P,H,ps,dh], table [S,npp], "
            "lengths [S]" % (tuple(q.shape), tuple(k_pool.shape),
                             tuple(page_table.shape), tuple(lengths.shape)))
    if dh > MAX_HEAD_DIM:
        raise ValueError("paged_attention: head dim %d > %d is not "
                         "supported" % (dh, MAX_HEAD_DIM))


def paged_attention(q, k_pool, v_pool, page_table, lengths, sm_scale=None):
    """Ragged paged-attention decode. q ``[S, H, dh]`` (one query token
    per slot); k_pool/v_pool ``[P, H, page_size, dh]``; page_table
    ``[S, npp]`` and lengths ``[S]`` int64. Returns ``[S, H, dh]``; a
    length-0 slot returns exactly 0. CPU tensors run
    :func:`paged_attention_plain`; CUDA tensors launch the
    ``paged_decode`` kernel or raise."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table,
                                     lengths, sm_scale)
    _check(q, k_pool, v_pool, page_table, lengths)
    S, H, dh = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    PAGED_DECODE.launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        S, H, int(k_pool.shape[2]), dh, int(page_table.shape[1]),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_kv_write(k_pool, v_pool, k_new, v_new, page_table, positions):
    """O(page) cache write, IN PLACE: each slot's new K/V row
    (``k_new``/``v_new`` ``[S, H, dh]``) lands at page
    ``table[s, pos // page_size]``, offset ``pos % page_size``. Slots
    whose row points at the trash page (page 0) all write there; with
    duplicate indices the surviving row is arbitrary, which is harmless
    because no slot with a nonzero length reads page 0. Returns the
    (updated) pools."""
    ps = k_pool.shape[2]
    S = k_new.shape[0]
    pos = positions.reshape(-1).to(torch.int64)
    rows = torch.arange(S, device=pos.device)
    page_ids = page_table.to(torch.int64)[rows, pos // ps]
    offsets = pos % ps
    k_pool[page_ids, :, offsets, :] = k_new.to(k_pool.dtype)
    v_pool[page_ids, :, offsets, :] = v_new.to(v_pool.dtype)
    return k_pool, v_pool


def grid_accounting(lengths, page_size, num_heads, head_dim,
                    max_length, itemsize=4, num_groups=None,
                    n_layer=1, src_length=None):
    """The decode kernel's device-memory traffic from its own loop
    bounds: one K page and one V page per RESIDENT page, plus the
    ``[S, H, dh]`` query and output rows. ``dense_hbm_bytes`` is what a
    dense slot pool moves for the same step (every slot's full
    ``[H, max_length, dh]`` K and V). With ``num_groups`` set it also
    prices the group-pooled cross-attention K/V per layer. A copy of the
    JAX package's ``grid_accounting``."""
    lengths = [int(x) for x in lengths]
    S = len(lengths)
    page_bytes = num_heads * int(page_size) * head_dim * itemsize
    valid_pages = sum(pages_for(ln, page_size) for ln in lengths)
    total_page_slots = S * pages_for(max_length, page_size)
    qo_bytes = 2 * S * num_heads * head_dim * itemsize
    kv_bytes = 2 * valid_pages * page_bytes
    dense_kv = 2 * S * num_heads * int(max_length) * head_dim * itemsize
    out = {
        "valid_pages": valid_pages,
        "total_page_slots": total_page_slots,
        "page_bytes": page_bytes,
        "hbm_bytes": kv_bytes + qo_bytes,
        "dense_hbm_bytes": dense_kv + qo_bytes,
        "resident_tokens": sum(lengths),
        "dense_tokens": S * int(max_length),
    }
    if num_groups is not None:
        t_src = int(src_length if src_length is not None else max_length)
        cross_row = 2 * num_heads * t_src * head_dim * itemsize
        out["cross_hbm_bytes"] = int(n_layer) * int(num_groups) * cross_row
        out["cross_dense_hbm_bytes"] = int(n_layer) * S * cross_row
    return out
