"""Ragged paged-attention decode and speculative tree verify: two
hand-written CUDA kernels, each beside its plain PyTorch version, plus the
pool writes and the page accounting.

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

``paged_tree_attention`` scores the N nodes of a speculation tree per
slot (the anchor token plus the drafted ones, laid out linearly in the
slot's write pages) in one call: it launches ``csrc/tree_decode.cu``
(which replaces the TPU's ``_tree_decode_kernel``) for CUDA tensors and
runs ``paged_tree_attention_plain`` for CPU tensors, and for nothing else.
The JAX package's once-per-process switch of the tree kernel to its
reference (``_trip_tree_fallback``, paged_attention.py:110, and the
``try/except`` at :510-518) is deliberately not carried over either.

``paged_plan`` and ``tree_plan`` choose the two kernels' split of each
slot's pages across blocks from static shapes only (never from
``lengths`` or ``base_lens``, which only the device reads), so a call
needs no host sync and a CUDA graph can hold it. The tree kernel runs on
the split-KV core of ``csrc/decode_split.cuh`` (plan helpers in
``kernels/decode_split.py``), which carries the decode kernel's design.

``paged_kv_write``, ``paged_kv_write_block`` and ``paged_kv_compact``
update the pools IN PLACE (the JAX versions return new pools): the
executor binds the result back onto the same scope variables, and writing
in place saves a whole pool copy per layer per token.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels import decode_split
from paddle_tpu_torch.kernels.build import Kernel, device_limits, library

NEG_INF = -1e30
MASKED_ROW_M = -1e29
MAX_HEAD_DIM = 128

PAGED_DECODE = Kernel("paddle_paged_decode_f32", [ctypes.c_void_p] * 7 + [
    ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])

# csrc/paged_decode.cu's block: threads, keys per staged chunk, warps
PAGED_THREADS = 128
PAGED_CHUNK = 32
BLOCKS_PER_SM = 4   # blocks of a decode call the plan aims at per SM
# q, pools, table, base_lens, anc, out, part; S, H, N, ps, dh, npp,
# max_len, splits, pps; sm_scale; stream
TREE_DECODE = Kernel("paddle_tree_decode_f32", [ctypes.c_void_p] * 8 + [
    ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])


def pages_for(length, page_size):
    """Pages a slot with ``length`` resident tokens occupies."""
    return -(-int(length) // int(page_size))


def paged_plan(S, H, npp, ps, dh, n_sm, smem_limit):
    """The ``paged_decode`` kernel's split of each slot's ``npp`` pages
    (of ``ps`` keys) across blocks, from static shapes only: ``splits``
    blocks a (slot, head), each over ``pages_per_split`` consecutive
    pages (the last split may have fewer; none is empty). Aims at
    ``BLOCKS_PER_SM`` blocks an SM of ``n_sm`` over the S x H pairs, with
    at least two staged chunks of keys a split (the double buffer has
    something to overlap). Also ``threads`` and ``smem`` (bytes a block:
    two stages of K and V chunks of ``PAGED_CHUNK`` rows of dh rounded
    up to 4, the chunk's scores and the warps' sums), which
    ``chip_smoke.py`` holds to the kernel's own
    (``paddle_paged_layout``)."""
    if min(S, H, npp, ps, dh) < 1 or dh > MAX_HEAD_DIM:
        raise ValueError("paged_plan: S %d, H %d, npp %d, page_size %d, "
                         "dh %d out of range" % (S, H, npp, ps, dh))
    want = -(-BLOCKS_PER_SM * n_sm // (S * H))
    most = max(1, npp * ps // (2 * PAGED_CHUNK))
    pps = -(-npp // max(1, min(want, most, npp)))
    dhp = -(-dh // 4) * 4
    smem = 4 * (4 * PAGED_CHUNK * dhp + PAGED_CHUNK + PAGED_THREADS // 32)
    if smem > smem_limit:
        raise ValueError("paged_plan: %d bytes of shared memory a block "
                         "exceed the limit %d" % (smem, smem_limit))
    return dict(splits=-(-npp // pps), pages_per_split=pps,
                threads=PAGED_THREADS, smem=smem)


def tree_plan(S, H, N, npp, ps, dh, n_sm, smem_limit):
    """The ``tree_decode`` kernel's split of each slot's ``npp`` pages
    (of ``ps`` keys) across blocks, from static shapes only (never from
    ``base_lens``): ``paged_plan``'s rule over the S x H pairs with
    ``decode_split.BLOCKS_PER_SM`` blocks an SM (one split at the verify
    shape), each block carrying the N nodes of its slot, 8 at most a
    walk. Also ``threads`` and ``smem`` (bytes a block: the core's for
    ``decode_split.rows_for(N)`` rows, plus the slot's N x N node mask
    rounded up to 16 bytes), which ``chip_smoke.py`` holds to the
    kernel's own (``paddle_tree_layout``)."""
    if min(S, H, N, npp, ps, dh) < 1 or dh > MAX_HEAD_DIM:
        raise ValueError("tree_plan: S %d, H %d, N %d, npp %d, page_size "
                         "%d, dh %d out of range" % (S, H, N, npp, ps, dh))
    pps = decode_split.items_per_split(S * H, npp, ps, n_sm)
    smem = (decode_split.smem_bytes(dh, decode_split.rows_for(N))
            + -(-N * N // 16) * 16)
    decode_split.check_smem("tree_plan", smem, smem_limit)
    return dict(splits=-(-npp // pps), pages_per_split=pps,
                threads=decode_split.THREADS, smem=smem)


def kernel_paged_layout(dh):
    """``(threads, smem)`` of csrc/paged_decode.cu's block at head dim
    ``dh`` (its ``paddle_paged_layout``; host code: needs the built
    library, not a card), or None where the kernel refuses ``dh``."""
    fn = library().paddle_paged_layout
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(2)]
    rc = fn(dh, *[ctypes.byref(o) for o in out])
    return None if rc else tuple(o.value for o in out)


def kernel_tree_layout(dh, N):
    """``(threads, smem)`` of csrc/tree_decode.cu's block at head dim
    ``dh`` and ``N`` nodes (its ``paddle_tree_layout``; host code: needs
    the built library, not a card), or None where the kernel refuses
    them."""
    fn = library().paddle_tree_layout
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(2)]
    rc = fn(dh, N, *[ctypes.byref(o) for o in out])
    return None if rc else tuple(o.value for o in out)


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


def _check_tensors(who, floats, ints):
    """What both kernels ask of their inputs: every tensor on one CUDA
    device and contiguous, ``floats`` float32, ``ints`` int64. Both are
    lists of (name, tensor); the first float is the query."""
    device = floats[0][1].device
    for name, t in floats + ints:
        if t.device != device or t.device.type != "cuda":
            raise ValueError("%s: %s is on %s; the kernel needs every input "
                             "on one CUDA device" % (who, name, t.device))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (who, name))
    for name, t in floats:
        if t.dtype != torch.float32:
            raise TypeError("%s: %s is %s; this kernel takes float32 only"
                            % (who, name, t.dtype))
    for name, t in ints:
        if t.dtype != torch.int64:
            raise TypeError("%s: %s must be int64, got %s"
                            % (who, name, t.dtype))
    dh = floats[0][1].shape[-1]
    if dh > MAX_HEAD_DIM:
        raise ValueError("%s: head dim %d > %d is not supported"
                         % (who, dh, MAX_HEAD_DIM))


def _check(q, k_pool, v_pool, page_table, lengths):
    _check_tensors("paged_attention",
                   [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)],
                   [("page_table", page_table), ("lengths", lengths)])
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
    if q.numel() == 0:
        return torch.empty_like(q)
    plan = paged_plan(S, H, int(page_table.shape[1]), int(k_pool.shape[2]),
                      dh, *device_limits(q.device))
    splits = plan["splits"]
    out = torch.empty_like(q)
    # the splits' partials (m, l, acc), merged by the kernel's second
    # launch
    part = (torch.empty(S * H * splits * (dh + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    PAGED_DECODE.launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, S, H,
        int(k_pool.shape[2]), dh, int(page_table.shape[1]), splits,
        plan["pages_per_split"], float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
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


def paged_tree_attention_plain(q, k_pool, v_pool, page_table, base_lens,
                               anc, sm_scale=None, max_length=None):
    """The tree kernel's function in plain PyTorch. Each slot holds
    ``base_lens[s]`` committed rows at storage positions ``0..base-1``
    and N tree nodes at ``base..base+N-1`` (node 0 is the anchor). Query
    node ``n`` sees every committed row, and tree row ``j`` where
    ``anc[s, n, j]`` is nonzero (the mask carries the diagonal) and the
    row's storage position lies below ``max_length``. Gathers each
    slot's pages into ``[S, H, npp * page_size, dh]``, masks, softmax,
    weighted sum.

    q ``[S, H, N, dh]``; base_lens ``[S]`` (-1 marks a finished slot: no
    visible key, output exactly 0); anc ``[S, N, N]``. Returns
    ``[S, H, N, dh]``."""
    S, H, N, dh = q.shape
    ps = k_pool.shape[2]
    npp = page_table.shape[1]
    L = npp * ps
    if sm_scale is None:
        sm_scale = dh ** -0.5
    if max_length is None:
        max_length = L
    table = page_table.to(torch.int64)
    ks = k_pool[table].permute(0, 2, 1, 3, 4).reshape(S, H, L, dh)
    vs = v_pool[table].permute(0, 2, 1, 3, 4).reshape(S, H, L, dh)
    s = torch.einsum("shnd,shtd->shnt", q.float() * sm_scale, ks.float())
    t = torch.arange(L, device=q.device)[None, :]            # [1, L]
    base = base_lens.to(torch.int64).reshape(S, 1)            # [S, 1]
    tj = t - base                                             # [S, L]
    in_tree = (tj >= 0) & (tj < N) & (t < int(max_length)) & (base >= 0)
    idx = tj.clamp(0, N - 1)[:, None, :].expand(S, N, L)
    anc_g = torch.gather(anc.reshape(S, N, N) > 0, 2, idx)    # [S, N, L]
    visible = (t < base)[:, None, :] | (in_tree[:, None, :] & anc_g)
    vis4 = visible[:, None, :, :]                             # [S,1,N,L]
    s = torch.where(vis4, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("shnt,shtd->shnd", p, vs.float())
    dead = ~vis4.any(dim=-1, keepdim=True)
    return torch.where(dead, torch.zeros_like(out), out).to(q.dtype)


def _check_tree(q, k_pool, v_pool, page_table, base_lens, anc):
    _check_tensors("paged_tree_attention",
                   [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)],
                   [("page_table", page_table), ("base_lens", base_lens),
                    ("anc", anc)])
    if q.dim() != 4:
        raise ValueError("paged_tree_attention: q must be [S,H,N,dh], got %s"
                         % (tuple(q.shape),))
    S, H, N, dh = q.shape
    if (k_pool.dim() != 4 or k_pool.shape != v_pool.shape
            or k_pool.shape[1] != H or k_pool.shape[3] != dh
            or page_table.dim() != 2 or page_table.shape[0] != S
            or tuple(base_lens.shape) != (S,)
            or tuple(anc.shape) != (S, N, N)):
        raise ValueError(
            "paged_tree_attention: shapes q %s, pools %s, table %s, "
            "base_lens %s, anc %s do not fit q [S,H,N,dh], pools "
            "[P,H,ps,dh], table [S,npp], base_lens [S], anc [S,N,N]"
            % (tuple(q.shape), tuple(k_pool.shape), tuple(page_table.shape),
               tuple(base_lens.shape), tuple(anc.shape)))


def paged_tree_attention(q, k_pool, v_pool, page_table, base_lens, anc,
                         sm_scale=None, max_length=None):
    """Speculative tree verify over the paged pool: one call scores all N
    tree nodes of every slot against its committed rows plus the node's
    own root path (:func:`paged_tree_attention_plain` states the layout).
    q ``[S, H, N, dh]``; pools ``[P, H, page_size, dh]``; page_table
    ``[S, npp]``, base_lens ``[S]`` and anc ``[S, N, N]`` int64. CPU
    tensors run the plain version; CUDA tensors launch the
    ``tree_decode`` kernel or raise."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if max_length is None:
        max_length = page_table.shape[1] * k_pool.shape[2]
    if q.device.type == "cpu":
        return paged_tree_attention_plain(q, k_pool, v_pool, page_table,
                                          base_lens, anc, sm_scale,
                                          max_length)
    _check_tree(q, k_pool, v_pool, page_table, base_lens, anc)
    S, H, N, dh = q.shape
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    ps, npp = int(k_pool.shape[2]), int(page_table.shape[1])
    plan = tree_plan(S, H, N, npp, ps, dh, *device_limits(q.device))
    splits = plan["splits"]
    # the splits' partials (m, l, acc) per node, merged by the kernel's
    # second launch
    part = (torch.empty(S * H * splits * N * (dh + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    TREE_DECODE.launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), base_lens.data_ptr(), anc.data_ptr(),
        out.data_ptr(), part.data_ptr() if part is not None else None,
        S, H, N, ps, dh, npp, int(max_length), splits,
        plan["pages_per_split"], float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_kv_write_block(k_pool, v_pool, k_new, v_new, page_table,
                         positions):
    """Speculative tree write, IN PLACE: row ``i`` of slot ``s``
    (``k_new``/``v_new`` ``[S, H, N, dh]``) lands at storage position
    ``positions[s, i]`` through the table. A row whose position lies
    outside the table's coverage (``pos >= npp * page_size``) goes to the
    trash page instead of a live row, like every row of a finished slot
    (whose table row is all trash). Returns the (updated) pools."""
    ps = k_pool.shape[2]
    S = k_new.shape[0]
    npp = page_table.shape[1]
    pos = positions.to(torch.int64)
    in_range = pos < npp * ps
    page_idx = (pos // ps).clamp(0, npp - 1)
    rows = torch.arange(S, device=pos.device)[:, None]
    zero = torch.zeros_like(pos)
    page_ids = torch.where(in_range,
                           page_table.to(torch.int64)[rows, page_idx], zero)
    offsets = torch.where(in_range, pos % ps, zero)
    k_pool[page_ids, :, offsets, :] = k_new.permute(0, 2, 1, 3).to(
        k_pool.dtype)
    v_pool[page_ids, :, offsets, :] = v_new.permute(0, 2, 1, 3).to(
        v_pool.dtype)
    return k_pool, v_pool


def paged_kv_compact(k_pool, v_pool, page_table, base, path, accept_len):
    """Survivor commit of the accepted tree path, IN PLACE: the K/V row of
    node ``path[s, j]`` moves from storage ``base + path[s, j]`` to the
    canonical position ``base + j``, for ``1 <= j < accept_len[s]``. The
    anchor (j = 0), rows at or past ``accept_len``, rows already in place
    and finished slots (``base = -1``) write to the trash page. Every
    source row is gathered into a temporary BEFORE any row is written, so
    overlapping source and destination rows read the pre-compaction pool,
    as the JAX package's functional scatter does. Returns the pools."""
    ps = k_pool.shape[2]
    S, N = path.shape
    npp = page_table.shape[1]
    L = npp * ps
    table = page_table.to(torch.int64)
    path = path.to(torch.int64)
    j_idx = torch.arange(N, device=path.device)[None, :]
    base_i = base.to(torch.int64).reshape(S, 1)
    src_pos = base_i + path
    dst_pos = base_i + j_idx
    active = ((j_idx >= 1) & (j_idx < accept_len.to(torch.int64).reshape(S, 1))
              & (dst_pos < L) & (src_pos < L) & (base_i >= 0)
              & (path != j_idx))
    rows = torch.arange(S, device=path.device)[:, None]
    sp = src_pos.clamp(0, L - 1)
    s_page, s_off = table[rows, sp // ps], sp % ps
    k_rows = k_pool[s_page, :, s_off, :]                      # [S,N,H,dh]
    v_rows = v_pool[s_page, :, s_off, :]
    dp = dst_pos.clamp(0, L - 1)
    zero = torch.zeros_like(dp)
    d_page = torch.where(active, table[rows, dp // ps], zero)
    d_off = torch.where(active, dp % ps, zero)
    k_pool[d_page, :, d_off, :] = k_rows
    v_pool[d_page, :, d_off, :] = v_rows
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
