"""Flash attention: hand-written CUDA kernels and their plain PyTorch
versions.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``. Three kernels:
``csrc/flash_fwd.cu`` replaces the TPU's ``_flash_kernel``, and
``csrc/flash_bwd.cu`` the FlashAttention-2 backward pair
``_flash_bwd_dkv_kernel`` / ``_flash_bwd_dq_kernel``. ``flash_forward``
and ``flash_backward`` launch them for CUDA tensors and run
``flash_forward_plain`` / ``flash_backward_plain`` for CPU tensors, and
for nothing else. ``flash_attention`` ties the two through a
``torch.autograd.Function``, so autograd (and the ``_grad`` op of
``scaled_dot_product_attention``) reaches the backward kernels. The
backward kernels' tiles come from ``flash_bwd_plan``; the forward's
from ``flash_plan``, which for T <= 4 (decode and verify) takes the
split of the key axis of ``flash_rows_plan`` (static shapes only: the
key mask is never read on the host, so a CUDA graph holds the call). A full
``[B, 1|H, T, S]`` mask is routed by its rank, before any launch, to
``attention_reference`` (torch ops, counted in
``ATTENTION_REFERENCE``), as the JAX package routes it to its XLA
reference.

Contract of both versions: q ``[B, H, T, d]``, k/v ``[B, H/g, S, d]``
(``kv_group=g``: query head h reads kv head ``h // g``), an optional
``[B, S]`` key-validity mask (nonzero keeps), ``causal`` and a sliding
``window`` (causal: ``q - w < k <= q``; else ``|q - k| < w``). They
return ``(out [B, H, T, d], lse [B, H, T])``. A row with no visible key
gives exactly 0 and an LSE at or below ``MASKED_ROW_LSE``. The LSE
layout ``[B, H, T]`` differs from the TPU kernel's ``[B, H, 1, T]``
(flash_attention.py:182-186), which exists only for the TPU's tiling.
Unlike the JAX package's XLA reference, the plain version follows the
kernel on dead rows (0, not the uniform mean of V).

bf16 (mixed precision): q, k, v (and dO) in bf16 take the kernels' bf16
entries (``*_bf16`` symbols, launch counts of their own), which compute
the TPU kernel's function on bf16 tiles: every product of two bf16
values exact in float32 with float32 sums, ``P`` and ``dS`` kept in
float32, one rounding of ``O``, ``dQ``, ``dK`` and ``dV`` to bf16 at
the store, the LSE and ``delta`` in float32. The bf16 entries of B1, B2
and B3 (``csrc/flash_fwd_bf16.cu``, ``csrc/flash_bwd_dkv_bf16.cu``,
``csrc/flash_bwd_dq_bf16.cu``) run on the bf16 tensor cores, ``P`` and
``dS`` split into bf16 hi + lo (about 16 bits) where they meet a
product; their plans are ``flash_bf16_plan`` and ``flash_bwd_plan``'s
``"dkv_bf16"`` and ``"dq_bf16"``. The plain versions compute in
float32. The rows path (T <= 4: decode and verify) takes float32 only.
Any other dtype, or a mix, raises.
"""

import ctypes

import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.kernels import decode_split
from paddle_tpu_torch.kernels.build import Kernel, device_limits, library

NEG_INF = -1e30
MASKED_ROW_LSE = -1e29
MAX_HEAD_DIM = 128

# q, k, v, kv_mask, out, lse, part; B, H, Hkv, T, S, d; sm_scale; causal,
# window, block_q, splits, keys_per_split; stream
_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
    ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
FLASH_FWD = Kernel("paddle_flash_fwd_f32", _FWD_ARGS)
# the bf16 entry (T > 4, csrc/flash_fwd_bf16.cu): bf16 q/k/v and out,
# float32 LSE; block_q from flash_bf16_plan
FLASH_FWD_BF16 = Kernel("paddle_flash_fwd_bf16", _FWD_ARGS)
ROWS_T = 4  # the rows path (csrc/flash_fwd.cu, block_q 4) takes T <= 4

_BWD_ARGS = [ctypes.c_void_p] * 7  # q, k, v, dout, lse, delta, kv_mask
# B, H, Hkv, T, S, d, sm_scale, causal, window, rows, stream
_BWD_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]
FLASH_BWD_DKV = Kernel("paddle_flash_bwd_dkv_f32",
                       _BWD_ARGS + [ctypes.c_void_p] * 2 + _BWD_DIMS)
FLASH_BWD_DQ = Kernel("paddle_flash_bwd_dq_f32",
                      _BWD_ARGS + [ctypes.c_void_p] + _BWD_DIMS)
# the bf16 entries: bf16 q, k, v, dO and dQ/dK/dV; float32 lse and delta
# (csrc/flash_bwd_dkv_bf16.cu, csrc/flash_bwd_dq_bf16.cu)
FLASH_BWD_DKV_BF16 = Kernel("paddle_flash_bwd_dkv_bf16",
                            _BWD_ARGS + [ctypes.c_void_p] * 2 + _BWD_DIMS)
FLASH_BWD_DQ_BF16 = Kernel("paddle_flash_bwd_dq_bf16",
                           _BWD_ARGS + [ctypes.c_void_p] + _BWD_DIMS)
# the dtypes the kernels take, each with its entries: (fwd, dkv, dq)
_ENTRIES = {torch.float32: (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ),
            torch.bfloat16: (FLASH_FWD_BF16, FLASH_BWD_DKV_BF16,
                             FLASH_BWD_DQ_BF16)}


def flash_rows_plan(B, H, T, S, d, n_sm, smem_limit):
    """The rows path's split of the key axis for q ``[B, H, T, d]`` (T <=
    4) over k/v of S keys, from static shapes only (never from the key
    mask, which only the device reads): ``splits`` blocks a (batch,
    head), each over ``keys_per_split`` keys (a multiple of the core's
    32-key chunk; the last split may have fewer, none is empty), by the
    rule of ``paged_plan`` (``decode_split.items_per_split`` over the
    chunks: ``decode_split.BLOCKS_PER_SM`` blocks an SM of ``n_sm``, at
    least two chunks a split; one split at the decode and verify
    shapes). Also ``threads`` and ``smem`` (the core's bytes for
    ``decode_split.rows_for(T)`` rows), which ``chip_smoke.py`` holds to
    the kernel's own (``paddle_flash_rows_layout``)."""
    if not 1 <= T <= ROWS_T or min(B, H, d) < 1 or d > MAX_HEAD_DIM \
            or S < 0:
        raise ValueError("flash_rows_plan: B %d, H %d, T %d, S %d, d %d out "
                         "of range" % (B, H, T, S, d))
    chunk = decode_split.CHUNK
    n_chunks = max(1, -(-S // chunk))
    per = decode_split.items_per_split(B * H, n_chunks, chunk, n_sm)
    smem = decode_split.smem_bytes(d, decode_split.rows_for(T))
    decode_split.check_smem("flash_rows_plan", smem, smem_limit)
    return {"splits": -(-n_chunks // per), "keys_per_split": per * chunk,
            "threads": decode_split.THREADS, "smem": smem}


def flash_plan(B, H, T, S, d, n_sm, smem_limit):
    """The forward kernel's launch plan for q ``[B, H, T, d]`` over S keys
    on a card with ``n_sm`` SMs: ``{"block_q": 4 | 32 | 64, "blocks",
    "threads"}``. For T <= 4 (decode and verify) the rows path
    (``block_q`` 4) with the key split of :func:`flash_rows_plan`, whose
    ``splits``, ``keys_per_split`` and ``smem`` the plan carries, a block
    per (split, head, batch); else 64-row register-blocked tiles, or
    32-row ones where 64-row tiles would give fewer blocks than SMs (the
    encoder's one sequence), a block per (query tile, head, batch)."""
    if T <= ROWS_T:
        rows = flash_rows_plan(B, H, T, S, d, n_sm, smem_limit)
        return dict(rows, block_q=4, blocks=B * H * rows["splits"])
    if B * H * -(-T // 64) < n_sm:
        bq, threads = 32, 128
    else:
        bq, threads = 64, 256
    return {"block_q": bq, "blocks": B * H * -(-T // bq), "threads": threads}


# the bf16 entries' tiles, as csrc/mma_bf16.cuh and the entries
# (csrc/flash_fwd_bf16.cu, csrc/flash_bwd_dkv_bf16.cu,
# csrc/flash_bwd_dq_bf16.cu) build them: bf16 rows of the head dim padded
# to 32, 64 or 128 (bf16_padded_dim), plus BF16_PAD values
BF16_PAD = 8
BF16_TILE_K = 64    # keys of B1's K/V tile
BF16_TILE_Q = 32    # rows of B2's streamed Q/dO tile
BF16_DQ_TILE_K = 32  # keys of B3's streamed K/V tile
BF16_STAGES = 2     # cp.async buffers of a streamed tile, every entry
# B1's query rows a block (4 warps of 16); 128-row blocks of 8 warps ran
# slower on an H100 at the train shapes (one fills an SM's registers)
BF16_ROWS = 64


def bf16_padded_dim(d):
    """The head dim the bf16 entries are built for: ``d`` padded with
    zero columns to 32, 64 or 128 (whole k16 steps)."""
    return 32 if d <= 32 else 64 if d <= 64 else 128


def flash_bf16_plan(B, H, T, S, d, n_sm, smem_limit):
    """The bf16 forward entry's launch plan (csrc/flash_fwd_bf16.cu) for
    bf16 q ``[B, H, T, d]`` (T > 4) over S keys on a card with ``n_sm``
    SMs, from static shapes only: ``block_q`` query rows a block
    (``BF16_ROWS``, 16 a warp), ``threads``, ``stages`` (K/V buffers),
    ``head_dim`` (the padded one), ``smem`` (the Q tile, the K and V
    tiles of each buffer and their key-mask entries; ``chip_smoke.py``
    holds it to the kernel's ``paddle_flash_fwd_bf16_layout``) and
    ``blocks``, one per (query tile, head, batch). ``smem_limit`` is the
    card's per-block limit; ``n_sm`` is not needed by this plan."""
    if T <= ROWS_T or min(B, H, d, S + 1) < 1 or d > MAX_HEAD_DIM:
        raise ValueError("flash_bf16_plan: B %d, H %d, T %d, S %d, d %d out "
                         "of range" % (B, H, T, S, d))
    dp = bf16_padded_dim(d)
    bq = BF16_ROWS
    smem = (2 * (dp + BF16_PAD) * (bq + BF16_STAGES * 2 * BF16_TILE_K)
            + 4 * BF16_STAGES * BF16_TILE_K)
    decode_split.check_smem("flash_bf16_plan", smem, smem_limit)
    return {"block_q": bq, "threads": 2 * bq, "stages": BF16_STAGES,
            "head_dim": dp, "smem": smem, "blocks": B * H * -(-T // bq)}


def kernel_flash_rows_layout(T, d):
    """``(threads, smem)`` of csrc/flash_fwd.cu's rows block for T <= 4
    query rows at head dim ``d`` (its ``paddle_flash_rows_layout``; host
    code: needs the built library, not a card), or None where the kernel
    refuses them."""
    fn = library().paddle_flash_rows_layout
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(T, d, ctypes.byref(threads), ctypes.byref(smem))
    return None if rc else (threads.value, smem.value)


BWD_KERNELS = ("dkv", "dq")  # the index is the kernel's number in C
# the backward kernels' tiles, as csrc/flash_bwd.cu builds them: a block
# owns 64 rows (4 warps of 16); its streamed tiles (Q in B2, K and V in
# B3) have 32 rows, in two buffers (B2) or one (B3), so a block's shared
# memory lets 3 B2 blocks and 4 B3 blocks share an SM at d <= 64, as
# their registers do
BWD_ROWS = 64
BWD_TILE = 32
BWD_STAGES = {"dkv": 2, "dq": 1}


def flash_bwd_plan(B, H, Hkv, T, S, d):
    """The backward kernels' launch plan for q ``[B, H, T, d]`` and k/v
    ``[B, Hkv, S, d]``: ``{"dkv": {...}, "dq": {...}, "dkv_bf16": {...},
    "dq_bf16": {...}}``, each with

    - ``rows``: the block's own tile (keys of B2, query rows of B3), 16 a
      warp: 64 (``BWD_ROWS``) at every shape; 32-row tiles measured no
      faster on an H100 even where 64-row ones leave SMs idle;
    - ``threads``: 32 a warp;
    - ``smem``: shared bytes a block takes: its two resident tiles and
      the buffers (``BWD_STAGES``) of its two streamed ``BWD_TILE``-row
      tiles with their per-row vectors (B2: lse and delta; B3: the key
      mask), a row being the head dim padded to 64 or 128, plus 4 floats
      (csrc/flash_bwd.cu ``smem_bytes``; ``chip_smoke.py`` holds the two
      to each other);
    - ``grid``: (tiles of the own axis, heads, batch): B2 over the S keys
      and ``Hkv`` kv heads, B3 over the T query rows and ``H`` heads.

    ``"dkv_bf16"`` is B2's bf16 entry (csrc/flash_bwd_dkv_bf16.cu): the
    same 64-key blocks and grid, bf16 tiles (2 bytes a value) of the head
    dim padded to 32, 64 or 128 plus ``BF16_PAD`` values, its streamed
    Q/dO tiles of ``tile`` rows (``BF16_TILE_Q``) in ``stages`` buffers
    with their lse and delta (float32);
    ``chip_smoke.py`` holds it to ``paddle_flash_bwd_dkv_bf16_layout``.
    ``"dq_bf16"`` is B3's bf16 entry (csrc/flash_bwd_dq_bf16.cu): the
    same 64-row blocks and grid as ``"dq"``, resident bf16 Q and dO
    tiles, its streamed K/V tiles of ``tile`` keys (``BF16_DQ_TILE_K``)
    in ``stages`` buffers with their key-mask entries (float32);
    ``chip_smoke.py`` holds it to ``paddle_flash_bwd_dq_bf16_layout``.

    The wrappers pass ``rows`` to the kernels."""
    ld = (64 if d <= 64 else 128) + 4

    def one(kernel, own, heads):
        vec = (2 if kernel == "dkv" else 1) * BWD_TILE
        return {"rows": BWD_ROWS, "threads": 2 * BWD_ROWS,
                "smem": 4 * (2 * BWD_ROWS * ld + BWD_STAGES[kernel]
                             * (2 * BWD_TILE * ld + vec)),
                "grid": (-(-own // BWD_ROWS), heads, B)}

    def bf16(tile, vecs, own, heads):
        """Two resident tiles of ``BWD_ROWS`` rows, and ``BF16_STAGES``
        buffers of two streamed ``tile``-row tiles with ``vecs`` float32
        entries a row."""
        return {"rows": BWD_ROWS, "threads": 2 * BWD_ROWS, "tile": tile,
                "stages": BF16_STAGES,
                "smem": (2 * (bf16_padded_dim(d) + BF16_PAD)
                         * (2 * BWD_ROWS + BF16_STAGES * 2 * tile)
                         + 4 * BF16_STAGES * vecs * tile),
                "grid": (-(-own // BWD_ROWS), heads, B)}

    return {"dkv": one("dkv", S, Hkv), "dq": one("dq", T, H),
            "dkv_bf16": bf16(BF16_TILE_Q, 2, S, Hkv),
            "dq_bf16": bf16(BF16_DQ_TILE_K, 1, T, H)}


def kernel_bwd_layout(kernel, rows, d):
    """``(threads, smem)`` as csrc/flash_bwd.cu derives them for
    ``kernel`` (``"dkv"`` or ``"dq"``) at tile ``rows`` and head dim
    ``d`` (its ``paddle_flash_bwd_layout``, host code: needs the built
    library, not a card), or None where the kernels refuse them."""
    fn = library().paddle_flash_bwd_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(BWD_KERNELS.index(kernel), rows, d, ctypes.byref(threads),
            ctypes.byref(smem))
    return None if rc else (threads.value, smem.value)


def kernel_bf16_layout(entry, tile, d):
    """The figures csrc/flash_fwd_bf16.cu (``entry`` ``"fwd"``, query
    tile ``tile``: ``paddle_flash_fwd_bf16_layout``),
    csrc/flash_bwd_dkv_bf16.cu (``"dkv"``, key tile ``tile``:
    ``paddle_flash_bwd_dkv_bf16_layout``) or csrc/flash_bwd_dq_bf16.cu
    (``"dq"``, query tile ``tile``: ``paddle_flash_bwd_dq_bf16_layout``)
    derive for a block at head dim ``d``: ``{"threads", "smem"}``, and
    for ``"dkv"`` and ``"dq"`` also ``"tile"``, the streamed Q tile's
    rows or K/V tile's keys (host code: needs the built library, not a
    card), or None where the entry refuses them."""
    out = [ctypes.c_int(0) for _ in range(2 if entry == "fwd" else 3)]
    fn = getattr(library(), "paddle_flash_%s_bf16_layout"
                 % ("fwd" if entry == "fwd" else "bwd_" + entry))
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * len(
        out)
    fn.restype = ctypes.c_int
    if fn(tile, d, *(ctypes.byref(o) for o in out)):
        return None
    return dict(zip(("threads", "smem", "tile"), (o.value for o in out)))


def _visible(T, S, kv_mask, causal, window, device):
    """[B|1, 1, T, S] bool visibility of key s to query t."""
    qi = torch.arange(T, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    vis = torch.ones(T, S, dtype=torch.bool, device=device)
    if causal:
        vis = vis & (ki <= qi)
    if window:
        vis = vis & (qi - ki < window)
        if not causal:
            vis = vis & (ki - qi < window)
    vis = vis[None, None]
    if kv_mask is not None:
        vis = vis & (kv_mask[:, None, None, :] > 0)
    return vis


def flash_forward_plain(q, k, v, kv_mask=None, causal=False, sm_scale=None,
                        kv_group=1, window=0):
    """The kernel's function in plain PyTorch (whole score matrix, fp32
    accumulation); same arguments and results as :func:`flash_forward`.
    bf16 inputs are upcast to float32, every product is taken in float32
    with ``P`` in float32, and ``out`` is rounded to q's dtype once, as
    the TPU kernel computes (flash_attention.py:113-147); the LSE is
    float32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    g = int(kv_group)
    if g != 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q.float() * sm_scale, k.float().transpose(-1, -2))
    vis = _visible(q.shape[2], k.shape[2], kv_mask, causal, int(window),
                   q.device)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(p, v.float()) / denom
    out = torch.where(m <= MASKED_ROW_LSE, torch.zeros_like(out), out)
    lse = (m + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def _check(q, k, v, kv_mask, kv_group, who="flash_forward", extra=()):
    """Raise on what the kernels do not take: q, k, v CUDA tensors of one
    dtype with an entry (float32 or bf16). ``extra``: more (name,
    tensor, shape, dtype) quads that must be contiguous CUDA tensors of
    that shape and dtype (None: q's dtype)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError("%s: %s is on %s, the kernel needs CUDA "
                             "tensors" % (who, name, t.device))
        if t.dtype not in _ENTRIES:
            raise TypeError("%s: %s is %s; the kernels take float32 or "
                            "bfloat16" % (who, name, t.dtype))
        if t.dtype != q.dtype:
            raise TypeError("%s: q is %s but %s is %s; the kernels take "
                            "one dtype" % (who, q.dtype, name, t.dtype))
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError("%s: %s must be a contiguous 4-D tensor, got "
                             "shape %s" % (who, name, tuple(t.shape)))
    B, H, T, d = q.shape
    g = int(kv_group)
    if g < 1 or k.shape[1] * g != H or k.shape != v.shape \
            or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(
            "%s: q %s, k %s, v %s, kv_group %d do not fit q [B,H,T,d] with "
            "k/v [B,H/g,S,d]"
            % (who, tuple(q.shape), tuple(k.shape), tuple(v.shape), g))
    if d > MAX_HEAD_DIM:
        raise ValueError("%s: head dim %d > %d is not supported"
                         % (who, d, MAX_HEAD_DIM))
    if kv_mask is not None and (
            kv_mask.device != q.device or kv_mask.dtype != torch.float32
            or tuple(kv_mask.shape) != (B, k.shape[2])
            or not kv_mask.is_contiguous()):
        raise ValueError("%s: kv_mask must be a contiguous float32 [B, S] "
                         "tensor on q's device" % who)
    for name, t, shape, dtype in extra:
        dtype = q.dtype if dtype is None else dtype
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError("%s: %s must be a contiguous %s %s tensor on "
                             "q's device, got %s %s on %s"
                             % (who, name, dtype, list(shape), t.dtype,
                                tuple(t.shape), t.device))


def flash_forward(q, k, v, kv_mask=None, causal=False, sm_scale=None,
                  kv_group=1, window=0):
    """Attention forward; returns ``(out, lse)``. CPU tensors run
    :func:`flash_forward_plain`; CUDA tensors launch the ``flash_fwd``
    kernel (float32 by :func:`flash_plan`, or bf16 at T > 4 through its
    bf16 entry by :func:`flash_bf16_plan`; contiguous, head dim <= 128)
    or raise. A launch is counted in ``by_key`` of
    ``FLASH_FWD`` (or ``FLASH_FWD_BF16``) under ``(T, causal)``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    window = int(window)
    if window < 0:
        raise ValueError("flash_forward: window must be >= 0 (0 disables "
                         "the sliding window); got %d" % window)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, kv_mask, causal, sm_scale,
                                   kv_group, window)
    _check(q, k, v, kv_mask, kv_group)
    B, H, T, d = q.shape
    if q.dtype != torch.float32 and T <= ROWS_T:
        raise TypeError("flash_forward: the rows path (T <= %d) takes "
                        "float32 only, got %s" % (ROWS_T, q.dtype))
    S = int(k.shape[2])
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    plan = (flash_plan if q.dtype == torch.float32 else flash_bf16_plan)(
        B, H, T, S, d, *device_limits(q.device))
    splits = plan.get("splits", 1)
    # the rows path's split partials (m, l, acc) per row, merged by the
    # kernel's second launch
    part = (torch.empty(B * H * splits * T * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    _ENTRIES[q.dtype][0].launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        out.data_ptr(), lse.data_ptr(),
        part.data_ptr() if part is not None else None, B, H,
        int(k.shape[1]), T, S, d, float(sm_scale), int(bool(causal)),
        window, plan["block_q"], splits, plan.get("keys_per_split", 0),
        torch.cuda.current_stream(q.device).cuda_stream,
        key=(T, bool(causal)))
    return out, lse


def flash_backward_plain(q, k, v, kv_mask, out, lse, dout, causal=False,
                         sm_scale=None, kv_group=1, window=0):
    """The backward kernels' function in plain PyTorch (whole score
    matrix, fp32): ``(dq, dk, dv)`` from the forward's inputs, its output
    and LSE, and the output's gradient. A row whose LSE is at or below
    ``MASKED_ROW_LSE`` (no visible key) contributes nothing, as in the
    kernels. bf16 inputs are upcast, ``delta`` and every product are
    float32, and the gradients are rounded to the inputs' dtype once
    (flash_attention.py:466-472,513-514,548)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    B, H, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = int(kv_group)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    if g != 1:
        kf = kf.repeat_interleave(g, dim=1)
        vf = vf.repeat_interleave(g, dim=1)
    lse = lse.float()
    delta = (dof * out.float()).sum(dim=-1)
    s = torch.matmul(qf * sm_scale, kf.transpose(-1, -2))
    vis = _visible(T, S, kv_mask, causal, int(window), q.device) \
        & (lse > MASKED_ROW_LSE)[..., None]
    p = torch.exp(s - lse[..., None]).masked_fill(~vis, 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    if g != 1:
        dk = dk.reshape(B, Hkv, g, S, d).sum(dim=2)
        dv = dv.reshape(B, Hkv, g, S, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_check(q, k, v, kv_mask, dout, lse, delta, kv_group, window, who):
    if int(window) < 0:
        raise ValueError("%s: window must be >= 0 (0 disables the sliding "
                         "window); got %d" % (who, window))
    B, H, T, _ = q.shape
    _check(q, k, v, kv_mask, kv_group, who=who, extra=(
        ("dout", dout, q.shape, None),
        ("lse", lse, (B, H, T), torch.float32),
        ("delta", delta, (B, H, T), torch.float32)))


def _bwd_args(q, k, v, kv_mask, dout, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None)


def _bwd_dims(q, k, causal, sm_scale, window, kernel):
    """The launch's dims, options, the plan's tile rows for ``kernel``
    and the stream."""
    B, H, T, d = q.shape
    Hkv, S = int(k.shape[1]), int(k.shape[2])
    plan = flash_bwd_plan(B, H, Hkv, T, S, d)
    return (B, H, Hkv, T, S, d, float(sm_scale), int(bool(causal)),
            int(window), plan[kernel]["rows"],
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dkv(q, k, v, kv_mask, dout, lse, delta, causal, sm_scale,
                  kv_group=1, window=0):
    """Launch the ``flash_bwd_dkv`` kernel (B2) on CUDA tensors: ``(dk,
    dv)``, each ``[B, H/g, S, d]``, from ``delta = rowsum(dO * O)``. A
    launch is counted in ``by_key`` of ``FLASH_BWD_DKV`` (or
    ``FLASH_BWD_DKV_BF16`` for bf16) under ``(T, causal)``."""
    _bwd_check(q, k, v, kv_mask, dout, lse, delta, kv_group, window,
               "flash_bwd_dkv")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _ENTRIES[q.dtype][1].launch(
        *(_bwd_args(q, k, v, kv_mask, dout, lse, delta)
          + (dk.data_ptr(), dv.data_ptr())
          + _bwd_dims(q, k, causal, sm_scale, window,
                    "dkv" if q.dtype == torch.float32 else "dkv_bf16")),
        key=(q.shape[2], bool(causal)))
    return dk, dv


def flash_bwd_dq(q, k, v, kv_mask, dout, lse, delta, causal, sm_scale,
                 kv_group=1, window=0):
    """Launch the ``flash_bwd_dq`` kernel (B3) on CUDA tensors: ``dq``
    ``[B, H, T, d]``. Counted by ``(T, causal)`` as ``flash_bwd_dkv``
    (``FLASH_BWD_DQ`` or ``FLASH_BWD_DQ_BF16``)."""
    _bwd_check(q, k, v, kv_mask, dout, lse, delta, kv_group, window,
               "flash_bwd_dq")
    dq = torch.empty_like(q)
    _ENTRIES[q.dtype][2].launch(
        *(_bwd_args(q, k, v, kv_mask, dout, lse, delta) + (dq.data_ptr(),)
          + _bwd_dims(q, k, causal, sm_scale, window,
                      "dq" if q.dtype == torch.float32 else "dq_bf16")),
        key=(q.shape[2], bool(causal)))
    return dq


def flash_backward(q, k, v, kv_mask, out, lse, dout, causal=False,
                   sm_scale=None, kv_group=1, window=0):
    """Attention backward; returns ``(dq, dk, dv)``. CPU tensors run
    :func:`flash_backward_plain`; CUDA tensors launch the
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` kernels (float32 or bf16, head
    dim <= 128) or raise. ``delta = rowsum(dO * O)`` is one torch
    expression ahead of them, in float32 from the upcast values, as the
    JAX package computes it in XLA outside Pallas
    (flash_attention.py:466-472)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, kv_mask, out, lse, dout,
                                    causal, sm_scale, kv_group, window)
    dout = dout.contiguous()
    if q.numel() == 0 or k.numel() == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    delta = (dout.float() * out.float()).sum(dim=-1)
    dk, dv = flash_bwd_dkv(q, k, v, kv_mask, dout, lse, delta, causal,
                           sm_scale, kv_group, window)
    dq = flash_bwd_dq(q, k, v, kv_mask, dout, lse, delta, causal, sm_scale,
                      kv_group, window)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``flash_forward`` with ``flash_backward`` as its gradient. It saves
    the forward's output and LSE; the key mask and the LSE output take no
    gradient. Written in the ``forward`` + ``setup_context`` form, which
    ``torch.func`` transforms require, and which plain autograd takes
    too."""

    @staticmethod
    def forward(q, k, v, kv_mask, causal, sm_scale, kv_group, window):
        return flash_forward(q, k, v, kv_mask, causal, sm_scale, kv_group,
                             window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, kv_mask, causal, sm_scale, kv_group, window = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.options = (causal, sm_scale, kv_group, window)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, kv_mask, out, lse, dout,
                                    *ctx.options)
        return dq, dk, dv, None, None, None, None, None


class CallCount(object):
    """Calls of a route that is not a kernel, counted as ``Kernel``
    counts launches: ``calls``, zeroed by ``reset()``."""

    def __init__(self, name):
        self.name = name
        self.calls = 0

    def reset(self):
        self.calls = 0


ATTENTION_REFERENCE = CallCount("attention_reference")


def attention_reference(q, k, v, causal=False, sm_scale=None, mask=None,
                        kv_group=1, window=0):
    """Attention over the whole score matrix in torch ops: the route of a
    full ``[B, 1|H, T, S]`` mask, on the CPU and on the card alike.

    The counterpart of the JAX package's XLA path for such a mask:
    ``flash_attention_reference`` with the GQA repeat and the window band
    that ``flash_attention`` adds around it (paddle_tpu/kernels/
    flash_attention.py:61-89,661-676). No Pallas kernel takes a full mask
    there either. Its two products go to ``torch.matmul``, as the JAX
    package leaves them to XLA, and autograd differentiates it. A row with
    no visible key gets the uniform mean of V, as in the reference (the
    kernels give 0). Each call adds one to ``ATTENTION_REFERENCE.calls``.
    """
    ATTENTION_REFERENCE.calls += 1
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    g = int(kv_group)
    if g != 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    T, S = q.shape[2], k.shape[2]
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    vis = None if mask is None else mask != 0
    if window:
        band = (qi - ki) < window
        if not causal:
            band = band & ((ki - qi) < window)
        vis = band if vis is None else vis & band
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    neg = torch.full((), NEG_INF, dtype=s.dtype, device=s.device)
    if causal:
        s = torch.where(ki <= qi, s, neg)
    if vis is not None:
        s = torch.where(vis, s, neg)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def is_key_mask(mask):
    """Is ``mask`` a key-validity mask, ``[B, S]`` or ``[B, 1, 1, S]``
    (the kernels' kind), rather than a full ``[B, 1|H, T, S]`` one?"""
    return mask.dim() == 2 or (mask.dim() == 4 and mask.shape[1] == 1
                               and mask.shape[2] == 1)


def key_mask(mask):
    """Normalize a key-validity mask to float32 ``[B, S]``: accepts
    ``[B, S]`` or ``[B, 1, 1, S]`` (as the attention op normalizes it,
    flash_attention.py:650-655), bool or numeric."""
    if not is_key_mask(mask):
        raise ValueError(
            "the flash kernels take a key-validity mask [B, S] or "
            "[B, 1, 1, S]; got shape %s (a full mask takes "
            "attention_reference)" % (tuple(mask.shape),))
    if mask.dim() == 4:
        mask = mask[:, 0, 0, :]
    return (mask > 0).to(torch.float32).contiguous()


def flash_attention(q, k, v, causal=False, sm_scale=None, mask=None,
                    kv_group=1, window=0):
    """Fused attention ``[B,H,T,d] -> [B,H,T,d]`` (the JAX package's entry
    point). The mask's rank picks the route before any launch, as in the
    JAX package: no mask or a key mask (``[B, S]``, ``[B, 1, 1, S]``) runs
    :class:`FlashAttentionFunction`, so its gradient runs the backward
    kernels; a full ``[B, 1|H, T, S]`` mask runs
    :func:`attention_reference`. ``FLAGS_flash_backward``: ``pallas``
    (the default) takes the kernels' path; ``reference`` differentiates
    :func:`flash_forward_plain` with autograd instead, on CPU tensors
    only, and raises for CUDA tensors (the port has no path from the card
    to the plain versions)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if int(window) < 0:
        raise ValueError("flash_attention: window must be >= 0 (0 disables "
                         "the sliding window); got %d" % window)
    if mask is not None and not is_key_mask(mask):
        return attention_reference(q, k, v, causal, sm_scale, mask,
                                   kv_group, int(window))
    kv_mask = key_mask(mask) if mask is not None else None
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if backward_impl(q.device) == "reference":
        return flash_forward_plain(q, k, v, kv_mask, causal, sm_scale,
                                   kv_group, window)[0]
    out, _ = FlashAttentionFunction.apply(q, k, v, kv_mask, causal,
                                          float(sm_scale), int(kv_group),
                                          int(window))
    return out


def backward_impl(device):
    """``FLAGS_flash_backward`` for tensors on ``device``: ``pallas`` or
    ``reference``; ``reference`` on a CUDA device raises."""
    impl = flags.get("flash_backward")
    if impl not in ("pallas", "reference"):
        raise ValueError("FLAGS_flash_backward must be pallas or reference, "
                         "got %r" % impl)
    if impl == "reference" and device.type == "cuda":
        raise ValueError(
            "FLAGS_flash_backward=reference is refused for CUDA tensors: "
            "paddle_tpu_torch runs the backward kernels on the card and has "
            "no path there to the plain version")
    return impl
