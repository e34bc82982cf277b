"""Flash attention forward: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``paddle_tpu/kernels/flash_attention.py`` (forward only;
the FlashAttention-2 backward pair comes with the training slice). The
kernel is ``csrc/flash_fwd.cu``, which replaces the TPU's
``_flash_kernel``; ``flash_forward`` launches it for CUDA tensors and
runs ``flash_forward_plain`` for CPU tensors, and for nothing else.

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
"""

import ctypes

import torch

from paddle_tpu_torch.kernels.build import Kernel

NEG_INF = -1e30
MASKED_ROW_LSE = -1e29
MAX_HEAD_DIM = 128

FLASH_FWD = Kernel("paddle_flash_fwd_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
])


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
    accumulation); same arguments and results as :func:`flash_forward`."""
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


def _check(q, k, v, kv_mask, kv_group):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError("flash_forward: %s is on %s, the kernel "
                             "needs CUDA tensors" % (name, t.device))
        if t.dtype != torch.float32:
            raise TypeError("flash_forward: %s is %s; this kernel takes "
                            "float32 only" % (name, t.dtype))
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError("flash_forward: %s must be a contiguous 4-D "
                             "tensor, got shape %s" % (name, tuple(t.shape)))
    B, H, T, d = q.shape
    g = int(kv_group)
    if g < 1 or k.shape[1] * g != H or k.shape != v.shape \
            or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(
            "flash_forward: q %s, k %s, v %s, kv_group %d do not fit "
            "q [B,H,T,d] with k/v [B,H/g,S,d]"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape), g))
    if d > MAX_HEAD_DIM:
        raise ValueError("flash_forward: head dim %d > %d is not supported"
                         % (d, MAX_HEAD_DIM))
    if kv_mask is not None and (
            kv_mask.device != q.device or kv_mask.dtype != torch.float32
            or tuple(kv_mask.shape) != (B, k.shape[2])
            or not kv_mask.is_contiguous()):
        raise ValueError("flash_forward: kv_mask must be a contiguous "
                         "float32 [B, S] tensor on q's device")


def flash_forward(q, k, v, kv_mask=None, causal=False, sm_scale=None,
                  kv_group=1, window=0):
    """Attention forward; returns ``(out, lse)``. CPU tensors run
    :func:`flash_forward_plain`; CUDA tensors launch the ``flash_fwd``
    kernel (float32, contiguous, head dim <= 128) or raise."""
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
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        out.data_ptr(), lse.data_ptr(), B, H, int(k.shape[1]), T,
        int(k.shape[2]), d, float(sm_scale), int(bool(causal)), window,
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def key_mask(mask):
    """Normalize a key-validity mask to float32 ``[B, S]``: accepts
    ``[B, S]`` or ``[B, 1, 1, S]`` (as the attention op normalizes it,
    flash_attention.py:650-655), bool or numeric."""
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        mask = mask[:, 0, 0, :]
    if mask.dim() != 2:
        raise ValueError(
            "flash attention takes a key-validity mask [B, S] or "
            "[B, 1, 1, S]; got shape %s (a full [B, H, T, S] mask is not "
            "ported)" % (tuple(mask.shape),))
    return (mask > 0).to(torch.float32).contiguous()


def flash_attention(q, k, v, causal=False, sm_scale=None, mask=None,
                    kv_group=1, window=0):
    """Fused attention ``[B,H,T,d] -> [B,H,T,d]`` (the JAX package's entry
    point, forward only): normalizes the mask and returns the output of
    :func:`flash_forward`."""
    kv_mask = key_mask(mask) if mask is not None else None
    out, _ = flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                           kv_mask, causal, sm_scale, kv_group, window)
    return out
