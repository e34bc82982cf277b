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
``scaled_dot_product_attention``) reaches the backward kernels.

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

from paddle_tpu_torch import flags
from paddle_tpu_torch.kernels.build import Kernel, device_limits

NEG_INF = -1e30
MASKED_ROW_LSE = -1e29
MAX_HEAD_DIM = 128

FLASH_FWD = Kernel("paddle_flash_fwd_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
])

_BWD_ARGS = [ctypes.c_void_p] * 7  # q, k, v, dout, lse, delta, kv_mask
_BWD_DIMS = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
FLASH_BWD_DKV = Kernel("paddle_flash_bwd_dkv_f32",
                       _BWD_ARGS + [ctypes.c_void_p] * 2 + _BWD_DIMS)
FLASH_BWD_DQ = Kernel("paddle_flash_bwd_dq_f32",
                      _BWD_ARGS + [ctypes.c_void_p] + _BWD_DIMS)


def flash_plan(B, H, T, n_sm):
    """The forward kernel's query tile for q ``[B, H, T, d]`` on a card
    with ``n_sm`` SMs: ``{"block_q": 4 | 32 | 64, "blocks", "threads"}``.
    4 rows for T <= 4 (decode and verify: a warp per row); else 64-row
    register-blocked tiles, or 32-row ones where 64-row tiles would give
    fewer blocks than SMs (the encoder's one sequence)."""
    if T <= 4:
        bq, threads = 4, 128
    elif B * H * -(-T // 64) < n_sm:
        bq, threads = 32, 128
    else:
        bq, threads = 64, 256
    return {"block_q": bq, "blocks": B * H * -(-T // bq), "threads": threads}


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


def _check(q, k, v, kv_mask, kv_group, who="flash_forward", extra=()):
    """Raise on what the kernels do not take. ``extra``: more (name,
    tensor, shape) triples that must be contiguous fp32 CUDA tensors of
    that shape."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError("%s: %s is on %s, the kernel needs CUDA "
                             "tensors" % (who, name, t.device))
        if t.dtype != torch.float32:
            raise TypeError("%s: %s is %s; this kernel takes float32 only"
                            % (who, name, t.dtype))
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
    for name, t, shape in extra:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError("%s: %s must be a contiguous float32 %s tensor "
                             "on q's device, got %s %s on %s"
                             % (who, name, list(shape), t.dtype,
                                tuple(t.shape), t.device))


def flash_forward(q, k, v, kv_mask=None, causal=False, sm_scale=None,
                  kv_group=1, window=0):
    """Attention forward; returns ``(out, lse)``. CPU tensors run
    :func:`flash_forward_plain`; CUDA tensors launch the ``flash_fwd``
    kernel (float32, contiguous, head dim <= 128) or raise. A launch is
    counted in ``FLASH_FWD.by_key`` under ``(T, causal)``."""
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
        flash_plan(B, H, T, device_limits(q.device)[0])["block_q"],
        torch.cuda.current_stream(q.device).cuda_stream,
        key=(T, bool(causal)))
    return out, lse


def flash_backward_plain(q, k, v, kv_mask, out, lse, dout, causal=False,
                         sm_scale=None, kv_group=1, window=0):
    """The backward kernels' function in plain PyTorch (whole score
    matrix, fp32): ``(dq, dk, dv)`` from the forward's inputs, its output
    and LSE, and the output's gradient. A row whose LSE is at or below
    ``MASKED_ROW_LSE`` (no visible key) contributes nothing, as in the
    kernels."""
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
        ("dout", dout, q.shape), ("lse", lse, (B, H, T)),
        ("delta", delta, (B, H, T))))


def _bwd_args(q, k, v, kv_mask, dout, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            kv_mask.data_ptr() if kv_mask is not None else None)


def _bwd_dims(q, k, causal, sm_scale, window):
    B, H, T, d = q.shape
    return (B, H, int(k.shape[1]), T, int(k.shape[2]), d, float(sm_scale),
            int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dkv(q, k, v, kv_mask, dout, lse, delta, causal, sm_scale,
                  kv_group=1, window=0):
    """Launch the ``flash_bwd_dkv`` kernel (B2) on CUDA tensors: ``(dk,
    dv)``, each ``[B, H/g, S, d]``, from ``delta = rowsum(dO * O)``."""
    _bwd_check(q, k, v, kv_mask, dout, lse, delta, kv_group, window,
               "flash_bwd_dkv")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_BWD_DKV.launch(*(_bwd_args(q, k, v, kv_mask, dout, lse, delta)
                           + (dk.data_ptr(), dv.data_ptr())
                           + _bwd_dims(q, k, causal, sm_scale, window)))
    return dk, dv


def flash_bwd_dq(q, k, v, kv_mask, dout, lse, delta, causal, sm_scale,
                 kv_group=1, window=0):
    """Launch the ``flash_bwd_dq`` kernel (B3) on CUDA tensors: ``dq``
    ``[B, H, T, d]``."""
    _bwd_check(q, k, v, kv_mask, dout, lse, delta, kv_group, window,
               "flash_bwd_dq")
    dq = torch.empty_like(q)
    FLASH_BWD_DQ.launch(*(_bwd_args(q, k, v, kv_mask, dout, lse, delta)
                          + (dq.data_ptr(),)
                          + _bwd_dims(q, k, causal, sm_scale, window)))
    return dq


def flash_backward(q, k, v, kv_mask, out, lse, dout, causal=False,
                   sm_scale=None, kv_group=1, window=0):
    """Attention backward; returns ``(dq, dk, dv)``. CPU tensors run
    :func:`flash_backward_plain`; CUDA tensors launch the
    ``flash_bwd_dkv`` and ``flash_bwd_dq`` kernels (float32, head dim
    <= 128) or raise. ``delta = rowsum(dO * O)`` is one torch expression
    ahead of them, as the JAX package computes it in XLA outside Pallas
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
    delta = (dout * out).sum(dim=-1)
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
    point): normalizes the mask and runs :class:`FlashAttentionFunction`,
    so its gradient runs the backward kernels. ``FLAGS_flash_backward``:
    ``pallas`` (the default) takes that path; ``reference`` differentiates
    :func:`flash_forward_plain` with autograd instead, on CPU tensors
    only, and raises for CUDA tensors (the port has no path from the card
    to the plain versions)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
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
