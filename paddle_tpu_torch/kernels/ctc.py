"""The CTC loss on the card: the launch wrapper of ``csrc/ctc.cu`` beside
its plain version.

The port's own kernel; it replaces no TPU kernel. The JAX package runs
the CTC alpha lattice as a ``lax.scan`` inside its one XLA executable
(``paddle_tpu/ops/ctc_ops.py:63-94``) and takes the gradient with
``jax.vjp`` over the scan; the port's ``Executor`` interprets one eager
op at a time, where the same scan in torch ops costs the host T steps of
about a dozen launches each, and as many again for the gradient.

``ctc_loss(logits, label, t_len, l_len, blank, norm_by_times)``: raw
activations ``[B, T, V]``, labels ``[B, L]``, the frames and labels of
each row ``[B]`` -> the loss ``[B]``, differentiable in ``logits``
through :class:`CtcLoss`. ``CTC_LOSS``: one block a sequence over its
``2L + 1`` lattice computes the log-softmax, the alpha recursion, the
loss and dLogits in one launch, as warp-ctc does; the backward of the
autograd Function scales the saved dLogits by the upstream gradient.

The lattice is the JAX op's: log space with ``_NEG = -1e30`` for an
unreachable state, so a row with fewer frames than its labels need gets
the same huge finite loss as the JAX op, not ``inf``. dLogits is the
adjoint of that recursion, carried backward from the loss: on a live
frame each lattice state hands its gradient to its three predecessors
in the shares ``exp(x - m) / (e_0 + e_1 + e_2)`` with which they entered
its log-sum-exp (taken on the lattice shifted by its largest state each
frame, whose values stay near 0 where the raw lattice's grow to
hundreds: float32 keeps the shares to ~1e-7, not ~1e-5), which is
``softmax - occupancy / p`` through the
log-softmax (the beta recursion, normalised) and, for a row without a
feasible alignment, the JAX op's own gradient. Under ``norm_by_times``
the loss and its gradient are divided by ``max(t_len, 1)``. Label
lengths are clipped to 0..L.

On a CUDA tensor the wrapper launches its kernel or raises; on a meta
tensor (build-time shape inference) it returns an uninitialized loss;
elsewhere it runs the plain version.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels.build import Kernel

CTC_LOSS = Kernel("paddle_ctc_loss", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p])

NEG = -1e30  # ctc_ops.py's _NEG: an unreachable lattice state


def lattice(label, l_len, blank):
    """(ext ``[B, S]`` the extended labels blank, l0, blank, l1, ...,
    blank; valid ``[B, S]`` the states below ``2 l_len + 1``; can_skip
    ``[B, S]`` a label state that may be entered from two states back)
    as ``ctc_ops.py:48-62`` builds them."""
    b, n_lab = label.shape
    s_len = 2 * n_lab + 1
    dev = label.device
    s_idx = torch.arange(s_len, device=dev)
    is_lab = (s_idx % 2) == 1
    lab_pos = ((s_idx - 1) // 2).clamp(0, n_lab - 1)
    ext = torch.where(is_lab[None, :], label[:, lab_pos].to(torch.int64),
                      torch.full((), blank, dtype=torch.int64, device=dev))
    valid = s_idx[None, :] < (2 * l_len + 1)[:, None]
    ext_m2 = torch.cat([torch.full((b, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], 1)
    return ext, valid, is_lab[None, :] & (ext != ext_m2)


def _shift(a, k, fill):
    """``a`` ``[B, S]`` moved ``k`` states right (``k`` < 0: left), the
    vacated states set to ``fill``."""
    pad = torch.full((a.shape[0], abs(k)), fill, dtype=a.dtype,
                     device=a.device)
    if k > 0:
        return torch.cat([pad, a[:, :-k]], 1)
    return torch.cat([a[:, -k:], pad], 1)


def _lse3_parts(a, b, c):
    """``_logsumexp3``'s pieces: (m, e_a, e_b, e_c, their sum)."""
    m = torch.clamp_min(torch.maximum(torch.maximum(a, b), c), NEG)
    ea, eb, ec = torch.exp(a - m), torch.exp(b - m), torch.exp(c - m)
    return m, ea, eb, ec, ea + eb + ec


def ctc_loss_plain(logits, label, t_len, l_len, blank, norm_by_times,
                   want_grad=True):
    """The kernel's plain version: ``ctc_ops.py:46-94`` in torch ops (T -
    1 steps) and, with ``want_grad``, the adjoint recursion (T - 1 steps
    back). Returns (loss ``[B]``, dLogits ``[B, T, V]`` for an upstream
    gradient of 1, or None)."""
    b, t, _ = logits.shape
    dev = logits.device
    l_len = l_len.to(torch.int64).clamp(0, label.shape[1])
    t_len = t_len.to(torch.int64)
    # the log-softmax as the kernel takes it: each frame less its
    # log-sum-exp (a frame's rounding of it is common to all its states,
    # so it cancels in the lattice's shares)
    lp = logits - torch.logsumexp(logits, dim=2, keepdim=True)
    ext, valid, can_skip = lattice(label, l_len, blank)
    s_len = ext.shape[1]
    ar = torch.arange(b, device=dev)
    neg = torch.full((), NEG, dtype=lp.dtype, device=dev)
    alpha = torch.full((b, s_len), NEG, dtype=lp.dtype, device=dev)
    alpha[:, 0] = lp[:, 0, blank]
    has_lab = l_len > 0
    alpha[:, 1] = torch.where(has_lab, lp[ar, 0, ext[:, 1]], neg)
    # beside the raw lattice (the loss's), the same recursion shifted by
    # its largest state each frame (the gradient's: values near 0)
    norm_a = alpha - alpha.max(1, keepdim=True).values
    alphas = [norm_a]

    def step(a, emit):
        a_m1 = _shift(a, 1, NEG)
        a_m2 = torch.where(can_skip, _shift(a, 2, NEG), neg)
        m, _, _, _, den = _lse3_parts(a, a_m1, a_m2)
        return torch.where(valid, m + torch.log(den) + emit, neg)

    for i in range(1, t):
        live = (i < t_len)[:, None]
        emit = torch.gather(lp[:, i], 1, ext)
        alpha = torch.where(live, step(alpha, emit), alpha)
        new = step(norm_a, emit)
        new = torch.where(valid, new - new.max(1, keepdim=True).values, neg)
        norm_a = torch.where(live, new, norm_a)
        alphas.append(norm_a)
    end1_idx = (2 * l_len - 1).clamp(0, s_len - 1)

    def ends(a):
        e0 = torch.gather(a, 1, (2 * l_len)[:, None])[:, 0]
        e1 = torch.where(has_lab, torch.gather(a, 1, end1_idx[:, None])[
            :, 0], neg)
        m = torch.maximum(e0, e1)
        return m, torch.exp(e0 - m), torch.exp(e1 - m)

    m, e0, e1 = ends(alpha)
    loss = -(m + torch.log(e0 + e1))
    norm = torch.clamp_min(t_len.to(lp.dtype), 1.0) if norm_by_times \
        else torch.ones((), dtype=lp.dtype, device=dev)
    loss = loss / norm
    if not want_grad:
        return loss, None
    # the adjoint, from d loss = 1 back to lp, on the shifted lattice
    _, e0, e1 = ends(norm_a)
    g_ll = -1.0 / norm * torch.ones((b,), dtype=lp.dtype, device=dev)
    g = torch.zeros((b, s_len), dtype=lp.dtype, device=dev)
    g[ar, 2 * l_len] += g_ll * e0 / (e0 + e1)
    g[ar, end1_idx] += torch.where(has_lab, g_ll * e1 / (e0 + e1),
                                   torch.zeros_like(g_ll))
    g_lp = torch.zeros_like(lp)
    for i in range(t - 1, 0, -1):
        prev = alphas[i - 1]
        live = (i < t_len)[:, None]
        g_new = torch.where(live & valid, g, torch.zeros_like(g))
        a_m1 = _shift(prev, 1, NEG)
        a_m2 = torch.where(can_skip, _shift(prev, 2, NEG), neg)
        _, ea, eb, ec, den = _lse3_parts(prev, a_m1, a_m2)
        to_prev = (g_new * ea / den + _shift(g_new * eb / den, -1, 0.0)
                   + _shift(torch.where(can_skip, g_new * ec / den,
                                        torch.zeros_like(g)), -2, 0.0))
        g = torch.where(live, to_prev, g)
        g_lp[:, i].scatter_add_(1, ext, g_new)
    g_lp[:, 0, blank] += g[:, 0]
    g_lp[ar, 0, ext[:, 1]] += torch.where(has_lab, g[:, 1],
                                          torch.zeros_like(g[:, 1]))
    return loss, g_lp - torch.exp(lp) * g_lp.sum(2, keepdim=True)


def _launch(logits, label, t_len, l_len, blank, norm_by_times, want_grad):
    b, t, v = logits.shape
    n_lab = label.shape[1]
    dev = logits.device
    if logits.dtype != torch.float32:
        raise TypeError("ctc_loss: float32 logits on the card, not %s"
                        % logits.dtype)
    for what, x in (("label", label), ("t_len", t_len), ("l_len", l_len)):
        if x.device != dev:
            raise ValueError("ctc_loss: %s on %s, logits on %s"
                             % (what, x.device, dev))
    if not 0 <= blank < v:
        raise ValueError("ctc_loss: blank %d outside 0..%d" % (blank, v - 1))
    logits = logits.contiguous()
    label = label.to(torch.int32).contiguous()
    t_len = t_len.to(torch.int32).contiguous()
    l_len = l_len.to(torch.int32).contiguous()
    loss = torch.empty((b,), dtype=torch.float32, device=dev)
    grad = torch.empty_like(logits) if want_grad else None
    # each frame's log-sum-exp and the alpha lattice of every frame
    lse = torch.empty((b, t), dtype=torch.float32, device=dev)
    alpha = torch.empty((b, t, 2 * n_lab + 1), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        CTC_LOSS.launch(
            logits.data_ptr(), label.data_ptr(), t_len.data_ptr(),
            l_len.data_ptr(), b, t, v, n_lab, int(blank),
            int(bool(norm_by_times)), lse.data_ptr(), alpha.data_ptr(),
            loss.data_ptr(), None if grad is None else grad.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    return loss, grad


class CtcLoss(torch.autograd.Function):
    """The CTC loss ``[B]``; the gradient in the logits is the one the
    forward computed, times the upstream gradient of each row."""

    @staticmethod
    def forward(ctx, logits, label, t_len, l_len, blank, norm_by_times):
        run = _launch if logits.device.type == "cuda" else ctc_loss_plain
        loss, grad = run(logits, label, t_len, l_len, blank, norm_by_times,
                         ctx.needs_input_grad[0])
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None, None] * grad, None, None, None, None, None


def ctc_loss(logits, label, t_len, l_len, blank=0, norm_by_times=False):
    """The CTC loss ``[B]`` of ``logits`` ``[B, T, V]`` against ``label``
    ``[B, L]`` (``L`` >= 1) with ``t_len`` frames and ``l_len`` labels a
    row. On the card one launch of ``CTC_LOSS``."""
    if logits.dim() != 3 or label.dim() != 2 or label.shape[0] != \
            logits.shape[0] or label.shape[1] < 1 or tuple(t_len.shape) != (
                logits.shape[0],) or tuple(l_len.shape) != (logits.shape[0],):
        raise ValueError("ctc_loss: logits [B, T, V], label [B, L >= 1], "
                         "t_len and l_len [B]; not %s" % ([list(x.shape) for x
                                                           in (logits, label,
                                                               t_len, l_len)],))
    if logits.device.type == "meta":
        return torch.empty((logits.shape[0],), dtype=logits.dtype,
                           device=logits.device)
    return CtcLoss.apply(logits, label, t_len, l_len, int(blank),
                         bool(norm_by_times))
