"""The linear-chain CRF's recursions on the card: the launch wrappers of
``csrc/crf.cu``, each beside its plain version.

The port's own kernels; they replace no TPU kernel. The JAX package runs
both recursions as ``lax.scan``s inside its one XLA executable
(``paddle_tpu/ops/crf_ops.py:44-55``, the log-partition's forward
recursion, differentiated by ``jax.vjp`` over the scan; ``:107-137``,
the Viterbi recursion and its backtrack). The port's ``Executor``
interprets one eager op at a time, so the same scan in torch ops costs
the host T steps of several launches each, and as many again for its
gradient, for work the card does in microseconds.

- ``crf_logz(x, trans, lens)``: emissions ``[B, T, K]``, transitions
  ``[K + 2, K]`` (row 0 the start weights, row 1 the stop weights, rows
  2.. tag to tag), lengths ``[B]`` -> (Alpha ``[B, T, K]``, the carried
  forward log-scores, a masked step carrying its row's alpha; log Z
  ``[B]``). Differentiable in ``x`` and ``trans`` through
  :class:`CrfLogZ`, whose backward is the beta recursion
  (``CRF_LOGZ_BWD``), not a replay of the forward: from alpha and beta
  it forms the unary and pairwise marginals, the gradients of log Z.
  Both run on the recursions renormalised each step (alpha's and beta's
  values near 0), so that a marginal is a ratio of terms near 1, which
  float32 keeps to ~1e-7 where ``alpha + beta - log Z`` over sums of
  hundreds keeps ~1e-5. ``CRF_LOGZ``: one block a sequence, a thread a
  tag.
- ``crf_viterbi(x, trans, lens)``: the best path ``[B, T]`` (int64,
  zero past each length): the max-product recursion with backpointers
  and the backtrack in one launch of ``CRF_VITERBI``; ties go to the
  lowest index, as ``jnp.argmax`` breaks them, and every score is
  ``delta[prev] + w[prev, cur]``, then ``+ x``, in that order and
  rounded on its own, so the path equals the plain version's bit for
  bit.

A row of length 0 is scored as one of length 1, as the JAX op scores
it (its alpha starts from the first emission whatever the mask says).
On a CUDA tensor a wrapper launches its kernel or raises; on a meta
tensor (build-time shape inference) it returns uninitialized results of
the outputs' shapes; elsewhere it runs the plain version.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels.build import Kernel

CRF_LOGZ = Kernel("paddle_crf_logz", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p])
CRF_LOGZ_BWD = Kernel("paddle_crf_logz_bwd", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
CRF_VITERBI = Kernel("paddle_crf_viterbi", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p])

# a thread a tag; a block's shared memory holds the transitions (K + 2) x
# K, and in the backward entry the block's K x K pairwise sums
MAX_TAGS = 1024
SMEM_LIMIT = 232448


def _check(x, trans, lens, who):
    if x.dim() != 3 or trans.dim() != 2 or tuple(trans.shape) != (
            x.shape[2] + 2, x.shape[2]) or tuple(lens.shape) != (x.shape[0],):
        raise ValueError("%s: x [B, T, K], trans [K + 2, K], lens [B]; not "
                         "%s, %s, %s" % (who, list(x.shape), list(trans.shape),
                                         list(lens.shape)))
    if x.shape[1] < 1:
        raise ValueError("%s: no time step" % who)


def _lse(v):
    """logsumexp over the last dim, kept."""
    return torch.logsumexp(v, dim=-1, keepdim=True)


def crf_logz_plain(x, trans, lens):
    """The forward entry's plain version: ``crf_ops.py:44-55`` in torch
    ops (T - 1 steps), beside it the same recursion renormalised each
    step. Returns (alpha ``[B, T, K]``, the normalised alpha, log Z
    ``[B]``)."""
    t = x.shape[1]
    a, stop, w = trans[0], trans[1], trans[2:]
    live = torch.arange(t, device=x.device)[None, :] < lens.reshape(-1, 1)
    alpha = a[None, :] + x[:, 0, :]
    norm = alpha - _lse(alpha)
    rows, nrows = [alpha], [norm]
    for i in range(1, t):
        keep = live[:, i:i + 1]
        new = torch.logsumexp(alpha[:, :, None] + w[None], dim=1) + x[:, i]
        alpha = torch.where(keep, new, alpha)
        new = torch.logsumexp(norm[:, :, None] + w[None], dim=1) + x[:, i]
        norm = torch.where(keep, new - _lse(new), norm)
        rows.append(alpha)
        nrows.append(norm)
    return (torch.stack(rows, dim=1), torch.stack(nrows, dim=1),
            torch.logsumexp(alpha + stop[None, :], dim=1))


def crf_logz_backward_plain(x, trans, lens, alpha_n, g):
    """The backward entry's plain version: the normalised beta recursion
    over each row's live steps (a row of length 0 as one of length 1),
    the unary marginals ``exp(an + bn)`` normalised over the tags and
    the pairwise ones ``exp(an_{t-1}[i] + w[i, j] + x_t[j] + bn_t[j])``
    normalised over the pairs, times the upstream gradient ``g`` ``[B]``.
    Returns (dx ``[B, T, K]``, dtrans ``[K + 2, K]``)."""
    bsz, t, k = x.shape
    stop, w = trans[1], trans[2:]
    n = lens.to(torch.int64).clamp(1, t)
    ar = torch.arange(bsz, device=x.device)
    dx = torch.zeros_like(x)
    dw = torch.zeros_like(w)
    bn = stop[None, :].expand(bsz, k)
    for i in range(t - 1, -1, -1):
        live = (i < n)[:, None]
        bn = torch.where((n - 1 == i)[:, None], stop[None, :].expand(bsz, k),
                         bn)
        e = alpha_n[:, i] + bn
        dx[:, i] = torch.where(live, g[:, None] * torch.exp(e - _lse(e)),
                               torch.zeros_like(e))
        if i == 0:
            break
        u = x[:, i] + bn
        pair = alpha_n[:, i - 1, :, None] + w[None] + u[:, None, :]
        pair = torch.exp(pair - torch.logsumexp(pair.reshape(bsz, -1), 1)[
            :, None, None])
        dw = dw + (torch.where(live, g[:, None], torch.zeros_like(
            g[:, None]))[:, :, None] * pair).sum(0)
        nxt = torch.logsumexp(w[None] + u[:, None, :], dim=2)
        bn = torch.where(live, nxt - _lse(nxt), bn)
    da = dx[:, 0].sum(0)
    db = dx[ar, n - 1].sum(0)
    return dx, torch.cat([da[None], db[None], dw], 0)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _card_inputs(x, trans, lens, who):
    b, t, k = x.shape
    if k > MAX_TAGS or 4 * ((k + 2) * k + k * k + k + 32) > SMEM_LIMIT:
        raise ValueError("%s: %d tags do not fit a block (a thread a tag, "
                         "the transitions in shared memory)" % (who, k))
    if x.dtype != torch.float32 or trans.dtype != torch.float32:
        raise TypeError("%s: float32 emissions and transitions on the card, "
                        "not %s and %s" % (who, x.dtype, trans.dtype))
    for what, v in (("trans", trans), ("lens", lens)):
        if v.device != x.device:
            raise ValueError("%s: %s on %s, x on %s" % (who, what, v.device,
                                                        x.device))
    return (x.contiguous(), trans.contiguous(),
            lens.to(torch.int32).contiguous())


def _logz_launch(x, trans, lens):
    b, t, k = x.shape
    x, trans, lens = _card_inputs(x, trans, lens, "crf_logz")
    alpha = torch.empty((b, t, k), dtype=torch.float32, device=x.device)
    alpha_n = torch.empty_like(alpha)
    logz = torch.empty((b,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        CRF_LOGZ.launch(x.data_ptr(), trans.data_ptr(), lens.data_ptr(), b,
                        t, k, alpha.data_ptr(), alpha_n.data_ptr(),
                        logz.data_ptr(), _stream(x.device))
    return alpha, alpha_n, logz


def _logz_bwd_launch(x, trans, lens, alpha_n, g):
    b, t, k = x.shape
    x, trans, lens = _card_inputs(x, trans, lens, "crf_logz_bwd")
    g = g.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    dtrans = torch.empty_like(trans)
    # the blocks' partial transition gradients, summed by the entry's
    # second pass in block order (no atomics: the sum is deterministic)
    part = torch.empty((b, k + 2, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        CRF_LOGZ_BWD.launch(
            x.data_ptr(), trans.data_ptr(), lens.data_ptr(),
            alpha_n.contiguous().data_ptr(), g.data_ptr(), b, t, k,
            part.data_ptr(), dx.data_ptr(), dtrans.data_ptr(),
            _stream(x.device))
    return dx, dtrans


class CrfLogZ(torch.autograd.Function):
    """(alpha, log Z) of a linear-chain CRF; the gradient of log Z in
    ``x`` and ``trans`` comes from the backward entry (alpha is not
    differentiated: no op consumes its gradient)."""

    @staticmethod
    def forward(ctx, x, trans, lens):
        if x.device.type == "cuda":
            alpha, alpha_n, logz = _logz_launch(x, trans, lens)
        else:
            alpha, alpha_n, logz = crf_logz_plain(x, trans, lens)
        ctx.save_for_backward(x, trans, lens, alpha_n)
        ctx.mark_non_differentiable(alpha)
        return alpha, logz

    @staticmethod
    def backward(ctx, g_alpha, g_logz):
        x, trans, lens, alpha_n = ctx.saved_tensors
        run = (_logz_bwd_launch if x.device.type == "cuda"
               else crf_logz_backward_plain)
        dx, dtrans = run(x, trans, lens, alpha_n, g_logz)
        return dx, dtrans, None


def crf_logz(x, trans, lens):
    """(Alpha ``[B, T, K]``, log Z ``[B]``) of emissions ``x``, the
    transitions ``trans`` and the lengths ``lens`` ``[B]``. On the card
    one launch of ``CRF_LOGZ``, and one of ``CRF_LOGZ_BWD`` in the
    backward."""
    _check(x, trans, lens, "crf_logz")
    if x.device.type == "meta":
        b, t, k = x.shape
        return (torch.empty((b, t, k), dtype=x.dtype, device=x.device),
                torch.empty((b,), dtype=x.dtype, device=x.device))
    return CrfLogZ.apply(x, trans, lens)


def crf_viterbi_plain(x, trans, lens):
    """The kernel's plain version: ``crf_ops.py:107-137`` in torch ops:
    the recursion (T - 1 steps) with ``torch.argmax`` (the first maximum,
    as ``jnp.argmax``), then the backtrack (T - 1 steps)."""
    b, t, _ = x.shape
    a, stop, w = trans[0], trans[1], trans[2:]
    live = torch.arange(t, device=x.device)[None, :] < lens.reshape(-1, 1)
    last = live.to(torch.int64).sum(1) - 1
    delta = a[None, :] + x[:, 0, :]
    bps = []
    for i in range(1, t):
        scores = delta[:, :, None] + w[None, :, :]
        bps.append(torch.argmax(scores, dim=1))
        new = scores.max(dim=1).values + x[:, i, :]
        delta = torch.where(live[:, i:i + 1], new, delta)
    best = torch.argmax(delta + stop[None, :], dim=1)
    path = [best]
    tag = best
    for i in range(t - 2, -1, -1):
        here = torch.gather(bps[i], 1, tag[:, None])[:, 0]
        tag = torch.where(i >= last, best, here)
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    return torch.where(live, path, torch.zeros_like(path))


def crf_viterbi(x, trans, lens):
    """The Viterbi path ``[B, T]`` (int64, zero past each length). On
    the card one launch of ``CRF_VITERBI``."""
    _check(x, trans, lens, "crf_viterbi")
    b, t, k = x.shape
    if x.device.type == "meta":
        return torch.empty((b, t), dtype=torch.int64, device=x.device)
    if x.device.type != "cuda":
        return crf_viterbi_plain(x, trans, lens)
    x, trans, lens = _card_inputs(x, trans, lens, "crf_viterbi")
    path = torch.empty((b, t), dtype=torch.int64, device=x.device)
    # the backpointers of every step
    bps = torch.empty((b, t, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        CRF_VITERBI.launch(x.data_ptr(), trans.data_ptr(), lens.data_ptr(),
                           b, t, k, bps.data_ptr(), path.data_ptr(),
                           _stream(x.device))
    return path
