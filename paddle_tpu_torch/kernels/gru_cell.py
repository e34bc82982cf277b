"""Fused GRU recurrence: a hand-written CUDA kernel beside its plain
PyTorch version.

Counterpart of ``paddle_tpu/kernels/gru_cell.py``, the sibling of
``lstm_cell.py``: ``fused_gru`` runs the gru_op update-gate recurrence
(``h = u * h + (1 - u) * c``, the reset gate applied to h before the
candidate product) over pre-projected inputs ``xw [B, T, 3D]``. For a CPU
tensor it runs :func:`gru_reference`; for a CUDA tensor it launches
``csrc/gru_cell.cu`` (which replaces the TPU's ``_gru_kernel``) through
:class:`GRUCellFunction`, or raises. The gradient recomputes through
:func:`gru_reference` under autograd, as ``gru_cell.py:143`` does under
``jax.vjp``. ``fused_gru`` also takes an optional ``h0``.

The kernel's launch plan (:func:`gru_plan`) follows B6's scheme
(``lstm_cell.recurrence_plan``): regime (a), a batch split with both
weights in one block, up to D 128 on an H100; regime (b), a column
split launched cooperatively with two grid barriers a step, above it.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels.build import Kernel, device_limits
from paddle_tpu_torch.kernels.lstm_cell import (
    _ACTS,
    ACT_CODES,
    REGIMES,
    W_MODES,
    _ptr,
    block_layout,
    check_acts,
    check_cuda,
    recompute_grads,
    recurrence_plan,
)

GRU_CELL = Kernel("paddle_gru_cell_f32", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
    ctypes.c_void_p])


def gru_layout(B, D, regime, units, rows, kc, w):
    """What csrc/gru_cell.cu's ``plan_layout`` derives from a plan's
    choices: B6's block layout (``lstm_cell.block_layout``) with the
    three weight columns of a unit (12 bytes a unit and k: u and r of
    W_gate, c of W_cand) and two product sums a row and unit (u and r;
    the candidate's one reuses them). ``chip_smoke.py`` holds these
    figures to the kernel's own (``paddle_gru_layout``)."""
    return block_layout(B, D, regime, units, rows, kc, w, 12, 2)


def gru_plan(B, D, n_sm, smem_limit):
    """The launch plan of the ``gru_cell`` kernel for batch ``B`` and
    width ``D`` on a card with ``n_sm`` SMs and ``smem_limit`` bytes of
    shared memory per block, chosen as ``lstm_plan`` chooses B6's:
    ``regime`` ``"a"`` (batch split: a block holds W_gate and W_cand
    and ``rows`` batch rows, no grid barrier) exactly where that fits
    one block, else ``"b"`` (column split: a block holds the three
    columns of ``units`` hidden units for ``rows`` batch rows, a
    cooperative launch with two grid barriers a step, one after the
    gates and the ``r * h`` exchange, one after the state update);
    ``units``, ``rows``, ``kc``, ``w`` (``"shared"``, ``"registers"`` or
    ``"l2"``), and the figures of :func:`gru_layout`."""
    return recurrence_plan(B, D, n_sm, smem_limit, gru_layout, "gru_cell")


def gru_reference(xw, w_gate, w_cand, bias, h0=None, mask=None,
                  gate_act="sigmoid", cand_act="tanh"):
    """The kernel's function in plain PyTorch (``gru_cell.py:22``): xw
    ``[B, T, 3D]``; w_gate ``[D, 2D]``; w_cand ``[D, D]``; bias ``[3D]``;
    h0 ``[B, D]`` (zeros when None); mask None or ``[B, T]``. Returns
    hidden ``[B, T, D]``."""
    ga, ca = _ACTS[gate_act], _ACTS[cand_act]
    d = w_cand.shape[0]
    if xw.shape[1] == 0:
        return xw.new_zeros((xw.shape[0], 0, d))
    h = xw.new_zeros((xw.shape[0], d)) if h0 is None else h0
    hs = []
    for t in range(xw.shape[1]):
        xt = xw[:, t]
        g = xt[:, :2 * d] + h @ w_gate + bias[:2 * d]
        u = ga(g[:, :d])
        r = ga(g[:, d:])
        c = ca(xt[:, 2 * d:] + (r * h) @ w_cand + bias[2 * d:])
        h_new = u * h + (1.0 - u) * c
        if mask is not None:
            m = mask[:, t:t + 1]
            h_new = h_new * m + h * (1.0 - m)
        h = h_new
        hs.append(h)
    return torch.stack(hs, dim=1)


def _row_major(w):
    """``w`` as the kernel reads it: unit column stride and some row
    stride (a column slice of a wider weight is taken as it is)."""
    if w.stride(1) != 1 or w.stride(0) < w.shape[1]:
        w = w.contiguous()
    return w


def gru_cell_forward(xw, w_gate, w_cand, bias, h0=None, mask=None,
                     gate_act="sigmoid", cand_act="tanh"):
    """Launch the ``gru_cell`` kernel (B7) on CUDA tensors: hidden
    ``[B, T, D]``; the arguments of :func:`gru_reference`, mask float32.
    w_gate ``[D, 2D]`` and w_cand ``[D, D]`` may be column slices of the
    op's ``[D, 3D]`` weight (read through their row stride)."""
    check_acts("gru_cell", (gate_act, cand_act))
    b, t_len, _ = xw.shape
    d = w_cand.shape[0]
    check_cuda("gru_cell", [
        ("xw", xw, (b, t_len, 3 * d)), ("w_gate", w_gate, (d, 2 * d)),
        ("w_cand", w_cand, (d, d)), ("bias", bias, (3 * d,)),
        ("mask", mask, (b, t_len)), ("h0", h0, (b, d))])
    w_gate = _row_major(w_gate)
    w_cand = _row_major(w_cand)
    xw, bias = xw.contiguous(), bias.contiguous()
    mask, h0 = (t.contiguous() if t is not None else None
                for t in (mask, h0))
    hidden = torch.empty((b, t_len, d), dtype=xw.dtype, device=xw.device)
    if hidden.numel() == 0:
        return hidden
    plan = gru_plan(b, d, *device_limits(xw.device))
    # regime (b)'s exchange: r * h of every row, and u where a block's
    # rows take several passes
    scratch = (torch.empty((2, b, d), dtype=xw.dtype, device=xw.device)
               if plan["regime"] == "b" else None)
    GRU_CELL.launch(
        xw.data_ptr(), w_gate.data_ptr(), w_gate.stride(0),
        w_cand.data_ptr(), w_cand.stride(0), bias.data_ptr(), _ptr(mask),
        _ptr(h0), hidden.data_ptr(), _ptr(scratch), b, t_len, d,
        ACT_CODES[gate_act], ACT_CODES[cand_act], REGIMES[plan["regime"]],
        plan["units"], plan["rows"], plan["kc"], W_MODES[plan["w"]],
        torch.cuda.current_stream(xw.device).cuda_stream)
    return hidden


class GRUCellFunction(torch.autograd.Function):
    """:func:`gru_cell_forward` with the plain loop's gradient (rerun of
    :func:`gru_reference` under autograd), in the ``forward`` +
    ``setup_context`` form."""

    @staticmethod
    def forward(xw, w_gate, w_cand, bias, h0, mask, acts):
        return gru_cell_forward(xw, w_gate, w_cand, bias, h0, mask, *acts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, acts = inputs
        ctx.save_for_backward(*tensors)
        ctx.acts = acts

    @staticmethod
    def backward(ctx, g_hidden):
        grads = recompute_grads(
            ctx, lambda *a: gru_reference(*a, *ctx.acts), ctx.saved_tensors,
            (g_hidden,))
        return tuple(grads) + (None,)


def fused_gru(xw, w_gate, w_cand, bias, mask=None, gate_act="sigmoid",
              cand_act="tanh", h0=None):
    """Fused GRU over pre-projected inputs (``gru_cell.py:159``). xw
    ``[B, T, 3D]``; w_gate ``[D, 2D]``; w_cand ``[D, D]``; bias ``[3D]``;
    mask optional ``[B, T]``; h0 optional ``[B, D]`` (zeros when absent).
    Returns hidden ``[B, T, D]``; differentiable. CPU tensors run
    :func:`gru_reference`; CUDA tensors launch the ``gru_cell`` kernel or
    raise."""
    check_acts("fused_gru", (gate_act, cand_act))
    d3 = xw.shape[2]
    d = w_cand.shape[0]
    if (d3 != 3 * d or tuple(w_gate.shape) != (d, 2 * d)
            or tuple(w_cand.shape) != (d, d)):
        raise ValueError(
            "fused_gru: shapes inconsistent with 3*D layout: xw %s, "
            "w_gate %s, w_cand %s"
            % (tuple(xw.shape), tuple(w_gate.shape), tuple(w_cand.shape)))
    bias = bias.reshape(-1)
    if xw.device.type == "cpu":
        return gru_reference(xw, w_gate, w_cand, bias, h0, mask, gate_act,
                             cand_act)
    if mask is not None:
        mask = mask.to(torch.float32)
    return GRUCellFunction.apply(xw, w_gate, w_cand, bias, h0, mask,
                                 (gate_act, cand_act))
