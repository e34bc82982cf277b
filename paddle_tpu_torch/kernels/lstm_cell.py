"""Fused LSTM recurrence: a hand-written CUDA kernel beside its plain
PyTorch version.

Counterpart of ``paddle_tpu/kernels/lstm_cell.py``. The input product
x @ W_x of all steps stays outside (one large GEMM); ``fused_lstm`` runs
the sequential part over the pre-projected inputs ``xw [B, T, 4D]``. For
a CPU tensor it runs :func:`lstm_reference`, the plain loop over T. For a
CUDA tensor it launches ``csrc/lstm_cell.cu`` (which replaces the TPU's
``_lstm_kernel``) through :class:`LSTMCellFunction`, or raises. The
kernel's gradient recomputes through :func:`lstm_reference` under
autograd, as the JAX package's ``_fused_bwd`` recomputes through its XLA
scan under ``jax.vjp``: the JAX package has no backward Pallas kernel
here, so neither has the port. Unlike the JAX entry point, ``fused_lstm``
also takes an initial state ``h0`` / ``c0``, so that on the card a
``dynamic_lstm`` with ``H0`` / ``C0`` runs the kernel too.
"""

import ctypes

import torch

from paddle_tpu_torch.kernels.build import Kernel, device_limits, library

ACT_CODES = {"sigmoid": 0, "tanh": 1, "relu": 2, "identity": 3}
_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda v: v,
}

LSTM_CELL = Kernel("paddle_lstm_cell_f32", [ctypes.c_void_p] * 9 + [
    ctypes.c_int] * 11 + [ctypes.c_void_p])

# the kernel's limits (csrc/lstm_cell.cu): (unit, row group) pairs per
# block, and threads per block (four per pair and k-share)
MAX_COMBOS = 128
MAX_THREADS = 512
REG_QUADS = 2   # k-quads of W_h a thread holds in registers
W_MODES = {"shared": 0, "l2": 1, "registers": 2}
REGIMES = {"a": 0, "b": 1}


def row_stride(cols):
    """Row stride (floats) of h held ``[rows][k]`` in shared memory for
    ``cols`` k columns: a multiple of 4 with an odd count of float4s
    (``row_stride`` in csrc/lstm_cell.cu)."""
    quads = -(-cols // 4)
    return 4 * (quads if quads % 2 else quads + 1)


def lstm_layout(B, D, regime, units, rows, kc, w):
    """What csrc/lstm_cell.cu's ``plan_layout`` derives from a plan's
    choices (``regime``, ``units`` and ``rows`` per block, ``kc`` k
    columns of h staged at once, ``w`` where W_h lives): ``rt`` rows per
    thread (1 or 4), ``groups`` row groups per pass, ``kw`` warp groups
    splitting k, ``threads``, ``smem`` (bytes per block: W_h or its slice
    where it lives in shared memory, 16 bytes a unit and k, the h
    buffers, two in regime (a), and the warp groups' sums, four a row
    and unit) and ``blocks``. ``chip_smoke.py`` holds these figures to
    the kernel's own (``kernel_layout``)."""
    return block_layout(B, D, regime, units, rows, kc, w, 16, 4)


def block_layout(B, D, regime, units, rows, kc, w, w_bytes, sums):
    """The block layout the recurrence kernels share (B6's
    ``lstm_layout``, B7's ``gru_layout``), for weights of ``w_bytes``
    bytes a hidden unit and k and ``sums`` product sums a row and unit
    per pass."""
    rt = 4 if rows >= 4 else 1
    groups = min(-(-rows // rt), MAX_COMBOS // units)
    warps = -(-(units * groups) // 8)
    kw = max(1, min(4, MAX_THREADS // (32 * warps)))
    smem = ((w_bytes * (-(-D // 4) * 4) * units if w == "shared" else 0)
            + 4 * row_stride(kc) * groups * rt * (2 if regime == "a" else 1)
            + 4 * kw * warps * 8 * rt * sums)
    return dict(rt=rt, groups=groups, kw=kw, threads=32 * warps * kw,
                smem=smem, blocks=-(-D // units) * -(-B // rows))


def lstm_plan(B, D, n_sm, smem_limit):
    """The launch plan of the ``lstm_cell`` kernel for batch ``B`` and
    width ``D`` on a card with ``n_sm`` SMs and ``smem_limit`` bytes of
    shared memory per block. A dict:

    - ``regime`` ``"a"`` (batch split: a block holds all of W_h and
      ``rows`` batch rows, no grid barrier) or ``"b"`` (column split: a
      block holds the W_h slice of ``units`` hidden units for ``rows``
      batch rows, a cooperative launch with a grid barrier per step);
    - ``units``, ``rows``, ``kc`` (k columns of h staged at once), ``w``
      (where W_h or the block's slice of it lives for all steps:
      ``"shared"`` memory, ``"registers"`` where a thread's share is at
      most ``REG_QUADS`` float4s x 4 (regime (a) at small D), or
      ``"l2"``: read every step, where a 1/SMs slice does not fit shared
      memory); the wrapper passes these to the kernel;
    - and what follows from them (:func:`lstm_layout`): ``rt``,
      ``groups``, ``kw``, ``threads``, ``smem``, ``blocks``.

    Regime (a) is taken exactly where its layout with W_h in shared
    memory fits one block."""
    return recurrence_plan(B, D, n_sm, smem_limit, lstm_layout,
                           "lstm_cell")


def recurrence_plan(B, D, n_sm, smem_limit, layout, who):
    """The plan of a recurrence kernel laid out as csrc/lstm_cell.cu
    lays out B6 (B7, csrc/gru_cell.cu, shares the scheme): regime (a)
    where ``layout``'s figures for all D units in shared memory fit one
    block, W_h in registers where a thread's share is at most
    ``REG_QUADS`` k-quads; else regime (b), the most row splits whose
    weight slice stays resident, or the fewest with it read from L2.
    ``layout(B, D, regime, units, rows, kc, w)`` gives the block's
    figures (``smem``, ``kw``, ``groups``, ``rt``, ``blocks``, ...)."""
    if B < 1 or D < 1:
        raise ValueError("%s: B %d and D %d must be positive" % (who, B, D))

    def plan_of(regime, units, rows, kc, w):
        return dict(regime=regime, units=units, rows=rows, kc=kc, w=w,
                    **layout(B, D, regime, units, rows, kc, w))

    rows = -(-B // n_sm)
    if D <= MAX_COMBOS:
        rows = min(rows, (4 if rows >= 4 else 1) * (MAX_COMBOS // D))
        plan = plan_of("a", D, rows, D, "shared")
        if plan["smem"] <= smem_limit:
            quads = -(-D // 4)  # k-quads of W_h, split over 4 kw phases
            if -(-quads // (4 * plan["kw"])) <= REG_QUADS:
                plan = plan_of("a", D, rows, D, "registers")
            return plan
    # regime (b): split the rows 1, 2, 4, ... ways and the units over the
    # SMs left; fewer rows per block stage less of h per step, so take
    # the most rows split whose weight slice stays resident
    plans = []
    split = 1
    while split <= B:
        rows = -(-B // split)
        row_blocks = -(-B // rows)
        if row_blocks > n_sm:
            break
        plan = _column_plan(plan_of, D, rows, -(-D // (n_sm // row_blocks)),
                            smem_limit)
        if plan is not None and plan["blocks"] <= n_sm:
            plans.append(plan)
        split *= 2
    resident = [p for p in plans if p["w"] == "shared"]
    if resident:
        return resident[-1]
    if plans:
        return plans[0]
    raise ValueError("%s: batch %d at width %d fits no launch plan on %d "
                     "SMs" % (who, B, D, n_sm))


def _column_plan(plan_of, D, rows, units, smem_limit):
    """Regime (b) with blocks of ``units`` hidden units x ``rows`` batch
    rows, the weight slice in shared memory if it fits beside at least 8
    staged k columns of h, else read from L2; None where neither fits."""
    if units > MAX_COMBOS:
        return None
    for w in ("shared", "l2"):
        plan = plan_of("b", units, rows, D, w)
        if plan["smem"] > smem_limit:
            # stage h in k-chunks: 4 bytes a column and row of the pass,
            # the row stride pads a multiple of 8 by 4
            col_bytes = 4 * plan["groups"] * plan["rt"]
            rest = plan["smem"] - col_bytes * row_stride(D)
            kc = ((smem_limit - rest) // col_bytes - 8) // 8 * 8
            if kc < 8:
                continue
            plan = plan_of("b", units, rows, kc, w)
        return plan
    return None


def kernel_layout(B, D, plan, symbol="paddle_lstm_layout"):
    """``(threads, smem, blocks)`` as csrc/lstm_cell.cu derives them for
    ``plan`` (its ``paddle_lstm_layout``; csrc/gru_cell.cu's
    ``paddle_gru_layout`` for a ``gru_plan``; host code: needs the built
    library, not a card), or None where the kernel refuses the plan."""
    fn = getattr(library(), symbol)
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(3)]
    rc = fn(B, D, REGIMES[plan["regime"]], plan["units"], plan["rows"],
            plan["kc"], W_MODES[plan["w"]], *[ctypes.byref(o) for o in out])
    return None if rc else tuple(o.value for o in out)


def check_acts(who, names):
    for name in names:
        if name not in _ACTS:
            raise ValueError("%s: unsupported activation %r" % (who, name))


def lstm_reference(xw, w_h, bias, peephole=None, h0=None, c0=None,
                   mask=None, gate_act="sigmoid", cell_act="tanh",
                   cand_act="tanh"):
    """The kernel's function in plain PyTorch, a loop over T with the math
    of ``lstm_cell.py:50-91``. xw ``[B, T, 4D]`` (bias NOT added); w_h
    ``[D, 4D]``; bias ``[4D]``; peephole None or (w_ic, w_fc, w_oc), each
    ``[D]`` (or a ``[3, D]`` tensor); h0 / c0 ``[B, D]`` (zeros when
    None); mask None or ``[B, T]`` (1 = valid step). Returns (hidden,
    cell), each ``[B, T, D]``."""
    ga, ca, na = _ACTS[gate_act], _ACTS[cell_act], _ACTS[cand_act]
    b, t_len = xw.shape[0], xw.shape[1]
    d = w_h.shape[0]
    if t_len == 0:
        empty = xw.new_zeros((b, 0, d))
        return empty, empty.clone()
    h = xw.new_zeros((b, d)) if h0 is None else h0
    c = xw.new_zeros((b, d)) if c0 is None else c0
    hs, cs = [], []
    for t in range(t_len):
        gates = xw[:, t] + h @ w_h + bias
        gi, gf, gc, go = gates.split(d, dim=1)
        if peephole is not None:
            gi = gi + c * peephole[0]
            gf = gf + c * peephole[1]
        i_v = ga(gi)
        f_v = ga(gf)
        c_new = f_v * c + i_v * na(gc)
        if peephole is not None:
            go = go + c_new * peephole[2]
        h_new = ga(go) * ca(c_new)
        if mask is not None:
            m = mask[:, t:t + 1]
            h_new = h_new * m + h * (1.0 - m)
            c_new = c_new * m + c * (1.0 - m)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def check_cuda(who, tensors):
    """What the recurrence kernels ask of their inputs: every given tensor
    float32 and on one CUDA device; ``tensors`` is a list of (name,
    tensor or None, shape)."""
    device = tensors[0][1].device
    for name, t, shape in tensors:
        if t is None:
            continue
        if t.device != device or t.device.type != "cuda":
            raise ValueError("%s: %s is on %s; the kernel needs every input "
                             "on one CUDA device" % (who, name, t.device))
        if t.dtype != torch.float32:
            raise TypeError("%s: %s is %s; this kernel takes float32 only"
                            % (who, name, t.dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s: %s has shape %s, expected %s"
                             % (who, name, tuple(t.shape), tuple(shape)))


def _ptr(t):
    return t.data_ptr() if t is not None else None


def lstm_cell_forward(xw, w_h, bias, peephole=None, h0=None, c0=None,
                      mask=None, gate_act="sigmoid", cell_act="tanh",
                      cand_act="tanh"):
    """Launch the ``lstm_cell`` kernel (B6) on CUDA tensors: (hidden,
    cell), each ``[B, T, D]``; the arguments of :func:`lstm_reference`,
    with ``peephole`` a ``[3, D]`` tensor or None and mask float32.
    Inputs are made contiguous here."""
    check_acts("lstm_cell", (gate_act, cell_act, cand_act))
    b, t_len, d4 = xw.shape
    d = w_h.shape[0]
    check_cuda("lstm_cell", [
        ("xw", xw, (b, t_len, 4 * d)), ("w_h", w_h, (d, 4 * d)),
        ("bias", bias, (4 * d,)), ("peephole", peephole, (3, d)),
        ("mask", mask, (b, t_len)), ("h0", h0, (b, d)), ("c0", c0, (b, d))])
    xw, w_h, bias = xw.contiguous(), w_h.contiguous(), bias.contiguous()
    peephole, mask, h0, c0 = (t.contiguous() if t is not None else None
                              for t in (peephole, mask, h0, c0))
    hidden = torch.empty((b, t_len, d), dtype=xw.dtype, device=xw.device)
    cell = torch.empty_like(hidden)
    if hidden.numel() == 0:
        return hidden, cell
    plan = lstm_plan(b, d, *device_limits(xw.device))
    LSTM_CELL.launch(
        xw.data_ptr(), w_h.data_ptr(), bias.data_ptr(), _ptr(peephole),
        _ptr(mask), _ptr(h0), _ptr(c0), hidden.data_ptr(), cell.data_ptr(),
        b, t_len, d, ACT_CODES[gate_act], ACT_CODES[cell_act],
        ACT_CODES[cand_act], REGIMES[plan["regime"]], plan["units"],
        plan["rows"], plan["kc"], W_MODES[plan["w"]],
        torch.cuda.current_stream(xw.device).cuda_stream)
    return hidden, cell


def recompute_grads(ctx, fn, inputs, cotangents):
    """The gradients of ``fn(*inputs)`` for the inputs ``ctx`` marks as
    needing one, by rerunning ``fn`` (the plain version) under autograd;
    None for the rest."""
    wanted = [i for i, t in enumerate(inputs)
              if t is not None and ctx.needs_input_grad[i]]
    if not wanted:
        return [None] * len(inputs)
    local = list(inputs)
    with torch.enable_grad():
        for i in wanted:
            local[i] = inputs[i].detach().requires_grad_(True)
        outs = fn(*local)
        grads = torch.autograd.grad(outs, [local[i] for i in wanted],
                                    cotangents, allow_unused=True)
    result = [None] * len(inputs)
    for i, g in zip(wanted, grads):
        result[i] = torch.zeros_like(inputs[i]) if g is None else g
    return result


class LSTMCellFunction(torch.autograd.Function):
    """:func:`lstm_cell_forward` with the plain loop's gradient: the
    backward reruns :func:`lstm_reference` on the saved inputs under
    autograd. Written in the ``forward`` + ``setup_context`` form, which
    ``torch.func`` transforms require and plain autograd takes too."""

    @staticmethod
    def forward(xw, w_h, bias, peep, h0, c0, mask, acts):
        return lstm_cell_forward(xw, w_h, bias, peep, h0, c0, mask, *acts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, acts = inputs
        ctx.save_for_backward(*tensors)
        ctx.acts = acts

    @staticmethod
    def backward(ctx, g_hidden, g_cell):
        grads = recompute_grads(
            ctx, lambda *a: lstm_reference(*a, *ctx.acts),
            ctx.saved_tensors, (g_hidden, g_cell))
        return tuple(grads) + (None,)


def fused_lstm(xw, w_h, bias, peephole=None, mask=None, gate_act="sigmoid",
               cell_act="tanh", cand_act="tanh", h0=None, c0=None):
    """Fused LSTM over pre-projected inputs (``lstm_cell.py:233``).

    xw ``[B, T, 4D]`` (= x @ W_x, WITHOUT bias); w_h ``[D, 4D]``; bias
    ``[4D]``; peephole optional (w_ic, w_fc, w_oc), each ``[D]``; mask
    optional ``[B, T]`` validity; h0 / c0 optional ``[B, D]`` (zeros when
    absent). Returns (hidden, cell), each ``[B, T, D]``; differentiable.
    CPU tensors run :func:`lstm_reference`; CUDA tensors launch the
    ``lstm_cell`` kernel or raise."""
    check_acts("fused_lstm", (gate_act, cell_act, cand_act))
    d4 = xw.shape[2]
    d = w_h.shape[0]
    if d4 != 4 * d or w_h.shape[1] != 4 * d:
        raise ValueError(
            "fused_lstm: xw last dim %d / w_h %s inconsistent with 4*D"
            % (d4, tuple(w_h.shape)))
    bias = bias.reshape(-1)
    if xw.device.type == "cpu":
        return lstm_reference(xw, w_h, bias, peephole, h0, c0, mask,
                              gate_act, cell_act, cand_act)
    peep = torch.stack(list(peephole)) if peephole is not None else None
    if mask is not None:
        mask = mask.to(torch.float32)
    return LSTMCellFunction.apply(xw, w_h, bias, peep, h0, c0, mask,
                                  (gate_act, cell_act, cand_act))
