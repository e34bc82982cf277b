"""Recurrent ops over dense-padded sequences: dynamic_lstm, dynamic_gru,
dynamic_lstmp, lstm_unit, gru_unit and row_conv.

Counterpart of ``paddle_tpu/ops/rnn_ops.py``, with the same inputs,
outputs, attrs and dense-shape contract:
Input ``[B, T, gates * D]`` (the projected input x @ W_x), Weight the
recurrence weights, Bias ``[1, gates * D]`` (plus the three peephole
vectors for an LSTM with ``use_peepholes``), an optional ``[B]`` Length
that masks the padded steps.

Routing. On a CUDA tensor dynamic_lstm and dynamic_gru launch their hand-written kernel
(``kernels/lstm_cell.py``, ``kernels/gru_cell.py``) whatever
``FLAGS_use_pallas_lstm`` / ``FLAGS_use_pallas_gru`` say and whether or
not H0 / C0 are given: a loop of small ops on the card would be the plain
version on the main path. On a CPU tensor the flags choose, as in the
JAX package (rnn_ops.py:134, 308), between the plain loop with the op's
initial state and ``fused_lstm`` / ``fused_gru`` (which run the same
plain loop on the CPU); an initial state keeps the op on its own loop
there, as in the JAX package.

Reverse runs flip the WHOLE padded time axis of the input and the mask,
then flip the outputs back (rnn_ops.py:100-104): padded steps run first
with mask 0 and carry the initial state.
"""

import torch

from paddle_tpu_torch import flags
from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.kernels.gru_cell import fused_gru, gru_reference
from paddle_tpu_torch.kernels.lstm_cell import (
    _ACTS,
    fused_lstm,
    lstm_reference,
)


def _step_mask(ins, x):
    """``[B, T]`` float mask from the optional Length input ([B])."""
    if not ins.get("Length"):
        return None
    lens = ins["Length"][0].reshape(-1)
    steps = torch.arange(x.shape[1], device=x.device)
    return (steps[None, :] < lens[:, None]).to(x.dtype)


def _time_order(x, mask, reverse):
    if not reverse:
        return x, mask
    return x.flip(1), (mask.flip(1) if mask is not None else None)


def _kernel_route(x, flag, has_init_state):
    """True where the op runs its fused entry: always on the card, under
    the flag and without an initial state elsewhere."""
    return x.device.type == "cuda" or (flags.get(flag)
                                       and not has_init_state)


def _infer_rnn_shapes(out_slots, x_slot="Input", w_slot="Weight"):
    """Build-time shapes: every output ``[B, T, D]`` with B, T from the
    ``x_slot`` input and D the ``w_slot`` weight's rows (the kernels do
    not run on ``meta`` tensors)."""

    def infer(block, op):
        x = block._find_var_recursive(op.input(x_slot)[0])
        w = block._find_var_recursive(op.input(w_slot)[0])
        if x.shape is None or w.shape is None:
            return
        for slot in out_slots:
            for name in op.output(slot):
                v = block._find_var_recursive(name)
                if v is not None:
                    v.shape = tuple(x.shape[:2]) + (int(w.shape[0]),)
                    v.dtype = w.dtype

    return infer


def _lower_dynamic_lstm(ctx, ins, attrs):
    x = ins["Input"][0]  # [B, T, 4D]
    w = ins["Weight"][0]  # [D, 4D]
    d = w.shape[0]
    acts = (attrs.get("gate_activation", "sigmoid"),
            attrs.get("cell_activation", "tanh"),
            attrs.get("candidate_activation", "tanh"))
    bias = ins.get("Bias", [None])[0]
    peep = None
    if bias is not None:
        bias = bias.reshape(-1)
        b_gate = bias[:4 * d]
        if attrs.get("use_peepholes", True):
            peep = (bias[4 * d:5 * d], bias[5 * d:6 * d], bias[6 * d:7 * d])
    else:
        b_gate = x.new_zeros((4 * d,))
    h0 = ins.get("H0", [None])[0]
    c0 = ins.get("C0", [None])[0]
    reverse = attrs.get("is_reverse", False)
    xs, mask = _time_order(x, _step_mask(ins, x), reverse)
    if _kernel_route(x, "use_pallas_lstm", h0 is not None or c0 is not None):
        hid, cel = fused_lstm(xs, w, b_gate, peephole=peep, mask=mask,
                              gate_act=acts[0], cell_act=acts[1],
                              cand_act=acts[2], h0=h0, c0=c0)
    else:
        hid, cel = lstm_reference(xs, w, b_gate, peep, h0, c0, mask, *acts)
    if reverse:
        hid, cel = hid.flip(1), cel.flip(1)
    return {"Hidden": hid, "Cell": cel}


register_op(
    "dynamic_lstm",
    inputs=["Input", "H0", "C0", "Weight", "Bias", "Length"],
    outputs=["Hidden", "Cell"],
    attrs={
        "use_peepholes": True,
        "is_reverse": False,
        "gate_activation": "sigmoid",
        "cell_activation": "tanh",
        "candidate_activation": "tanh",
    },
    lower=_lower_dynamic_lstm,
    no_grad_inputs=("Length",),
    infer_shape=_infer_rnn_shapes(("Hidden", "Cell")),
)


def _lower_dynamic_gru(ctx, ins, attrs):
    x = ins["Input"][0]  # [B, T, 3D]
    w = ins["Weight"][0]  # [D, 3D]: [:, :2D] gate weights, [:, 2D:] candidate
    d = w.shape[0]
    gate_act = attrs.get("gate_activation", "sigmoid")
    cand_act = attrs.get("activation", "tanh")
    bias = ins.get("Bias", [None])[0]
    bias = bias.reshape(-1) if bias is not None else x.new_zeros((3 * d,))
    w_g, w_c = w[:, :2 * d], w[:, 2 * d:]
    h0 = ins.get("H0", [None])[0]
    reverse = attrs.get("is_reverse", False)
    xs, mask = _time_order(x, _step_mask(ins, x), reverse)
    if _kernel_route(x, "use_pallas_gru", h0 is not None):
        hid = fused_gru(xs, w_g, w_c, bias, mask=mask, gate_act=gate_act,
                        cand_act=cand_act, h0=h0)
    else:
        hid = gru_reference(xs, w_g, w_c, bias, h0, mask, gate_act, cand_act)
    if reverse:
        hid = hid.flip(1)
    return {"Hidden": hid}


register_op(
    "dynamic_gru",
    inputs=["Input", "H0", "Weight", "Bias", "Length"],
    outputs=["Hidden"],
    attrs={
        "is_reverse": False,
        "gate_activation": "sigmoid",
        "activation": "tanh",
    },
    lower=_lower_dynamic_gru,
    no_grad_inputs=("Length",),
    infer_shape=_infer_rnn_shapes(("Hidden",)),
)


# -- the plain recurrent ops: dynamic_lstmp, lstm_unit, gru_unit, row_conv --
# The JAX package runs these four as lax.scan or jnp code with no Pallas
# kernel (rnn_ops.py:182, 349, 372, 421), so plain PyTorch is their port;
# their gradients are autograd's over the lowering, the registry's usual
# route.

# gru_unit's integer activation codes (gru_unit_op.cc)
_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _act(name):
    return _ACTS[name or "tanh"]


def _masked(new, old, m_t):
    return new if m_t is None else new * m_t + old * (1.0 - m_t)


def _lower_dynamic_lstmp(ctx, ins, attrs):
    x = ins["Input"][0]  # [B, T, 4D]
    w = ins["Weight"][0]  # [P, 4D]: the recurrence over the projection
    w_proj = ins["ProjWeight"][0]  # [D, P]
    B, T = x.shape[0], x.shape[1]
    d, p = w_proj.shape[0], w_proj.shape[1]
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))
    proj_act = _act(attrs.get("proj_activation", "identity"))
    bias = ins.get("Bias", [None])[0]
    w_ic = w_fc = w_oc = None
    if bias is not None:
        bias = bias.reshape(-1)
        b_gate = bias[:4 * d]
        if attrs.get("use_peepholes", True):
            w_ic, w_fc, w_oc = (bias[4 * d:5 * d], bias[5 * d:6 * d],
                                bias[6 * d:7 * d])
    else:
        b_gate = x.new_zeros((4 * d,))
    mask = _step_mask(ins, x)
    r = x.new_zeros((B, p))
    c = x.new_zeros((B, d))
    rs, cs = [], []
    for t in range(T):
        m_t = mask[:, t:t + 1] if mask is not None else None
        gates = x[:, t] + r @ w + b_gate
        gi, gf = gates[:, 0 * d:1 * d], gates[:, 1 * d:2 * d]
        gc, go = gates[:, 2 * d:3 * d], gates[:, 3 * d:4 * d]
        if w_ic is not None:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        c_new = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        if w_oc is not None:
            go = go + c_new * w_oc
        h_new = gate_act(go) * cell_act(c_new)
        r = _masked(proj_act(h_new @ w_proj), r, m_t)
        c = _masked(c_new, c, m_t)
        rs.append(r)
        cs.append(c)
    return {"Projection": torch.stack(rs, dim=1),
            "Cell": torch.stack(cs, dim=1)}


register_op(
    "dynamic_lstmp",
    inputs=["Input", "Weight", "ProjWeight", "Bias", "Length"],
    outputs=["Projection", "Cell"],
    attrs={
        "use_peepholes": True,
        "gate_activation": "sigmoid",
        "cell_activation": "tanh",
        "candidate_activation": "tanh",
        "proj_activation": "identity",
    },
    lower=_lower_dynamic_lstmp,
    no_grad_inputs=("Length",),
)


def _lower_lstm_unit(ctx, ins, attrs):
    x = ins["X"][0]  # [B, 4D] pre-projected gates
    c_prev = ins["C_prev"][0]  # [B, D]
    d = c_prev.shape[1]
    i = torch.sigmoid(x[:, 0 * d:1 * d])
    f = torch.sigmoid(x[:, 1 * d:2 * d] + attrs.get("forget_bias", 0.0))
    g = torch.tanh(x[:, 2 * d:3 * d])
    o = torch.sigmoid(x[:, 3 * d:4 * d])
    c = f * c_prev + i * g
    return {"C": c, "H": o * torch.tanh(c)}


register_op(
    "lstm_unit",
    inputs=["X", "C_prev"],
    outputs=["C", "H"],
    attrs={"forget_bias": 0.0},
    lower=_lower_lstm_unit,
)


def _unit_act(value, default):
    """An activation attr of gru_unit: an integer code or a name."""
    if isinstance(value, int) and not isinstance(value, bool):
        return _act(_ACT_CODES.get(value, default))
    return _act(value)


def _lower_gru_unit(ctx, ins, attrs):
    x = ins["Input"][0]  # [B, 3D] projected input
    h_prev = ins["HiddenPrev"][0]  # [B, D]
    w = ins["Weight"][0]  # [D, 3D]
    d = h_prev.shape[1]
    bias = ins.get("Bias", [None])[0]
    b = bias.reshape(-1) if bias is not None else x.new_zeros((3 * d,))
    gate_act = _unit_act(attrs.get("gate_activation", 1), "sigmoid")
    cand_act = _unit_act(attrs.get("activation", 2), "tanh")
    g = x[:, :2 * d] + h_prev @ w[:, :2 * d] + b[:2 * d]
    u = gate_act(g[:, :d])
    r = gate_act(g[:, d:])
    c = cand_act(x[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:] + b[2 * d:])
    h = u * h_prev + (1.0 - u) * c
    return {"Gate": torch.cat([u, r, c], dim=1),
            "ResetHiddenPrev": r * h_prev, "Hidden": h}


register_op(
    "gru_unit",
    inputs=["Input", "HiddenPrev", "Weight", "Bias"],
    outputs=["Gate", "ResetHiddenPrev", "Hidden"],
    attrs={"activation": 2, "gate_activation": 1},
    lower=_lower_gru_unit,
    intermediate_outputs=("Gate", "ResetHiddenPrev"),
)


def _lower_row_conv(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, D]
    f = ins["Filter"][0]  # [future_context + 1, D]
    k, T = f.shape[0], x.shape[1]
    # out[t] = sum_j x[t + j] * f[j], zeros past the end
    padded = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for j in range(int(k)):
        out = out + padded[:, j:j + T, :] * f[j][None, None, :]
    return {"Out": out}


register_op(
    "row_conv",
    inputs=["X", "Filter"],
    outputs=["Out"],
    lower=_lower_row_conv,
)
