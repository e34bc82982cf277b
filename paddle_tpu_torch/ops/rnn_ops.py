"""Recurrent ops over dense-padded sequences: dynamic_lstm, dynamic_gru.

Counterpart of ``paddle_tpu/ops/rnn_ops.py`` for the two ops of the RNN
slice, with the same inputs, outputs, attrs and dense-shape contract:
Input ``[B, T, gates * D]`` (the projected input x @ W_x), Weight the
recurrence weights, Bias ``[1, gates * D]`` (plus the three peephole
vectors for an LSTM with ``use_peepholes``), an optional ``[B]`` Length
that masks the padded steps.

Routing. On a CUDA tensor both ops launch their hand-written kernel
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
from paddle_tpu_torch.kernels.lstm_cell import fused_lstm, lstm_reference


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
