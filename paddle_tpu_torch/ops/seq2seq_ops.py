"""The teacher-forced attention-LSTM decoder op: attention_lstm.

Counterpart of ``paddle_tpu/ops/seq2seq_ops.py`` ``attention_lstm``
(attention_lstm_op.cc parity): per target step, one read of simple
attention over the encoder states, then an LSTM cell on [h, context,
x_t]. The JAX package runs it as one ``lax.scan`` with no Pallas kernel,
so the port runs it as a plain loop of PyTorch ops. The whole-loop beam
decoder (``attention_lstm_beam_decode``) waits for the beam-decode
slice.

Attention form (simple_attention in the reference benchmark):
  e[b,s]   = tanh(enc_proj[b,s] @ Wa_e + (h @ Ws) @ Wa_s)
  alpha    = softmax_s(e)  (masked by EncoderLen; a row with no valid
             position gets zero weights, hence a zero context)
  context  = sum_s alpha[b,s] * enc_vec[b,s]
  gates    = [h, context, x_t] @ CellW + CellB   -> standard LSTM cell.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op

NEG_INF = -1e9  # the masked score (beam_search_ops.py _NEG_INF)


def _enc_mask(enc_len, s_len, dtype):
    """``[B, S]`` 1/0 validity mask from optional ``[B]`` lengths."""
    if enc_len is None:
        return None
    lens = enc_len.reshape(-1)
    steps = torch.arange(s_len, device=enc_len.device)
    return (steps[None, :] < lens[:, None]).to(dtype)


def _attend(h, enc_vec, enc_proj, w_state, w_attn, mask):
    """One attention read: h ``[B, D]`` -> (context ``[B, C]``, weights
    ``[B, S]``)."""
    d = w_state.shape[0]
    state_proj = h @ w_state
    wa_e, wa_s = w_attn[:d], w_attn[d:]
    e = torch.tanh(enc_proj @ wa_e + (state_proj @ wa_s)[:, None, :])
    e = e.squeeze(2)
    if mask is not None:
        e = torch.where(mask > 0, e, torch.full_like(e, NEG_INF))
    alpha = torch.softmax(e, dim=1)
    if mask is not None:
        valid = (mask > 0).any(dim=1, keepdim=True)
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    return torch.einsum("bs,bsc->bc", alpha, enc_vec), alpha


def _lstm_cell(h, c, x_t, context, cell_w, cell_b):
    d = h.shape[1]
    gates = torch.cat([h, context, x_t], dim=1) @ cell_w + cell_b
    i = torch.sigmoid(gates[:, 0 * d:1 * d])
    f = torch.sigmoid(gates[:, 1 * d:2 * d])
    g = torch.tanh(gates[:, 2 * d:3 * d])
    o = torch.sigmoid(gates[:, 3 * d:4 * d])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _lower_attention_lstm(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, M] teacher-forced target embeddings
    enc_vec = ins["EncoderVec"][0]  # [B, S, C]
    enc_proj = ins["EncoderProj"][0]  # [B, S, D]
    w_state = ins["StateProjW"][0]  # [D, D]
    w_attn = ins["AttnW"][0]  # [2D, 1]
    cell_w = ins["CellW"][0]  # [D + C + M, 4D]
    cell_b = ins["CellB"][0].reshape(-1)
    h = ins["H0"][0]  # [B, D]
    c = ins.get("C0", [None])[0]
    if c is None:
        c = torch.zeros_like(h)
    enc_len = ins.get("EncoderLen", [None])[0]
    mask = _enc_mask(enc_len, enc_vec.shape[1], x.dtype)
    hs, cs, alphas = [], [], []
    for t in range(x.shape[1]):
        context, alpha = _attend(h, enc_vec, enc_proj, w_state, w_attn,
                                 mask)
        h, c = _lstm_cell(h, c, x[:, t], context, cell_w, cell_b)
        hs.append(h)
        cs.append(c)
        alphas.append(alpha)
    return {"Hidden": torch.stack(hs, dim=1), "Cell": torch.stack(cs, dim=1),
            "AttentionWeight": torch.stack(alphas, dim=1)}


register_op(
    "attention_lstm",
    inputs=[
        "X", "EncoderVec", "EncoderProj", "H0", "C0",
        "StateProjW", "AttnW", "CellW", "CellB", "EncoderLen",
    ],
    outputs=["Hidden", "Cell", "AttentionWeight"],
    lower=_lower_attention_lstm,
    no_grad_inputs=("EncoderLen",),
    intermediate_outputs=("Cell", "AttentionWeight"),
)
