"""Fused ops that the inference passes (``core/passes.py``) produce: fc,
fusion_lstm, fusion_gru, fused_embedding_fc_lstm,
fusion_seqconv_eltadd_relu and fusion_seqexpand_concat_fc.

Counterpart of ``paddle_tpu/ops/fused_ops.py`` for these six (the
reference's fc_op, fusion_{lstm,gru}_op and fusion_seq* ops, targets of
fc_fuse_pass.cc, fc_{lstm,gru}_fuse_pass.cc and
seqconv_eltadd_relu_fuse_pass.cc). Each is a composition of the ops it
replaces: the projection is one matrix product, and the recurrence goes
through ``dynamic_lstm`` / ``dynamic_gru``'s lowering, so on the card a
fused op launches the ``lstm_cell`` / ``gru_cell`` kernel as the op it
replaced did.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.ops.common import flatten_to_2d
from paddle_tpu_torch.ops.rnn_ops import (
    _infer_rnn_shapes,
    _lower_dynamic_gru,
    _lower_dynamic_lstm,
)
from paddle_tpu_torch.ops.sequence_ops import _lower_sequence_conv
from paddle_tpu_torch.ops.tensor_ops import _lower_lookup_table

# the activations fc_fuse absorbs (gelu as jax.nn.gelu computes it: the
# tanh form)
_ACT = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


def _lower_fc(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["W"][0]
    n = attrs.get("in_num_col_dims", 1)
    out = flatten_to_2d(x, n) @ w
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    act = attrs.get("activation_type", "")
    if act:
        out = _ACT[act](out)
    return out.reshape(tuple(x.shape[:n]) + (w.shape[1],))


register_op(
    "fc",
    inputs=["Input", "W", "Bias"],
    outputs=["Out"],
    attrs={"in_num_col_dims": 1, "activation_type": ""},
    lower=_lower_fc,
)


def _project_then(delegate, ctx, ins, attrs):
    """fusion_lstm / fusion_gru: the input projection X @ WeightX (+
    BiasX, the absorbed fc bias) feeding the recurrence's own lowering."""
    proj = ins["X"][0] @ ins["WeightX"][0]
    if ins.get("BiasX"):
        proj = proj + ins["BiasX"][0].reshape(-1)
    inner = dict(ins)
    inner["Input"] = [proj]
    inner["Weight"] = ins["WeightH"]
    return delegate(ctx, inner, attrs)


def _lower_fusion_lstm(ctx, ins, attrs):
    return _project_then(_lower_dynamic_lstm, ctx, ins, attrs)


def _lower_fusion_gru(ctx, ins, attrs):
    return _project_then(_lower_dynamic_gru, ctx, ins, attrs)


def _lower_fused_embedding_fc_lstm(ctx, ins, attrs):
    """lookup_table + projection + LSTM (fused_embedding_fc_lstm_op.cc
    role); the table and the projection weight stay separate, as in the
    JAX package."""
    emb = _lower_lookup_table(
        ctx, {"W": ins["Embeddings"], "Ids": ins["Ids"]},
        {"padding_idx": attrs.get("padding_idx", -1)})
    inner = dict(ins)
    inner["X"] = [emb]
    return _lower_fusion_lstm(ctx, inner, attrs)


_LSTM_ATTRS = {
    "use_peepholes": True,
    "is_reverse": False,
    "gate_activation": "sigmoid",
    "cell_activation": "tanh",
    "candidate_activation": "tanh",
}

register_op(
    "fusion_lstm",
    inputs=["X", "WeightX", "WeightH", "Bias", "BiasX", "H0", "C0",
            "Length"],
    outputs=["Hidden", "Cell"],
    attrs=_LSTM_ATTRS,
    lower=_lower_fusion_lstm,
    no_grad_inputs=("Length",),
    infer_shape=_infer_rnn_shapes(("Hidden", "Cell"), "X", "WeightH"),
)

register_op(
    "fusion_gru",
    inputs=["X", "WeightX", "WeightH", "Bias", "BiasX", "H0", "Length"],
    outputs=["Hidden"],
    attrs={"is_reverse": False, "gate_activation": "sigmoid",
           "activation": "tanh"},
    lower=_lower_fusion_gru,
    no_grad_inputs=("Length",),
    infer_shape=_infer_rnn_shapes(("Hidden",), "X", "WeightH"),
)

register_op(
    "fused_embedding_fc_lstm",
    inputs=["Ids", "Embeddings", "WeightX", "WeightH", "Bias", "BiasX",
            "H0", "C0", "Length"],
    outputs=["Hidden", "Cell"],
    attrs=dict(_LSTM_ATTRS, padding_idx=-1),
    lower=_lower_fused_embedding_fc_lstm,
    no_grad_inputs=("Ids", "Length"),
    infer_shape=_infer_rnn_shapes(("Hidden", "Cell"), "Ids", "WeightH"),
)


def _lower_fusion_seqconv_eltadd_relu(ctx, ins, attrs):
    """sequence_conv + bias add + relu in one op."""
    out = _lower_sequence_conv(ctx, ins, attrs)["Out"]
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(-1)
    return torch.relu(out)


register_op(
    "fusion_seqconv_eltadd_relu",
    inputs=["X", "Filter", "Bias", "Length"],
    outputs=["Out"],
    attrs={"contextLength": 3, "contextStart": -1, "contextStride": 1},
    lower=_lower_fusion_seqconv_eltadd_relu,
    no_grad_inputs=("Length",),
)


def _lower_fusion_seqexpand_concat_fc(ctx, ins, attrs):
    """X[0] is the sequence [B, T, M0]; every further X[i] a per-sequence
    vector [B, Mi] broadcast along T (the sequence_expand), all
    concatenated and run through one fc."""
    xs = ins["X"]
    t = xs[0].shape[1]
    cols = [xs[0]] + [v[:, None, :].expand(v.shape[0], t, v.shape[1])
                      for v in xs[1:]]
    out = torch.cat(cols, dim=-1) @ ins["FCWeight"][0]
    if ins.get("FCBias"):
        out = out + ins["FCBias"][0].reshape(-1)
    return {"Out": _ACT[attrs.get("fc_activation", "identity")](out),
            "FCOut": out}


register_op(
    "fusion_seqexpand_concat_fc",
    inputs=["*X", "FCWeight", "FCBias"],
    outputs=["Out", "FCOut"],
    attrs={"fc_activation": "identity"},
    intermediate_outputs=("FCOut",),
    lower=_lower_fusion_seqexpand_concat_fc,
)
