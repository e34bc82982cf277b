"""Linear-chain CRF ops: the NLL and Viterbi decoding.

Counterpart of ``paddle_tpu/ops/crf_ops.py`` (linear_chain_crf_op.cc and
crf_decoding_op.cc parity, the label_semantic_roles book chapter), with
the same inputs, outputs, dtypes and padding. The transitions are
``[num_tags + 2, num_tags]``: row 0 the start weights, row 1 the stop
weights, rows 2.. tag to tag.

The two recursions are the port's own kernels (``kernels/crf.py``): the
log-partition's forward recursion and, for its gradient, the beta
recursion (K3 ``crf_logz``), and the Viterbi recursion with its
backtrack (K4 ``crf_viterbi``), each one launch on the card where the
JAX package runs a ``lax.scan``. The gold path's score stays in torch
ops (``crf_ops.py:57-73``).
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.kernels.crf import crf_logz, crf_viterbi
from paddle_tpu_torch.ops.common import optional_lengths


def _lower_linear_chain_crf(ctx, ins, attrs):
    x = ins["Emission"][0]  # [B, T, K]
    trans = ins["Transition"][0]  # [K + 2, K]
    b, t, _ = x.shape
    label = ins["Label"][0].reshape(b, -1).to(torch.int64)
    lens = optional_lengths(ins, x)
    a, stop, w = trans[0], trans[1], trans[2:]
    mask = (torch.arange(t, device=x.device)[None, :]
            < lens[:, None]).to(x.dtype)
    alpha, log_z = crf_logz(x, trans, lens)
    # the gold path's score
    emit = torch.gather(x, 2, label[:, :, None])[:, :, 0]
    emit_score = (emit * mask).sum(1)
    trans_score = (w[label[:, :-1], label[:, 1:]] * mask[:, 1:]).sum(1)
    if ins.get("Length"):
        last = mask.sum(1).to(torch.int64) - 1
    else:
        last = torch.full((b,), t - 1, dtype=torch.int64, device=x.device)
    # a row of length 0 reads its last column, as jnp's negative index
    last_tag = torch.gather(label, 1, torch.remainder(last, t)[:, None])[
        :, 0]
    gold = emit_score + trans_score + a[label[:, 0]] + stop[last_tag]
    return {
        "Alpha": alpha,
        "EmissionExps": torch.exp(x),
        "TransitionExps": torch.exp(trans),
        "LogLikelihood": (log_z - gold)[:, None],
    }


register_op(
    "linear_chain_crf",
    inputs=["Emission", "Transition", "Label", "Length"],
    outputs=["Alpha", "EmissionExps", "TransitionExps", "LogLikelihood"],
    lower=_lower_linear_chain_crf,
    no_grad_inputs=("Label", "Length"),
    intermediate_outputs=("Alpha", "EmissionExps", "TransitionExps"),
)


def _lower_crf_decoding(ctx, ins, attrs):
    x = ins["Emission"][0]
    b, t, _ = x.shape
    lens = optional_lengths(ins, x)
    path = crf_viterbi(x, ins["Transition"][0], lens)
    label = ins.get("Label", [None])[0]
    if label is not None:
        live = torch.arange(t, device=x.device)[None, :] < lens[:, None]
        path = torch.where(live, (path == label.reshape(b, -1)).to(
            torch.int64), torch.zeros_like(path))
    return {"ViterbiPath": path}


register_op(
    "crf_decoding",
    inputs=["Emission", "Transition", "Label", "Length"],
    outputs=["ViterbiPath"],
    lower=_lower_crf_decoding,
    grad=None,
)
