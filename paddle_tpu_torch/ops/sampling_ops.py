"""Decode-loop token selection (slot_decode_sample) and the sampled and
factorized softmax costs (nce, hierarchical_sigmoid).

Counterpart of ``paddle_tpu/ops/sampling_ops.py`` ``slot_decode_sample``,
``sample_step_tokens`` and ``slot_lifecycle_advance``: greedy argmax, or
temperature / top-k sampling from jax's threefry stream
(``core/prng.py``) keyed on ``fold_in(fold_in(PRNGKey(base_seed),
slot), position)``, as the JAX package keys it. The key depends only on
(seed, slot, position), never on the run's key, so a sampled decode
loop captures like a greedy one, and ``sample_step_tokens`` is the one
token rule the plain step and the speculative accept walk
(``ops/speculative_ops.py``) share, which is what makes a sampled
speculative stream equal to the sequential one. On the card each
sampled position is one launch of the threefry kernel (the per-slot
key folds and the Gumbel uniforms together).
"""

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.op_registry import register_op


def slot_lifecycle_advance(pos_flat, was_done, tok, eos, max_len):
    """The slot-pool lifecycle arithmetic, exactly as the reference: a
    live slot advances to ``pos + 1`` (clamped to ``max_len - 1`` so the
    KV write of a max-length slot stays in bounds), a finished slot
    freezes, and the done latch trips on eos or when the decode budget
    runs out. Flat ``[S]`` inputs; returns ``(new_pos, new_done)``, done
    as bool."""
    nxt_pos = torch.clamp(pos_flat + 1, max=max_len - 1)
    new_pos = torch.where(was_done, pos_flat, nxt_pos)
    new_done = was_done | (tok == eos) | (pos_flat + 1 >= max_len - 1)
    return new_pos, new_done


def sample_step_tokens(lg, pos_flat, strategy, temperature, top_k,
                       base_seed):
    """The token choice of one decode position over ``[S, V]`` float32
    logits at the per-slot sequence positions ``pos_flat``: argmax for
    the greedy strategy or a temperature of 0 (the first maximum on
    ties, as ``jnp.argmax``); otherwise the logits scaled by the
    temperature (a product with its float32 reciprocal, as XLA divides
    by a constant), cut below the ``top_k``-th value for ``top_k``, and
    ``categorical`` with slot ``s``'s key ``fold_in(fold_in(
    PRNGKey(base_seed), s), pos_flat[s])``. Returns flat ``[S]`` int64
    tokens, with no eos forcing."""
    temperature = float(temperature)
    if strategy == "greedy" or temperature <= 0.0:
        return torch.argmax(lg, dim=-1)
    S = lg.shape[0]
    # the float32 reciprocal as a Python number: exact in the product,
    # and no host-to-device copy inside a captured loop
    inv = float(np.float32(1.0) / np.float32(temperature))
    scaled = lg * inv
    top_k = int(top_k)
    if strategy == "top_k" and top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth,
                             torch.full_like(scaled, float("-inf")), scaled)
    slots = torch.arange(S, dtype=torch.int64, device=lg.device)
    key = prng.KeyChain(prng.PRNGKey_pair(base_seed)).fold_in(
        slots).fold_in(pos_flat.reshape(-1))
    return prng.categorical(key, scaled)


def _lower_slot_decode_sample(ctx, ins, attrs):
    """Per-slot token choice over ``[S, 1, V]`` logits
    (``sample_step_tokens``), eos forced on finished slots, then the
    lifecycle step."""
    max_len = int(attrs.get("max_length", 0))
    if max_len < 2:
        raise ValueError(
            "slot_decode_sample: max_length attr must be >= 2 (the decode "
            "budget; positions clamp to max_length - 1), got %d" % max_len)
    eos = int(attrs.get("eos_id", 2))
    lg = ins["Logits"][0][:, 0, :].to(torch.float32)
    pos = ins["Pos"][0]
    pos_flat = pos.reshape(-1)
    tok = sample_step_tokens(lg, pos_flat, attrs.get("strategy", "greedy"),
                             attrs.get("temperature", 1.0),
                             attrs.get("top_k", 0),
                             int(attrs.get("base_seed", 0)))
    done_in = ins.get("Done", [None])[0]
    if done_in is not None:
        was_done = done_in.reshape(-1) > 0
        tok = torch.where(was_done, torch.full_like(tok, eos), tok)
    else:
        was_done = torch.zeros_like(tok, dtype=torch.bool)
    new_pos, new_done = slot_lifecycle_advance(
        pos_flat, was_done, tok, eos, max_len)
    return {
        "Out": tok[:, None],
        "PosOut": new_pos.reshape(pos.shape).to(pos.dtype),
        "DoneOut": new_done.to(torch.int64)[:, None],
    }


register_op(
    "slot_decode_sample",
    inputs=["Logits", "Pos", "Done"],
    outputs=["Out", "PosOut", "DoneOut"],
    attrs={"strategy": "greedy", "temperature": 1.0, "top_k": 0,
           "base_seed": 0, "eos_id": 2, "max_length": 0},
    lower=_lower_slot_decode_sample,
    grad=None,
    no_grad_inputs=("Pos", "Done"),
)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _lower_nce(ctx, ins, attrs):
    """nce_op.cc with the uniform sampler (``sampling_ops.py:19-61``):
    ``num_neg_samples`` negatives a row drawn with ``randint`` from the
    op's threefry key (``ctx.rng()``, the JAX package's key, so the same
    classes), the logits of the true and sampled classes corrected by
    log(k q(y)), the logistic NCE cost ``[B, 1]``."""
    x = ins["Input"][0]  # [B, D]
    w = ins["Weight"][0]  # [V, D]
    b = x.shape[0]
    label = ins["Label"][0].reshape(b, -1).to(torch.int64)  # [B, Nt]
    bias = ins.get("Bias", [None])[0]
    num_total = int(attrs.get("num_total_classes", w.shape[0]))
    num_neg = int(attrs.get("num_neg_samples", 10))
    n_true = label.shape[1]
    if int(attrs.get("sampler", 0)) != 0:
        raise NotImplementedError(
            "nce: only the uniform sampler is lowered; log_uniform/"
            "custom_dist need their own noise-probability correction")
    key = ctx.rng()
    if key is None:  # build-time shape inference
        neg = torch.zeros((b, num_neg), dtype=torch.int64, device=x.device)
    else:
        neg = prng.randint(key, (b, num_neg), 0, num_total, device=x.device)
    samples = torch.cat([label, neg], 1)  # [B, Nt + Nn]
    logits = torch.einsum("bd,bsd->bs", x, w[samples])
    if bias is not None:
        logits = logits + bias.reshape(-1)[samples]
    # the uniform noise q = 1 / V: log(k q) in float32, as jnp.log takes it
    adjusted = logits - float(np.log(np.float32(num_neg / num_total)))
    cost = (_softplus(-adjusted[:, :n_true]).sum(1, keepdim=True) / n_true
            + _softplus(adjusted[:, n_true:]).sum(1, keepdim=True))
    sample_weight = ins.get("SampleWeight", [None])[0]
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1, 1)
    return {"Cost": cost, "SampleLogits": logits, "SampleLabels": samples}


register_op(
    "nce",
    inputs=["Input", "Label", "Weight", "Bias", "SampleWeight"],
    outputs=["Cost", "SampleLogits", "SampleLabels"],
    attrs={"num_total_classes": 0, "num_neg_samples": 10, "sampler": 0,
           "seed": 0, "is_sparse": False},
    lower=_lower_nce,
    no_grad_inputs=("Label", "SampleWeight"),
    intermediate_outputs=("SampleLogits", "SampleLabels"),
)


def _lower_hierarchical_sigmoid(ctx, ins, attrs):
    """hierarchical_sigmoid_op.cc over a complete binary tree in heap
    order (``sampling_ops.py:79-108``): class c's leaf is node c +
    num_classes, internal node n's weights are row n - 1; the cost sums
    -log P(bit | node) along the path, ``PreOut`` holds each level's
    logit (0 above the root)."""
    x = ins["X"][0]  # [B, D]
    w = ins["W"][0]  # [num_classes - 1, D]
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    bias = ins.get("Bias", [None])[0]
    num_classes = int(attrs.get("num_classes", w.shape[0] + 1))
    code = label + num_classes
    max_depth = max(1, int(num_classes - 1).bit_length())
    losses = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    pre_out = []
    for j in range(max_depth, 0, -1):
        node = code >> j
        valid = node >= 1
        bit = (code >> (j - 1)) & 1
        row = (node - 1).clamp(0, num_classes - 2)
        s = (x * w[row]).sum(1)
        if bias is not None:
            s = s + bias.reshape(-1)[row]
        step = _softplus(s) - bit.to(s.dtype) * s
        zero = torch.zeros_like(s)
        losses = losses + torch.where(valid, step, zero)[:, None]
        pre_out.append(torch.where(valid, s, zero))
    return {"Out": losses, "PreOut": torch.stack(pre_out, 1)}


register_op(
    "hierarchical_sigmoid",
    inputs=["X", "W", "Label", "Bias"],
    outputs=["Out", "PreOut"],
    attrs={"num_classes": 2},
    lower=_lower_hierarchical_sigmoid,
    no_grad_inputs=("Label",),
    intermediate_outputs=("PreOut",),
)
