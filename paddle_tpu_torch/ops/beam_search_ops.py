"""Beam-search ops over a dense, static-width lattice: beam_search,
beam_search_decode and slot_beam_search.

Counterpart of ``paddle_tpu/ops/beam_search_ops.py`` (beam_search_op.cc
and beam_search_decode_op.cc parity): a fixed ``[batch, beam]`` lattice
the whole way, finished beams frozen in place (their one candidate is
``end_id`` at an unchanged score), selection one top-K over the
flattened ``[beam * vocab]`` candidates of each batch row.

Ties. ``jax.lax.top_k`` returns equal values lowest index first, and the
lattice has many exact ties (a finished beam fills its row with
``-1e9``, and ``-1e9 + logp`` rounds to a handful of float32 values).
``torch.topk`` promises no order among ties, so ``beam_step`` selects
with a stable descending sort of each ``[K * V]`` row: the K largest,
equal values lowest flat index first, on the CPU and on the card alike.

Token, parent and position tensors stay int64 (``core/types.py``
``device_dtype``); the JAX package narrows them to int32.

Convention for the first step: seed ``pre_scores`` with ``[0, -1e9,
..., -1e9]`` per batch row so that identical initial beams do not give
duplicate candidates.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.ops.sampling_ops import slot_lifecycle_advance

NEG_INF = -1e9


def top_k_lowest_index(flat, k):
    """The ``k`` largest entries of each row of ``flat`` ``[B, N]`` in
    descending order, equal values lowest index first (``jax.lax.top_k``'s
    order): ``(values [B, k], indices [B, k] int64)``."""
    values, index = torch.sort(flat, dim=1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


def beam_step(pre_ids, pre_scores, scores, end_id, is_accumulated=False):
    """One beam-search step over dense ``[B, K, V]`` scores.

    ``pre_ids`` ``[B, K]`` int: the tokens selected at the previous
    step; ``pre_scores`` ``[B, K]`` float: the accumulated log-prob of
    each beam; ``scores`` ``[B, K, V]``: this step's log P(token | beam),
    or the already-accumulated totals when ``is_accumulated`` (then
    ``pre_scores`` only freezes finished beams). Returns
    ``(selected_ids [B, K] (pre_ids' dtype), selected_scores [B, K],
    parent_idx [B, K] int64)``."""
    B, K = pre_ids.shape[0], pre_ids.shape[1]
    V = scores.shape[2]
    finished = pre_ids == end_id
    total = scores if is_accumulated else pre_scores[:, :, None] + scores
    # a finished beam contributes exactly one candidate: (end_id, score)
    total = torch.where(finished[:, :, None],
                        torch.full_like(total, NEG_INF), total)
    end_col = torch.where(finished, pre_scores.to(total.dtype),
                          total[:, :, end_id])
    total = torch.cat([total[:, :, :end_id], end_col[:, :, None],
                       total[:, :, end_id + 1:]], dim=2)
    sel_scores, flat_idx = top_k_lowest_index(total.reshape(B, K * V), K)
    parent = torch.div(flat_idx, V, rounding_mode="floor")
    token = flat_idx - parent * V
    return token.to(pre_ids.dtype), sel_scores, parent


def backtrack(ids, parents, scores=None):
    """Follow parent pointers from the last step back to the first.

    ``ids``, ``parents`` (and ``scores``): ``[T, B, K]``. Returns the
    sentences ``[B, K, T]`` (and, with ``scores``, the per-token scores
    gathered along the same lattice, ``[B, K, T]``); row ``[b, k]`` is
    the sequence that ends in beam slot ``k`` at the last step."""
    T, B, K = ids.shape[0], ids.shape[1], ids.shape[2]
    beam = torch.arange(K, dtype=torch.int64,
                        device=ids.device)[None, :].expand(B, K)
    toks, scs = [], []
    for t in range(T - 1, -1, -1):
        toks.append(torch.gather(ids[t], 1, beam))
        if scores is not None:
            scs.append(torch.gather(scores[t], 1, beam))
        beam = torch.gather(parents[t], 1, beam).to(torch.int64)
    sent = torch.stack(toks[::-1], dim=2)
    if scores is None:
        return sent
    return sent, torch.stack(scs[::-1], dim=2)


def _lower_beam_search(ctx, ins, attrs):
    pre_ids = ins["pre_ids"][0]
    pre_scores = ins["pre_scores"][0]
    scores = ins["scores"][0]  # [B, K, V]
    is_accumulated = attrs.get("is_accumulated", True)
    if not is_accumulated:
        # per-step probabilities (a softmax's output): beam_step adds
        # pre_scores to their log
        scores = torch.log(torch.clamp(scores, min=1e-20))
    ids, sel_scores, parent = beam_step(
        pre_ids, pre_scores, scores, attrs.get("end_id", 0),
        is_accumulated=is_accumulated)
    return {"selected_ids": ids, "selected_scores": sel_scores,
            "parent_idx": parent}


register_op(
    "beam_search",
    inputs=["pre_ids", "pre_scores", "scores"],
    outputs=["selected_ids", "selected_scores", "parent_idx"],
    attrs={"beam_size": 4, "end_id": 0, "is_accumulated": True, "level": 0},
    lower=_lower_beam_search,
    grad=None,
)


def _lower_beam_search_decode(ctx, ins, attrs):
    ids = ins["Ids"][0]  # [T, B, K]
    parents = ins["ParentIdx"][0]
    scores = ins.get("Scores", [None])[0]
    if scores is None:
        sentences = backtrack(ids, parents)
        sent_scores = torch.zeros(sentences.shape, dtype=torch.float32,
                                  device=ids.device)
    else:
        sentences, sent_scores = backtrack(ids, parents, scores)
    return {"SentenceIds": sentences, "SentenceScores": sent_scores}


register_op(
    "beam_search_decode",
    inputs=["Ids", "ParentIdx", "Scores"],
    outputs=["SentenceIds", "SentenceScores"],
    attrs={"beam_size": 4, "end_id": 0},
    lower=_lower_beam_search_decode,
    grad=None,
)


def _lower_slot_beam_search(ctx, ins, attrs):
    """Beam selection over the serving slot pool
    (``serving.generation.SlotDecodeSession(beam_width=K)``): the ``S =
    B * K`` slots are beam lanes of K aligned hypotheses (slot ``s`` is
    hypothesis ``s % K`` of lane ``s // K``) and one ``beam_step`` runs
    every lane's ``[K, V]`` lattice. Done hypotheses are forced to
    ``eos`` before the lattice (a length-capped one then freezes like a
    finished one); each survivor takes its parent's position and done
    latch, and the lifecycle advances by ``slot_lifecycle_advance``.

    Inputs: Logits ``[S, 1, V]``; Tok / Pos / Done ``[S, 1]`` int; Score
    ``[S, 1]`` float. Outputs: Out, PosOut, DoneOut, ScoreOut and
    ParentOut ``[S, 1]``, the last the GLOBAL parent slot (lane base +
    local parent) that the step program gathers the page-table rows by
    and the host rebinds the refcounts by."""
    lg = ins["Logits"][0][:, 0, :].to(torch.float32)  # [S, V]
    tok = ins["Tok"][0]
    pos = ins["Pos"][0]
    done = ins["Done"][0]
    score = ins["Score"][0]
    K = int(attrs.get("beam_width", 0))
    eos = int(attrs.get("eos_id", 2))
    max_len = int(attrs.get("max_length", 0))
    S = lg.shape[0]
    if K < 2:
        raise ValueError(
            "slot_beam_search: beam_width attr must be >= 2 (width 1 "
            "is the sampler path), got %d" % K)
    if S % K:
        raise ValueError(
            "slot_beam_search: %d slots do not tile into beam lanes "
            "of width %d" % (S, K))
    if max_len < 2:
        raise ValueError(
            "slot_beam_search: max_length attr must be >= 2, got %d"
            % max_len)
    B = S // K
    done_flat = done.reshape(-1) > 0
    pos_flat = pos.reshape(-1)
    tok_flat = tok.reshape(-1).to(torch.int64)
    pre_tok = torch.where(done_flat, torch.full_like(tok_flat, eos),
                          tok_flat)
    logp = torch.log_softmax(lg, dim=-1)
    sel_tok, sel_score, parent = beam_step(
        pre_tok.reshape(B, K), score.reshape(B, K).to(torch.float32),
        logp.reshape(B, K, -1), eos, is_accumulated=False)
    base = torch.arange(B, dtype=torch.int64, device=lg.device)[:, None] * K
    parent_global = (base + parent).reshape(-1)
    p_pos = pos_flat[parent_global]
    p_done = done_flat[parent_global]
    new_tok = sel_tok.reshape(-1)
    new_pos, new_done = slot_lifecycle_advance(p_pos, p_done, new_tok, eos,
                                               max_len)
    return {
        "Out": new_tok[:, None],
        "PosOut": new_pos.reshape(pos.shape).to(pos.dtype),
        "DoneOut": new_done.to(torch.int64)[:, None],
        "ScoreOut": sel_score.reshape(-1, 1),
        "ParentOut": parent_global[:, None],
    }


register_op(
    "slot_beam_search",
    inputs=["Logits", "Tok", "Pos", "Done", "Score"],
    outputs=["Out", "PosOut", "DoneOut", "ScoreOut", "ParentOut"],
    attrs={"beam_width": 0, "eos_id": 2, "max_length": 0},
    lower=_lower_slot_beam_search,
    grad=None,
    no_grad_inputs=("Tok", "Pos", "Done"),
)
