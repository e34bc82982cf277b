"""Speculative-decoding ops: tree write, accept walk, survivor commit.

Counterpart of ``paddle_tpu/ops/speculative_ops.py``: the verify side of
speculative decoding over the paged slot pool
(``serving/generation.py`` ``SlotDecodeSession(speculative=...)``). A
host drafter proposes K tokens per slot as a speculation tree (node 0 is
the anchor, the slot's current token; draft node ``i`` extends node
``parent[i]``); the target model scores every node in one dispatch
through ``paged_tree_attention``; then ``slot_speculative_accept``
replays the sequential token rule down the tree and commits the longest
draft prefix the target itself would have emitted, plus one correction
or bonus token.

The accept walk chooses each position's token through
``sampling_ops.sample_step_tokens`` and advances the slot through
``slot_lifecycle_advance``, the very functions ``slot_decode_sample``
uses, so the committed stream equals the ``FLAGS_speculative=off``
stream: the drafter decides how MANY tokens land per dispatch, never
WHICH. Greedy only: a stochastic strategy raises like
``slot_decode_sample`` does (ROADMAP.md A6).

The two pool writers update the pools in place, as ``paged_kv_write``
does, and bind ``KOut``/``VOut`` back onto the pool variables.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.kernels.paged_attention import (
    paged_kv_compact,
    paged_kv_write_block,
)
from paddle_tpu_torch.ops.sampling_ops import (
    sample_step_tokens,
    slot_lifecycle_advance,
)


def _lower_paged_spec_kv_write(ctx, ins, attrs):
    """Tree write: all N nodes' K/V rows land in the slot's write pages at
    storage positions ``pos .. pos + N - 1`` (node 0, the anchor, at
    ``pos``, where the plain step would write it). Finished slots pass an
    all-trash table row, and rows past the table's coverage go to the
    trash page inside ``paged_kv_write_block``."""
    k_new = ins["KNew"][0]  # [S, H, N, dh]
    S, _, N, _ = k_new.shape
    pos = ins["Pos"][0].reshape(-1, 1).to(torch.int64)
    table = ins["PageTable"][0].reshape(S, -1)
    positions = pos + torch.arange(N, device=pos.device)[None, :]
    k_out, v_out = paged_kv_write_block(
        ins["KPool"][0], ins["VPool"][0], k_new, ins["VNew"][0], table,
        positions)
    return {"KOut": k_out, "VOut": v_out}


register_op(
    "paged_spec_kv_write",
    inputs=["KPool", "VPool", "KNew", "VNew", "PageTable", "Pos"],
    outputs=["KOut", "VOut"],
    lower=_lower_paged_spec_kv_write,
    grad=None,
    no_grad_inputs=("PageTable", "Pos"),
)


def _lower_paged_spec_kv_compact(ctx, ins, attrs):
    """Survivor commit: the accepted path's K/V rows move to their
    canonical storage positions (``pos + j`` gets node ``path[j]``'s row
    for ``1 <= j < accept_len``). Rejected branches' rows stay behind
    past the new resident length, never attended again and overwritten by
    the next dispatch's tree."""
    path = ins["Path"][0]
    S = path.shape[0]
    k_out, v_out = paged_kv_compact(
        ins["KPool"][0], ins["VPool"][0],
        ins["PageTable"][0].reshape(S, -1), ins["Pos"][0].reshape(-1),
        path.reshape(S, -1), ins["AcceptLen"][0].reshape(-1))
    return {"KOut": k_out, "VOut": v_out}


register_op(
    "paged_spec_kv_compact",
    inputs=["KPool", "VPool", "PageTable", "Pos", "Path", "AcceptLen"],
    outputs=["KOut", "VOut"],
    lower=_lower_paged_spec_kv_compact,
    grad=None,
    no_grad_inputs=("PageTable", "Pos", "Path", "AcceptLen"),
)


def _lower_slot_speculative_accept(ctx, ins, attrs):
    """The in-graph accept/reject walk. Per slot, starting at the anchor
    (node 0, sequence position ``pos``):

    1. choose token ``u`` from the current node's logits with the
       sequential rule (``sample_step_tokens``);
    2. commit ``u`` and advance the lifecycle (``slot_lifecycle_advance``:
       done latches on eos or when the budget runs out);
    3. if a draft child of the current node carries exactly ``u`` (and its
       storage position lies inside the decode budget), descend into the
       first such child and repeat; otherwise stop: ``u`` was the
       correction (or bonus) token and is the next dispatch's anchor.

    Every live slot commits at least 1 token and at most N. Entries of
    ``TokSeq`` past ``AcceptLen`` are eos padding. ``Path[j]`` names the
    tree node whose K/V row backs committed token ``j`` (for
    ``1 <= j < AcceptLen``; identity elsewhere), the gather map of
    ``paged_spec_kv_compact``. ``Out`` is the new anchor token (eos for
    finished slots). The walk is N unrolled levels of small tensor ops
    and reads no value on the host."""
    lg = ins["Logits"][0].to(torch.float32)  # [S, N, V]
    S, N, _ = lg.shape
    dev = lg.device
    nodes = ins["Nodes"][0].reshape(S, N).to(torch.int64)
    parent = ins["Parent"][0].reshape(S, N).to(torch.int64)
    pos = ins["Pos"][0]
    pos_flat = pos.reshape(-1)
    was_done = ins["Done"][0].reshape(-1) > 0
    strategy = attrs.get("strategy", "greedy")
    temperature = float(attrs.get("temperature", 1.0))
    eos = int(attrs.get("eos_id", 2))
    max_len = int(attrs.get("max_length", 0))
    if max_len < 2:
        raise ValueError(
            "slot_speculative_accept: max_length attr must be >= 2 (the "
            "decode budget), got %d" % max_len)

    rows = torch.arange(S, device=dev)
    j_idx = torch.arange(N, device=dev)[None, :]
    in_budget = (j_idx >= 1) & (pos_flat.to(torch.int64)[:, None] + j_idx
                                < max_len)
    cur = torch.zeros(S, dtype=torch.int64, device=dev)
    posq = pos_flat
    done_s = was_done
    stopped = was_done  # a finished slot never walks
    acc_len = torch.zeros(S, dtype=torch.int64, device=dev)
    path = j_idx.repeat(S, 1)
    eos_col = torch.full((S,), eos, dtype=torch.int64, device=dev)
    tok_cols = []
    for d in range(N):
        active = ~stopped
        u = sample_step_tokens(lg[rows, cur], strategy, temperature)
        adv_pos, adv_done = slot_lifecycle_advance(posq, done_s, u, eos,
                                                   max_len)
        new_done = torch.where(active, adv_done, done_s)
        # a draft child carrying the target's own token, storage in budget
        match = (parent == cur[:, None]) & in_budget & (nodes == u[:, None])
        # argmax of 0/1 returns the first maximum: the first matching child
        child = torch.argmax(match.to(torch.int64), dim=1)
        cont = active & ~new_done & match.any(dim=1)
        if d + 1 < N:
            path[:, d + 1] = torch.where(cont, child, path[:, d + 1])
        tok_cols.append(torch.where(active, u, eos_col))
        acc_len = acc_len + active.to(torch.int64)
        stopped = stopped | (active & ~cont)
        cur = torch.where(cont, child, cur)
        posq = torch.where(active, adv_pos, posq)
        done_s = new_done

    toks = torch.stack(tok_cols, dim=1)  # [S, N]
    last = (acc_len - 1).clamp(0, N - 1)
    anchor = torch.where(acc_len > 0, toks[rows, last], eos_col)
    return {
        "Out": anchor[:, None],
        "TokSeq": toks,
        "AcceptLen": acc_len[:, None],
        "Path": path,
        "PosOut": posq.reshape(pos.shape).to(pos.dtype),
        "DoneOut": done_s.to(torch.int64)[:, None],
    }


register_op(
    "slot_speculative_accept",
    inputs=["Logits", "Nodes", "Parent", "Pos", "Done"],
    outputs=["Out", "TokSeq", "AcceptLen", "Path", "PosOut", "DoneOut"],
    attrs={"strategy": "greedy", "temperature": 1.0, "top_k": 0,
           "base_seed": 0, "eos_id": 2, "max_length": 0},
    lower=_lower_slot_speculative_accept,
    grad=None,
    no_grad_inputs=("Nodes", "Parent", "Pos", "Done"),
)
