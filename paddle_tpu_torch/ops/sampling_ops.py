"""Decode-loop token selection: slot_decode_sample (greedy).

Counterpart of ``paddle_tpu/ops/sampling_ops.py`` ``slot_decode_sample``,
``sample_step_tokens`` and ``slot_lifecycle_advance``. The port carries
the greedy strategy; temperature and top-k sampling key jax's threefry
stream on (seed, slot, position), and reproducing those bits is the
RNG-parity item of ROADMAP.md (A6), so the port raises for them instead
of sampling other tokens. ``sample_step_tokens`` is the one token rule
the plain step and the speculative accept walk
(``ops/speculative_ops.py``) share, which is what makes a speculative
stream equal to the sequential one.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op

RNG_PARITY_TODO = (
    "sampled decode (temperature / top_k) needs jax-threefry-exact random "
    "bits, which the port does not have yet (ROADMAP.md, A6 RNG parity); "
    "the port serves greedy decoding only")


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


def sample_step_tokens(lg, strategy, temperature):
    """The token choice of one decode position over ``[S, V]`` float32
    logits: argmax for the greedy strategy (or a temperature of 0),
    returning the first maximum on ties as ``jnp.argmax`` does. Any
    stochastic strategy raises (``RNG_PARITY_TODO``). Returns flat
    ``[S]`` int64 tokens, with no eos forcing."""
    if strategy != "greedy" and float(temperature) > 0.0:
        raise NotImplementedError(RNG_PARITY_TODO)
    return torch.argmax(lg, dim=-1)


def _lower_slot_decode_sample(ctx, ins, attrs):
    """Greedy per-slot token choice over ``[S, 1, V]`` logits, eos forced
    on finished slots, then the lifecycle step."""
    max_len = int(attrs.get("max_length", 0))
    if max_len < 2:
        raise ValueError(
            "slot_decode_sample: max_length attr must be >= 2 (the decode "
            "budget; positions clamp to max_length - 1), got %d" % max_len)
    eos = int(attrs.get("eos_id", 2))
    lg = ins["Logits"][0][:, 0, :].to(torch.float32)
    pos = ins["Pos"][0]
    pos_flat = pos.reshape(-1)
    tok = sample_step_tokens(lg, attrs.get("strategy", "greedy"),
                             attrs.get("temperature", 1.0))
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
