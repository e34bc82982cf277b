"""Mixture-of-Experts FFN: Switch-Transformer routing with a fixed
per-expert capacity.

Counterpart of ``paddle_tpu/ops/moe_ops.py`` (expert parallelism, A10,
aside). The JAX package dispatches and combines through dense
``[N, E, C]`` one-hot einsums, static shapes for XLA. Here the same
routing is computed with indices: each kept route names one slot
``expert * C + position`` of the ``[E * C, D]`` expert buffer, the
tokens are scattered there (``index_add``) and the expert outputs
gathered back, weighted by the combine gates. No two routes share a
slot (positions run in token order and earlier routes advance the
queues), so every buffer entry is exactly the one einsum term that is
not zero, and the gradients are the einsums' too. The semantics are the
JAX package's, exactly:

- ``capacity = max(1, int(capacity_factor * n * top_k / e))``;
- a token's position in its expert's queue is its rank in token order,
  after every earlier route's assignments (dropped ones included);
- a route past the capacity is dropped; a padding token (``Mask`` 0)
  has zero router probabilities and takes no queue slot;
- with top_k > 1 the gates are divided by the sum of the selected
  *pre-drop* gates plus 1e-9;
- the aux loss is ``E * sum_e f_e * P_e`` over valid tokens, f from the
  pre-drop top-1 choice;
- routing is an argmax (the first of tied experts), so the gradient
  reaches X and the gate weights only through the combine gates (and
  the aux loss's P).

The expert products are batched matrix products (``torch.bmm``), as the
JAX package computes them with XLA outside any Pallas kernel.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.ops.activation_ops import _gelu

_ACTS = {
    "relu": torch.relu,
    "gelu": _gelu,  # jax.nn.gelu's default, the tanh form
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "identity": lambda v: v,
}


def _one_hot(idx, e, dtype):
    """A comparison, so no value is read on the host (F.one_hot checks
    the indices' range with a device sync)."""
    return (idx[:, None] == torch.arange(e, device=idx.device)).to(dtype)


def route(probs, capacity, top_k, valid=None):
    """The routes of every token: a list of ``top_k`` tuples ``(expert
    [N] int64, gate [N] (pre-drop, differentiable), keep [N] bool,
    slot [N] int64)``, ``slot = expert * capacity + position``. ``probs``
    [N, E] are the router probabilities (zero for padding tokens),
    ``valid`` [N] bool or None."""
    n, e = probs.shape
    base = torch.zeros(e, dtype=torch.int64, device=probs.device)
    used = torch.zeros_like(probs)
    masked = probs
    routes = []
    for _ in range(top_k):
        expert = torch.argmax(masked, dim=-1)
        # amax's gradient splits among tied maxima, as jnp.max's does
        gate = torch.amax(masked, dim=-1)
        onehot = _one_hot(expert, e, torch.int64)
        if valid is not None:
            onehot = onehot * valid[:, None]
        # each token's place in its expert's queue: a running count down
        # the tokens, taken along the last dim of the [E, N] transpose
        # (a scan down the outer dim of [N, E] is far slower on a card)
        ahead = torch.cumsum(onehot.t().contiguous(), dim=1).t()
        pos = (ahead - onehot + base).mul_(onehot).sum(dim=-1)
        keep = pos < capacity
        if valid is not None:
            keep = keep & valid
        routes.append((expert, gate, keep, expert * capacity + pos))
        base = base + onehot.sum(dim=0)
        used = used + _one_hot(expert, e, probs.dtype)
        masked = probs * (1.0 - used)
    return routes


def _lower_moe_ffn(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, D] or [N, D]
    gate_w = ins["GateW"][0]  # [D, E]
    w1, b1 = ins["ExpertW1"][0], ins["ExpertB1"][0]  # [E, D, H], [E, H]
    w2, b2 = ins["ExpertW2"][0], ins["ExpertB2"][0]  # [E, H, D], [E, D]
    tok_mask = ins.get("Mask", [None])[0]  # optional [B, T] validity
    top_k = int(attrs.get("top_k", 1))
    act = _ACTS[attrs.get("act", "gelu")]

    d = int(x.shape[-1])
    xf = x.reshape(-1, d)
    n, e = int(xf.shape[0]), int(gate_w.shape[1])
    capacity = max(1, int(float(attrs.get("capacity_factor", 1.25))
                          * n * top_k / e))

    probs = torch.softmax((xf @ gate_w).float(), dim=-1)  # [N, E]
    valid = None
    if tok_mask is not None:
        valid = tok_mask.reshape(-1) > 0
        probs = probs * valid[:, None].to(probs.dtype)
    routes = route(probs, capacity, top_k, valid)

    gates = [gate * keep.to(gate.dtype) for _, gate, keep, _ in routes]
    if top_k > 1:
        total = sum(gate for _, gate, _, _ in routes) + 1e-9
        gates = [g / total for g in gates]

    # dispatch: a dropped route writes the spare row past the buffer
    spare = e * capacity
    slots = torch.cat([torch.where(keep, slot, spare)
                       for _, _, keep, slot in routes])
    xe = torch.zeros(spare + 1, d, dtype=x.dtype, device=x.device) \
        .index_add(0, slots, xf.repeat(top_k, 1))[:spare]
    xe = xe.reshape(e, capacity, d)
    h = act(torch.bmm(xe, w1) + b1[:, None, :])
    ye = (torch.bmm(h, w2) + b2[:, None, :]).reshape(spare, d)
    # combine: a dropped route reads slot 0 with weight 0
    out = 0
    for (_, _, keep, slot), g in zip(routes, gates):
        rows = ye.index_select(0, torch.where(keep, slot, 0))
        out = out + g.to(x.dtype)[:, None] * rows

    # the load-balancing loss over valid tokens, f from the pre-drop
    # top-1 choice (switch_transformer paper eq. 4)
    oh1 = _one_hot(torch.argmax(probs, dim=-1), e, torch.float32)
    if valid is not None:
        vf = valid.to(torch.float32)
        oh1 = oh1 * vf[:, None]
        denom = torch.clamp(vf.sum(), min=1.0)
    else:
        denom = float(n)
    f = oh1.sum(dim=0) / denom
    p = probs.sum(dim=0) / denom
    aux = e * torch.sum(f * p)
    return {"Out": out.reshape(x.shape),
            "AuxLoss": aux.to(x.dtype).reshape(1)}


register_op(
    "moe_ffn",
    inputs=["X", "GateW", "ExpertW1", "ExpertB1", "ExpertW2", "ExpertB2",
            "Mask"],
    outputs=["Out", "AuxLoss"],
    attrs={"top_k": 1, "capacity_factor": 1.25, "act": "gelu"},
    lower=_lower_moe_ffn,
    no_grad_inputs=("Mask",),
)
