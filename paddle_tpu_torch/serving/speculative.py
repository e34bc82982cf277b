"""Host-side drafters for speculative decoding over the paged pool.

Counterpart of ``paddle_tpu/serving/speculative.py`` (a copy, with this
package's executor, scope and ``models.transformer`` behind
``DraftModelDrafter``).

``SlotDecodeSession(speculative=...)`` runs decode as draft-then-verify:
a DRAFTER proposes K tokens per live slot, the session lays them out as
a speculation tree in the slot's write pages and runs ONE target
dispatch (``paged_tree_attention`` + ``slot_speculative_accept``) that
commits the longest prefix the target itself would have emitted.

Correctness never depends on the drafter: every committed token is
re-sampled from TARGET logits under the exact sequential rule (the
``FLAGS_speculative=off`` bit-exactness oracle), so a drafter can be
stale, cold or adversarial and only the ACCEPTANCE RATE moves. That
contract is what lets both drafters here cut corners safely:

* :class:`NgramDrafter` — zero-HBM prompt-lookup drafting: per slot,
  suffix-match the emitted history (forced prefix + committed tokens)
  against itself and propose the continuation of the most recent
  earlier occurrence of the longest matching suffix. No model, no
  device state, no dispatches; completely deterministic in the
  history.
* :class:`DraftModelDrafter` — a small draft transformer
  (``models.transformer.build_draft_decoder``) sharing the target's
  embedding and the slot pool GEOMETRY (its own K/V pools indexed
  through the same per-slot page table). Host-driven single-token
  steps; committed tokens the draft has not seen are replayed through
  it (catch-up) before drafting ahead. Its pools sit OUTSIDE
  copy-on-write — a fork's stale draft rows only cost acceptance.

Both drafters propose a CHAIN (node ``i`` extends node ``i - 1``);
:func:`chain_tree` builds the matching parent/ancestor-mask feeds once
per session. :func:`tree_from_parents` builds the ancestor mask for an
arbitrary tree (branching drafters, tests). Sibling nodes carrying the
SAME token should be deduplicated by the drafter: the accept walk
descends into the FIRST matching child, so a duplicate sibling is
unreachable — never wrong, just a wasted tree node.
"""

import numpy as np

__all__ = ["NgramDrafter", "DraftModelDrafter", "chain_tree",
           "tree_from_parents"]


def chain_tree(k):
    """Parent vector + ancestor mask for a K-token draft CHAIN:
    N = k + 1 nodes, node 0 the anchor, node i extending node i - 1.
    Returns ``(parent [N] int64, anc [N, N] int64)`` — ``anc`` is
    lower-triangular ones (every node's ancestor set is the full
    prefix chain, including itself and the anchor)."""
    n = int(k) + 1
    parent = np.arange(n, dtype="int64") - 1  # node 0 -> -1 (no parent)
    anc = np.tril(np.ones((n, n), dtype="int64"))
    return parent, anc


def tree_from_parents(parents):
    """Ancestor mask ``[N, N]`` for an arbitrary speculation tree given
    per-node parent indices (``parents[0]`` must be -1 — the anchor;
    every other node's parent must precede it). ``anc[i, j] = 1`` iff
    node ``j`` is on node ``i``'s root path (self and anchor
    included) — exactly the visibility the tree-attention kernel
    enforces inside the speculated block."""
    parents = [int(p) for p in parents]
    n = len(parents)
    if n < 1 or parents[0] != -1:
        raise ValueError(
            "tree_from_parents: node 0 is the anchor and must have "
            "parent -1, got %r" % (parents[:1],))
    anc = np.zeros((n, n), dtype="int64")
    for i in range(n):
        if i and not 0 <= parents[i] < i:
            raise ValueError(
                "tree_from_parents: node %d's parent %d must precede "
                "it" % (i, parents[i]))
        anc[i, i] = 1
        p = parents[i]
        while p >= 0:
            anc[i, p] = 1
            p = parents[p]
    return anc


class NgramDrafter(object):
    """Prompt-lookup drafting (zero HBM, zero dispatches): propose the
    continuation of the most recent earlier occurrence of the longest
    suffix (up to ``order`` tokens, down to 1) of the slot's emitted
    history. Slots with no match (or a too-short continuation) pad
    with eos — a free proposal the accept walk simply rejects unless
    the target really does emit eos. Deterministic in the history, so
    a restored snapshot re-proposes identically."""

    kind = "ngram"

    def __init__(self, num_slots, k, eos_id=2, order=3):
        self._S = int(num_slots)
        self.k = int(k)
        self._eos = int(eos_id)
        self.order = int(order)
        if self.order < 1:
            raise ValueError("NgramDrafter needs order >= 1")

    def forget(self, slot):
        """Slot released — nothing to drop, the history is the
        session's."""

    def state_dict(self):
        """Snapshot payload: config only (the lookup state IS the
        emitted history, which the decode snapshot already carries)."""
        return {"order": self.order}

    def load_state_dict(self, state):
        self.order = int(state.get("order", self.order))

    def _lookup(self, hist):
        n = len(hist)
        for m in range(min(self.order, n - 1), 0, -1):
            suf = hist[n - m:]
            for s in range(n - m - 1, -1, -1):
                if hist[s:s + m] == suf:
                    cont = hist[s + m:s + m + self.k]
                    if cont:
                        return cont
        return []

    def propose(self, states):
        """``states``: ``{slot: {"trg": [T] int64, "pos": int}}`` for
        the LIVE slots. Returns ``[num_slots, k]`` int64 chain
        proposals (eos rows for slots not in ``states``)."""
        draft = np.full((self._S, self.k), self._eos, dtype="int64")
        for slot, st in states.items():
            hist = [int(t) for t in st["trg"][:int(st["pos"]) + 1]]
            cont = self._lookup(hist)
            draft[slot, :len(cont)] = cont
        return draft


class DraftModelDrafter(object):
    """Draft-transformer chain drafting over the shared page table.

    Wraps the ``build_draft_decoder`` programs: per :meth:`propose`,
    first REPLAY every committed token the draft cache has not seen
    (positions ``[dpos, pos)`` per slot, batched across slots — the
    catch-up that keeps draft K/V current after accepts/rejects and
    after a ``FLAGS_speculative=off`` stretch), then roll ``k`` greedy
    draft steps ahead of the anchor. Each step is one fixed-shape
    dispatch of the same warm executable.

    The draft K/V self-heals: accepted positions were written with
    exactly the tokens that got committed, the correction token is
    rewritten as the next round's anchor, and rejected-tail rows are
    overwritten by the next chain — so ``dpos`` conservatively resets
    to the anchor position each round and the replay loop covers
    whatever the verify dispatch committed."""

    kind = "model"

    def __init__(self, exe, num_slots, k, trg_vocab_size, max_length,
                 n_head, d_model, page_size, num_pages, eos_id=2,
                 scope=None, d_inner=None):
        from paddle_tpu_torch import executor as _executor
        from paddle_tpu_torch.core.scope import Scope
        from paddle_tpu_torch.models import transformer

        self._exe = exe
        self._scope = scope
        self._S = int(num_slots)
        self.k = int(k)
        self._T = int(max_length)
        self._eos = int(eos_id)
        (init, step, step_startup, tok_name) = \
            transformer.build_draft_decoder(
                num_slots, trg_vocab_size=trg_vocab_size,
                max_length=max_length, n_head=n_head, d_model=d_model,
                d_inner=d_inner, page_size=page_size,
                num_pages=num_pages, eos_id=eos_id)
        self._step = step
        self._tok_name = tok_name
        # initialize ONLY the draft's own parameters: run the step's
        # startup into a throwaway scope and copy just the vars the
        # session scope is missing — the shared ``trg_emb`` (and any
        # other trained var) must keep its trained value
        live_scope = scope if scope is not None \
            else _executor.global_scope()
        self._live_scope = live_scope
        tmp = Scope()
        exe.run(step_startup, scope=tmp)
        for name in tmp.local_var_names():
            cur = live_scope.find_var(name)
            if cur is None or cur.value is None:
                live_scope.var(name).value = tmp.find_var(name).value
        # the draft's OWN params (draft_*; excludes the shared trg_emb):
        # a decode snapshot carries these arrays, because even though
        # accepted CONTENT never depends on them, acceptance TIMING
        # does — and timing steers which slot a backlog request lands
        # in, which keys the sampler stream
        self._param_names = sorted(
            n for n in tmp.local_var_names() if n.startswith("draft_"))
        exe.run(init, scope=scope)  # zeroed draft pools
        self._dpos = {}  # slot -> positions [0, dpos) resident in cache

    def forget(self, slot):
        """Slot released: its next occupant starts from a cold draft
        cache (replay from position 0)."""
        self._dpos.pop(int(slot), None)

    def state_dict(self):
        """Snapshot payload: the per-slot cache watermark. The draft
        POOLS are persistable scope vars and ride the snapshot's pool
        gather; this is the host mirror that tells a restored session
        which positions those rows cover."""
        return {"dpos": {int(s): int(p) for s, p in self._dpos.items()}}

    def load_state_dict(self, state):
        self._dpos = {int(s): int(p)
                      for s, p in (state.get("dpos") or {}).items()}

    def param_arrays(self):
        """The draft transformer's own parameter arrays, as host COPIES:
        ``tensor.cpu().numpy()`` of a CPU tensor shares the tensor's
        memory, and a later in-place update would change the array."""
        return {n: np.array(
            self._live_scope.get_value(n).detach().cpu().numpy())
            for n in self._param_names}

    def load_param_arrays(self, arrays):
        """Overwrite the draft params with a snapshot's arrays so the
        restored drafter proposes exactly what the victim's would."""
        for n, arr in arrays.items():
            self._live_scope.set_value(n, np.array(arr))

    def _run_step(self, tok, pos, live):
        (out,) = self._exe.run(
            self._step,
            feed={"draft_tok": tok, "draft_pos": pos,
                  "draft_live": live},
            fetch_list=[self._tok_name], scope=self._scope)
        return np.asarray(out).reshape(self._S, 1)

    def propose(self, states):
        """Same contract as :meth:`NgramDrafter.propose`."""
        S, K = self._S, self.k
        for s in list(self._dpos):
            if s not in states:
                del self._dpos[s]
        replay = {}
        for slot, st in states.items():
            start = self._dpos.get(slot, 0)
            pos = int(st["pos"])
            replay[slot] = [(p, int(st["trg"][p]))
                            for p in range(start, pos)]
        depth = max((len(v) for v in replay.values()), default=0)
        for r in range(depth):
            tok = np.full((S, 1), self._eos, dtype="int64")
            posf = np.zeros((S, 1), dtype="int64")
            live = np.zeros((S, 1), dtype="int64")
            for slot, items in replay.items():
                if r < len(items):
                    p, t = items[r]
                    tok[slot, 0] = t
                    posf[slot, 0] = p
                    live[slot, 0] = 1
            self._run_step(tok, posf, live)
        draft = np.full((S, K), self._eos, dtype="int64")
        if not states:
            return draft
        tok = np.full((S, 1), self._eos, dtype="int64")
        posf = np.zeros((S, 1), dtype="int64")
        live = np.zeros((S, 1), dtype="int64")
        for slot, st in states.items():
            pos = int(st["pos"])
            tok[slot, 0] = int(st["trg"][pos])
            posf[slot, 0] = pos
            live[slot, 0] = 1
            # anchor position rewrites this round; committed tokens
            # past it replay next round
            self._dpos[slot] = pos
        for j in range(K):
            nxt = self._run_step(tok, posf, live)
            draft[:, j] = nxt.reshape(-1)
            tok = nxt.astype("int64")
            posf = np.minimum(posf + 1, self._T - 1)
        return draft
