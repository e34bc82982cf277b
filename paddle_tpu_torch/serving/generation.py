"""SlotDecodeSession: continuous batching over the block-paged KV pool.

Counterpart of ``paddle_tpu/serving/generation.py`` for the paged greedy
path. ``models.transformer.build_paged_slot_decoder`` builds the programs;
this module is the host-side slot manager. Sequences are admitted into
free slots mid-flight (one admission program runs the encoder and
installs the slot's cross K/V, page-table row and loop state), one
``run_multi_step`` call advances every slot ``steps`` tokens, and a
finished sequence frees its slot and pages at once. Self K/V live in
fixed-size pages from a refcounted ``kv_pool.PagePool`` (page 0 is the
trash page unoccupied slots write into); decode attention reads only
each slot's resident pages.

Ported here: ``admit`` (with ``prefix_tokens``, through the causal
prefill program), ``step`` (``steps >= 1``), ``generate`` and the queue
under it (``enqueue``/``admit_pending``/``pump``/``take_result``), page
provisioning and release, the copy-on-write ladder's warmup and growth
rebinds, and the typed rejects ``NoFreeSlotError`` and
``NoFreePageError``. Later slices (ROADMAP.md): sampled decode (RNG
parity), ``admit_group`` forks with real COW pairs, the prefix cache,
beam and speculative decode, snapshots, degradation, tracing and
metrics, and the dense (unpaged) layout.
"""

from collections import deque

import numpy as np

from paddle_tpu_torch.analysis.lint import suggest_buckets
from paddle_tpu_torch.kernels.paged_attention import pages_for
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.sampling_ops import RNG_PARITY_TODO
from paddle_tpu_torch.serving.kv_pool import (
    NoFreeGroupError,
    NoFreePageError,
    PagePool,
)
from paddle_tpu_torch.serving.server import ServingError

__all__ = ["SlotDecodeSession", "Sampler", "NoFreeSlotError",
           "NoFreePageError", "NoFreeGroupError"]


class NoFreeSlotError(ServingError):
    """admit() with every slot occupied; retry after a step() frees
    slots."""


class Sampler(object):
    """Token-selection spec for the decode loop. This slice serves
    ``"greedy"`` (argmax); temperature and top-k sampling raise
    ``NotImplementedError`` until the port reproduces jax's random bits
    (ROADMAP.md, A6 RNG parity)."""

    def __init__(self, strategy="greedy", temperature=1.0, top_k=0,
                 seed=0):
        if strategy not in ("greedy", "temperature", "top_k"):
            raise ValueError(
                "Sampler strategy must be greedy/temperature/top_k, "
                "got %r" % (strategy,))
        if strategy != "greedy":
            raise NotImplementedError(RNG_PARITY_TODO)
        self.strategy = strategy
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)


class SlotDecodeSession(object):
    """Continuous-batching greedy decode over a block-paged KV pool.

    Build it with the model's parameters in the scope (they bind by
    name)::

        sess = SlotDecodeSession(exe, num_slots=8, max_length=seq,
                                 d_model=D, paged=True, page_size=16,
                                 steps=8, src_vocab_size=V,
                                 trg_vocab_size=V, n_layer=2, n_head=2,
                                 d_inner=64)
        slot = sess.admit(src_row, src_len)   # anytime, mid-flight
        finished = sess.step()                # {slot: tokens} as they end

    ``page_size`` tokens per page, ``num_pages`` in all (default: the
    trash page plus every slot at full length); ``steps`` tokens per
    ``step()`` call; ``num_groups`` cross-K/V rows (default
    ``num_slots``). ``decoder_cfg`` forwards to the builder
    (``src_vocab_size``, ``trg_vocab_size``, ``n_layer``, ``n_head``,
    ``d_inner``).
    """

    def __init__(self, exe, num_slots, max_length=64, d_model=128,
                 bos_id=1, eos_id=2, scope=None, paged=False,
                 page_size=8, num_pages=None, num_groups=None, steps=1,
                 sampler=None, prefix_cache_pages=0, **decoder_cfg):
        if not paged:
            raise NotImplementedError(
                "the dense slot layout is not ported; pass paged=True")
        if prefix_cache_pages:
            raise NotImplementedError(
                "the prefix cache comes with a later slice (ROADMAP.md)")
        self._exe = exe
        self._scope = scope
        self._S, self._T, self._D = int(num_slots), int(max_length), \
            int(d_model)
        self._bos, self._eos = int(bos_id), int(eos_id)
        self._steps = max(1, int(steps))
        self._n_layer = int(decoder_cfg.get("n_layer", 2))
        self._n_head = int(decoder_cfg.get("n_head", 4))
        self._ps = int(page_size)
        self._npp = pages_for(self._T, self._ps)
        self._P = int(num_pages) if num_pages else 1 + self._S * self._npp
        self._G = int(num_groups) if num_groups else self._S
        if self._P < 1 + self._npp:
            raise ValueError(
                "num_pages=%d cannot cover even ONE sequence: the pool "
                "needs 1 trash page + ceil(max_length / page_size) = %d "
                "pages" % (self._P, 1 + self._npp))
        (self._init_prog, self._admit_prog, self._join_prog,
         self._prefill_prog, self._table_prog, self._step_prog,
         self._fetch_name) = transformer.build_paged_slot_decoder(
            num_slots, max_length=max_length, d_model=d_model,
            page_size=self._ps, num_pages=self._P, num_groups=self._G,
            bos_id=bos_id, eos_id=eos_id, sampler=sampler, **decoder_cfg)
        self._run(self._init_prog, {
            "pe_table": transformer.position_encoding_table(self._T,
                                                            self._D)}, [])
        self._pool = PagePool(self._P)
        self._slot_pages = {}  # slot -> [page ids], ordered by index
        self._slot_group = {}  # slot -> group id
        self._free_groups = list(range(self._G - 1, -1, -1))
        # reservation-based admission control: every live slot has its
        # worst-case pages reserved up front (a counter; pages are still
        # acquired lazily), so provisioning mid-flight never fails and an
        # oversubscribed pool rejects at admit() instead
        self._reserved_pages = 0
        # the copy-on-write / growth-rebind programs form a bucket ladder
        # (one program per rung, padded up), each run once now on a
        # pad-only window: trash-page self-copies bound to slot 0's
        # (still trash) row, a no-op
        worst_pairs = max(
            1, self._S * (1 + (self._steps - 1) // self._ps + 1))
        self._cow_rungs = suggest_buckets([1, worst_pairs], max_buckets=4)
        self._cow_progs = {}
        for rung in self._cow_rungs:
            self._run(self._cow_prog(rung), {
                "src_pages": np.zeros(rung, "int64"),
                "dst_pages": np.zeros(rung, "int64"),
                "slot_idxs": np.zeros(rung, "int64"),
                "page_rows": np.zeros((rung, self._npp), "int64"),
            }, [])
        self._free = list(range(self._S - 1, -1, -1))
        self._live = {}  # slot -> {"trg": [T] int64, "pos": int}
        self._pending = deque()  # {"id", "src" [1, T], "len", "prefix"}
        self._owner = {}         # slot -> request id
        self._results = {}       # request id -> [T] tokens, until taken
        self._next_req = 0
        self.steps_done = 0      # step() dispatches completed
        self.decode_steps = 0    # step-program iterations run

    def _run(self, prog, feed, fetch_list):
        return self._exe.run(prog, feed=feed, fetch_list=fetch_list,
                             scope=self._scope)

    @property
    def step_program(self):
        """The decode step program (one token for every slot)."""
        return self._step_prog

    # -- paged pool management ----------------------------------------------
    def _page_row(self, pages):
        """A slot's [npp] table row: its pages, the tail aliased to the
        last valid page (the trash page for a row with no pages)."""
        row = list(pages) if pages else [0]
        row = row + [row[-1]] * (self._npp - len(row))
        return np.asarray([row], dtype="int64")

    def _provision(self, slot, length):
        """Grow ``slot``'s page list to cover ``length`` resident tokens;
        returns True when the table row changed. Cannot fail: admit()
        reserved the slot's worst case."""
        pages = self._slot_pages[slot]
        need = pages_for(min(int(length), self._T), self._ps)
        grew = False
        while len(pages) < need:
            pages.append(self._pool.acquire())
            grew = True
        return grew

    def _cow_prog(self, rung):
        prog = self._cow_progs.get(rung)
        if prog is None:
            prog = transformer.build_cow_batch_prog(
                self._S, self._T, self._n_layer, self._n_head, self._D,
                self._ps, self._P, rung)
            self._cow_progs[rung] = prog
        return prog

    def _dispatch_rebinds(self, slots):
        """ONE dispatch of the COW program that installs the grown table
        rows of ``slots``. No page is shared in this slice (no forks, no
        prefix cache), so every entry's copy is the trash page onto
        itself, a no-op; the list pads up the rung ladder by repeating
        its first slot, whose row is rewritten unchanged."""
        if not slots:
            return
        n = len(slots)
        rung = next((r for r in self._cow_rungs if r >= n),
                    self._cow_rungs[-1])
        if rung < n:  # above the top rung: split
            self._dispatch_rebinds(slots[:rung])
            self._dispatch_rebinds(slots[rung:])
            return
        entries = list(slots) + [slots[0]] * (rung - n)
        self._run(self._cow_prog(rung), {
            "src_pages": np.zeros(rung, "int64"),
            "dst_pages": np.zeros(rung, "int64"),
            "slot_idxs": np.asarray(entries, "int64"),
            "page_rows": np.concatenate(
                [self._page_row(self._slot_pages[s]) for s in entries],
                axis=0),
        }, [])

    def _write_table_row(self, slot, pages):
        self._run(self._table_prog, {
            "slot_idx": np.asarray([slot], dtype="int64"),
            "page_row": self._page_row(pages),
        }, [])

    def _release_pages(self, slot):
        """Recycle a finished slot's pages: its table row points back at
        the trash page FIRST (a done slot still steps, and its writes must
        never land in a recycled page), then every reference drops; the
        group id frees with it."""
        self._write_table_row(slot, [])
        for pg in self._slot_pages.pop(slot):
            self._pool.deref(pg)
        self._free_groups.append(self._slot_group.pop(slot))
        self._reserved_pages -= pages_for(self._T, self._ps)

    @property
    def free_pages(self):
        """Unallocated KV pages (trash page excluded)."""
        return self._pool.free_count

    @property
    def pages_in_use(self):
        """Pages referenced by live slots."""
        return self._pool.allocated_count

    @property
    def pool_conserved(self):
        """The page-pool conservation law: ``free + allocated == P - 1``."""
        return (self._pool.free_count + self._pool.allocated_count
                == self._pool.num_pages - 1)

    def _take_slot(self):
        """Claim the LOWEST-numbered free slot (deterministic placement)."""
        slot = min(self._free)
        self._free.remove(slot)
        return slot

    # -- lifecycle -----------------------------------------------------------
    @property
    def free_slots(self):
        return len(self._free)

    @property
    def active_slots(self):
        return sorted(self._live)

    def _full_prefix(self, prefix_tokens):
        prefix = [self._bos] + [int(t) for t in (prefix_tokens or ())]
        if len(prefix) > self._T - 1:
            raise ValueError(
                "prefix_tokens too long: bos + %d forced tokens leave no "
                "position to sample (max_length=%d)"
                % (len(prefix) - 1, self._T))
        return prefix

    def admit(self, src, src_len=None, prefix_tokens=None):
        """Claim a free slot for one source sequence (``src``: [T] or
        [1, T] int ids; ``src_len``: its true length, default T) and run
        the admission program. ``prefix_tokens`` forces a decoder prefix,
        written into the slot's pages by one causal prefill. Returns the
        slot id. Raises :class:`NoFreeSlotError` when every slot is
        occupied and :class:`NoFreePageError` / :class:`NoFreeGroupError`
        when the pools cannot cover the admission; a reject leaves the
        session exactly as it was."""
        if not self._free:
            raise NoFreeSlotError("all %d slots occupied; step() until "
                                  "one frees" % self._S)
        if not self._free_groups:
            raise NoFreeGroupError("all %d cross-K/V groups occupied"
                                   % self._G)
        src = np.asarray(src, dtype="int64").reshape(1, self._T)
        length = self._T if src_len is None else int(np.ravel(src_len)[0])
        prefix = self._full_prefix(prefix_tokens)
        L = len(prefix)
        worst = pages_for(self._T, self._ps)
        capacity = self._P - 1
        if self._reserved_pages + worst > capacity:
            raise NoFreePageError(
                "KV pool cannot reserve %d pages for a new sequence (%d of "
                "%d already reserved); step() until a sequence completes"
                % (worst, self._reserved_pages, capacity))
        self._reserved_pages += worst
        gid = self._free_groups.pop()
        slot = self._take_slot()
        self._slot_pages[slot] = []
        self._slot_group[slot] = gid
        try:
            # decode-ahead coverage for the first dispatch: the prefill
            # writes positions [0, L-1), the first step() [L-1, L-1+steps)
            self._provision(slot, min(L - 1 + self._steps, self._T))
            self._run(self._admit_prog, {
                "src_word": src,
                "src_len": np.asarray([[length]], dtype="int64"),
                "slot_idx": np.asarray([slot], dtype="int64"),
                "group_idx": np.asarray([gid], dtype="int64"),
                "page_row": self._page_row(self._slot_pages[slot]),
                "start_tok": np.asarray([[prefix[-1]]], dtype="int64"),
                "start_pos": np.asarray([[L - 1]], dtype="int64"),
            }, [])
            if L > 1:
                pw = np.full((1, self._T), self._eos, dtype="int64")
                pw[0, :L] = prefix
                self._run(self._prefill_prog, {
                    "prefix_word": pw,
                    "prefix_len": np.asarray([[L]], dtype="int64"),
                    "write_from": np.asarray([[0]], dtype="int64"),
                    "slot_idx": np.asarray([slot], dtype="int64"),
                    "group_idx": np.asarray([gid], dtype="int64"),
                }, [])
        except BaseException:
            # the row goes back to the trash page before its pages free
            self._release_pages(slot)
            self._free.append(slot)
            raise
        trg = np.full(self._T, self._eos, dtype="int64")
        trg[:L] = prefix
        self._live[slot] = {"trg": trg, "pos": L - 1}
        return slot

    def step(self):
        """Advance every in-flight sequence ``steps`` tokens (one
        ``run_multi_step`` call) and return ``{slot: [T] int64 tokens}``
        for the sequences that finished (their slots and pages are free
        again). No-op ({}) when nothing is in flight."""
        if not self._live:
            return {}
        # step j writes K/V at pos + j: every live slot's table covers
        # pos + steps before the loop starts, all rebinds in one dispatch
        self._dispatch_rebinds([
            slot for slot, st in self._live.items()
            if self._provision(slot, st["pos"] + self._steps)])
        (toks,) = self._exe.run_multi_step(
            self._step_prog, self._steps, feed={},
            fetch_list=[self._fetch_name], scope=self._scope,
            stack_fetches=True)
        self.steps_done += 1
        self.decode_steps += self._steps
        return self._consume_tokens(np.asarray(toks))  # [K, S, 1]

    def _consume_tokens(self, toks):
        """Apply a ``[K, S, 1]`` token trajectory to the live slots, the
        host mirror of the device loop: each live slot takes one token
        per step until eos or the length budget; later steps for it are
        the device's forced-eos padding."""
        finished = {}
        for j in range(toks.shape[0]):
            for slot in list(self._live):
                st = self._live[slot]
                t = st["pos"]
                nxt = int(toks[j, slot, 0])
                st["trg"][t + 1] = nxt
                st["pos"] = t + 1
                if nxt == self._eos or t + 1 == self._T - 1:
                    finished[slot] = st["trg"]
                    del self._live[slot]
                    self._free.append(slot)
                    self._release_pages(slot)
        return finished

    # -- request queue -------------------------------------------------------
    def enqueue(self, src, src_len=None, prefix_tokens=None):
        """Queue one request ([T] or [1, T] int ids); :meth:`pump` admits
        queued requests as capacity frees. Returns a request id."""
        rid = self._next_req
        self._next_req += 1
        self._pending.append({
            "id": rid,
            "src": np.asarray(src, dtype="int64").reshape(1, self._T),
            "len": self._T if src_len is None
            else int(np.ravel(src_len)[0]),
            "prefix": (None if prefix_tokens is None
                       else [int(t) for t in prefix_tokens]),
        })
        return rid

    def admit_pending(self):
        """Admit queued requests in order while capacity allows (a
        page/group reject defers the request back to the front). Returns
        ``{slot: request_id}`` for the requests admitted by this call."""
        admitted = {}
        while self._pending and self._free:
            req = self._pending.popleft()
            try:
                slot = self.admit(req["src"], req["len"],
                                  prefix_tokens=req["prefix"])
            except (NoFreePageError, NoFreeGroupError):
                self._pending.appendleft(req)
                break
            self._owner[slot] = req["id"]
            admitted[slot] = req["id"]
        return admitted

    def pump(self):
        """One scheduler round: :meth:`admit_pending`, then one
        :meth:`step`. Returns ``{request_id: [T] tokens}`` for requests
        that finished this round; each is also banked until
        :meth:`take_result` claims it."""
        self.admit_pending()
        finished = {}
        for slot, tokens in self.step().items():
            rid = self._owner.pop(slot, None)
            if rid is not None:
                finished[rid] = tokens
                self._results[rid] = tokens
        return finished

    def take_result(self, request_id):
        """Claim (and remove) a finished request's [T] tokens, or None."""
        return self._results.pop(int(request_id), None)

    def generate(self, src, src_len=None, prefix_tokens=None):
        """Batch convenience: run every row of ``src`` ([B, T] int ids,
        ``src_len`` [B] or [B, 1]) through the slot pool, admitting as
        slots free (staggered admission for B > num_slots), and return
        the [B, T] token matrix (bos-led, eos-padded). ``prefix_tokens``
        is an optional per-row list of forced prefixes (None entries for
        none)."""
        src = np.asarray(src, dtype="int64")
        lengths = (np.full(len(src), self._T, dtype="int64")
                   if src_len is None
                   else np.ravel(np.asarray(src_len, dtype="int64")))
        prefixes = prefix_tokens or [None] * len(src)
        out = np.full((len(src), self._T), self._eos, dtype="int64")
        order = {self.enqueue(src[i], lengths[i], prefixes[i]): i
                 for i in range(len(src))}
        want = set(order)
        while want:
            self.pump()
            for rid in list(want):
                tokens = self.take_result(rid)
                if tokens is not None:
                    out[order[rid]] = tokens
                    want.discard(rid)
        return out
