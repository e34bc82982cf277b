"""SlotDecodeSession: continuous batching over the block-paged KV pool or
dense slot caches.

Counterpart of ``paddle_tpu/serving/generation.py`` for greedy decode.
``models.transformer.build_paged_slot_decoder`` (``paged=True``) and
``build_slot_decoder`` (``paged=False``) build the programs; this module
is the host-side slot manager. Sequences are admitted into
free slots mid-flight (one admission program runs the encoder and
installs the slot's cross K/V, page-table row and loop state), one
``run_multi_step`` call advances every slot ``steps`` tokens, and a
finished sequence frees its slot and pages at once. Self K/V live in
fixed-size pages from a refcounted ``kv_pool.PagePool`` (page 0 is the
trash page unoccupied slots write into); decode attention reads only
each slot's resident pages.

Ported here: ``admit`` (with ``prefix_tokens``, through the causal
prefill program), ``admit_group`` (forks of one source that share its
cross K/V group and its prefix pages until copy-on-write splits them),
the prefix cache (``prefix_cache_pages``: a forced prefix's full pages
are looked up by source and tokens, referenced, and only the rest is
prefilled), ``step`` (``steps >= 1``; on a card one captured CUDA graph
a call, ``Executor.run_multi_step``), speculative decode
(``speculative=K``: draft-then-verify, 1 to K + 1 tokens per slot per
dispatch, with the ``FLAGS_speculative=off`` oracle), the dense layout
(``paged=False``: one ``exe.run`` per token), ``generate``,
``generate_best_of`` and the queue under them
(``enqueue``/``admit_pending``/``pump``/``take_result``), page
provisioning and release, the coalesced copy-on-write dispatch, and the
typed rejects ``NoFreeSlotError``, ``NoFreePageError`` and
``NoFreeGroupError``. Not ported yet (ROADMAP.md): sampled decode (A6,
RNG parity), snapshots and degradation (A5), beam decode (A7), tracing
and metrics, the prefix cache's gauges among them (A9).
"""

import hashlib
from collections import deque

import numpy as np

from paddle_tpu_torch import flags
from paddle_tpu_torch.analysis.lint import suggest_buckets
from paddle_tpu_torch.kernels.paged_attention import pages_for
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.sampling_ops import RNG_PARITY_TODO
from paddle_tpu_torch.serving import speculative as _spec_mod
from paddle_tpu_torch.serving.kv_pool import (
    NoFreeGroupError,
    NoFreePageError,
    PagePool,
    PrefixCache,
)
from paddle_tpu_torch.serving.server import ServingError

__all__ = ["SlotDecodeSession", "Sampler", "NoFreeSlotError",
           "NoFreePageError", "NoFreeGroupError"]


class NoFreeSlotError(ServingError):
    """admit() with every slot occupied; retry after a step() frees
    slots."""


class Sampler(object):
    """Token-selection spec for the decode loop. The port serves
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
    """Continuous-batching greedy decode over a block-paged KV pool
    (``paged=True``) or dense per-slot caches (``paged=False``).

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
    ``num_slots``); ``prefix_cache_pages`` > 0 enables the forced-prefix
    page cache with that page capacity. ``decoder_cfg`` forwards to the
    builder (``src_vocab_size``, ``trg_vocab_size``, ``n_layer``,
    ``n_head``, ``d_inner``). The dense layout (``paged=False``) takes
    ``steps=1`` only and has no pool: no forced prefixes, fork groups,
    prefix cache or speculative decode.

    ``speculative=K`` (or ``{"k": K, "drafter": "ngram" | "model",
    ...}``; ``steps=1``) decodes by draft-then-verify: a host drafter
    proposes K tokens per slot, ONE tree-attention dispatch of the target
    verifies them and commits the longest prefix the target itself would
    have chosen (1 to K + 1 tokens per dispatch). Token streams equal the
    same session's under ``FLAGS_speculative=off``: the drafter moves
    throughput, never content. ``spec_dispatches``, ``spec_proposed`` and
    ``spec_accepted`` count verify dispatches, draft tokens offered and
    draft tokens committed. See ``serving/speculative.py``.
    """

    def __init__(self, exe, num_slots, max_length=64, d_model=128,
                 bos_id=1, eos_id=2, scope=None, paged=False,
                 page_size=8, num_pages=None, num_groups=None, steps=1,
                 sampler=None, prefix_cache_pages=0, speculative=None,
                 **decoder_cfg):
        # speculative decode config: int K (n-gram drafter) or a dict
        # {"k": K, "drafter": "ngram"|"model", ...drafter kwargs}
        if speculative is None:
            spec_cfg = {}
        elif isinstance(speculative, dict):
            spec_cfg = dict(speculative)
        else:
            spec_cfg = {"k": int(speculative)}
        self._spec_k = int(spec_cfg.get("k", 0) or 0)
        self.spec_proposed = 0    # draft tokens offered
        self.spec_accepted = 0    # draft tokens committed
        self.spec_dispatches = 0  # verify dispatches run
        if self._spec_k < 0:
            raise ValueError("speculative k must be >= 0 (0 disables), "
                             "got %d" % self._spec_k)
        if self._spec_k and not paged:
            raise ValueError(
                "speculative decode needs paged=True — the tree "
                "writes/compaction ARE page-table operations")
        if self._spec_k and int(steps) != 1:
            raise ValueError(
                "speculative decode needs steps=1: drafting and accept "
                "bookkeeping happen on the host BETWEEN dispatches (each "
                "dispatch already advances up to k + 1 tokens)")
        self._exe = exe
        self._scope = scope
        self._S, self._T, self._D = int(num_slots), int(max_length), \
            int(d_model)
        self._bos, self._eos = int(bos_id), int(eos_id)
        self._paged = bool(paged)
        self._steps = max(1, int(steps))
        self._n_layer = int(decoder_cfg.get("n_layer", 2))
        self._n_head = int(decoder_cfg.get("n_head", 4))
        self._free = list(range(self._S - 1, -1, -1))
        self._live = {}  # slot -> {"trg": [T] int64, "pos": int}
        self._pending = deque()  # {"id", "src" [1, T], "len", "prefix"}
        self._owner = {}         # slot -> request id
        self._results = {}       # request id -> [T] tokens, until taken
        self._next_req = 0
        self.steps_done = 0      # step() dispatches completed
        self.decode_steps = 0    # step-program iterations run
        self._spec_drafter = None
        self._prefix_cache = None
        if not self._paged:
            if steps != 1:
                raise ValueError(
                    "multi-token dispatch (steps > 1) needs paged=True "
                    "— the dense step program is not a self-contained "
                    "loop body")
            if prefix_cache_pages or num_groups:
                raise ValueError(
                    "prefix_cache_pages / num_groups need paged=True — "
                    "the dense layout has no shareable KV state")
            (self._init_prog, self._admit_prog, self._step_prog,
             self._fetch_name) = transformer.build_slot_decoder(
                num_slots, max_length=max_length, d_model=d_model,
                eos_id=eos_id, sampler=sampler, **decoder_cfg)
            self._run(self._init_prog, {}, [])
            return
        self._ps = int(page_size)
        self._npp = pages_for(self._T, self._ps)
        self._P = int(num_pages) if num_pages else 1 + self._S * self._npp
        self._G = int(num_groups) if num_groups else self._S
        if self._P < 1 + self._npp:
            raise ValueError(
                "num_pages=%d cannot cover even ONE sequence: the pool "
                "needs 1 trash page + ceil(max_length / page_size) = %d "
                "pages" % (self._P, 1 + self._npp))
        built = transformer.build_paged_slot_decoder(
            num_slots, max_length=max_length, d_model=d_model,
            page_size=self._ps, num_pages=self._P, num_groups=self._G,
            bos_id=bos_id, eos_id=eos_id, sampler=sampler,
            speculative=self._spec_k, **decoder_cfg)
        if self._spec_k:
            (self._init_prog, self._admit_prog, self._join_prog,
             self._prefill_prog, self._table_prog, self._step_prog,
             self._spec_prog, spec_fetches) = built
            self._spec_fetches = dict(spec_fetches)
            self._fetch_name = self._spec_fetches["token"]
        else:
            (self._init_prog, self._admit_prog, self._join_prog,
             self._prefill_prog, self._table_prog, self._step_prog,
             self._fetch_name) = built
        self._run(self._init_prog, {
            "pe_table": transformer.position_encoding_table(self._T,
                                                            self._D)}, [])
        self._pool = PagePool(self._P)
        if prefix_cache_pages:
            self._prefix_cache = PrefixCache(
                self._pool, self._ps, max_pages=int(prefix_cache_pages))
        self._slot_pages = {}  # slot -> [page ids], ordered by index
        self._slot_group = {}  # slot -> group id
        self._free_groups = list(range(self._G - 1, -1, -1))
        self._group_members = {}  # group id -> set(slot)
        # reservation-based admission control: every live slot has its
        # worst-case pages reserved up front (a counter; pages are still
        # acquired lazily), so provisioning and copy-on-write mid-flight
        # never fail and an oversubscribed pool rejects at admit()
        # instead. Pages LEAKED by a failed rollback or COW dispatch
        # (kept allocated, so a device row that may have been committed
        # can never write into a recycled page) shrink the capacity.
        self._reserved_pages = 0
        self._leaked_pages = 0
        self.cow_dispatches = 0   # coalesced COW / rebind dispatches
        self.cow_pairs = 0        # real (src, dst) page copies dispatched
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
        # speculative decode: the drafter and the (static) chain-tree
        # feeds. The plain step program stays built: FLAGS_speculative is
        # read at EVERY step, so the off oracle flips mid-session.
        if self._spec_k:
            kind = str(spec_cfg.get("drafter", "ngram"))
            if kind == "ngram":
                self._spec_drafter = _spec_mod.NgramDrafter(
                    self._S, self._spec_k, eos_id=self._eos,
                    order=int(spec_cfg.get("order", 3)))
            elif kind == "model":
                self._spec_drafter = _spec_mod.DraftModelDrafter(
                    exe, self._S, self._spec_k,
                    trg_vocab_size=int(decoder_cfg.get("trg_vocab_size",
                                                       1000)),
                    max_length=self._T, n_head=self._n_head,
                    d_model=self._D, page_size=self._ps,
                    num_pages=self._P, eos_id=self._eos, scope=scope,
                    d_inner=spec_cfg.get("draft_d_inner"))
            else:
                raise ValueError(
                    "speculative drafter must be 'ngram' or 'model', got "
                    "%r" % (kind,))
            parent, anc = _spec_mod.chain_tree(self._spec_k)
            self._spec_nodes = self._spec_k + 1
            self._spec_parent = np.tile(parent[None, :], (self._S, 1))
            self._spec_anc = np.tile(anc[None, :, :], (self._S, 1, 1))

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

    def _acquire_page(self):
        reclaim = (self._prefix_cache.reclaim
                   if self._prefix_cache is not None else None)
        return self._pool.acquire(reclaim)

    def _provision(self, slot, length):
        """Grow ``slot``'s page list to cover ``length`` resident tokens;
        returns True when the table row changed. Cannot fail: admit()
        reserved the slot's worst case (pages only the prefix cache holds
        are evicted under pressure)."""
        pages = self._slot_pages[slot]
        need = pages_for(min(int(length), self._T), self._ps)
        grew = False
        while len(pages) < need:
            pages.append(self._acquire_page())
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

    def _cow_copies(self, slot, pos, pending, span):
        """Copy-on-write scan for one dispatch: every page this slot will
        WRITE in positions ``[pos, pos + span)`` that is still shared
        (refcount > 1: a fork sibling holds it) is swapped for a freshly
        acquired private page. Returns the ``[(src, dst)]`` pairs to
        copy; the slot's page list is already repointed. ``pending`` maps
        a source page to the derefs earlier pairs of the same window have
        planned (the window derefs only after its one dispatch lands), so
        the LAST holder writes in place: N sharers cost N - 1 copies."""
        pages = self._slot_pages[slot]
        first = int(pos) // self._ps
        last = min(int(pos) + span - 1, self._T - 1) // self._ps
        copies = []
        for i in range(first, min(last + 1, len(pages))):
            pg = pages[i]
            if self._pool.refcount(pg) - pending.get(pg, 0) > 1:
                dst = self._acquire_page()
                copies.append((pg, dst))
                pages[i] = dst
                pending[pg] = pending.get(pg, 0) + 1
        return copies

    def _cow_window(self, slots_positions, span=None):
        """One dispatch window's COW pairs and growth rebinds for
        ``[(slot, write_pos)]``: the page lists are repointed here, the
        device catches up in ONE ``_dispatch_cow`` call. ``span`` is the
        number of positions the dispatch writes per slot (default
        ``steps``; a verify dispatch writes its whole k + 1 node tree)."""
        window = []
        span = self._steps if span is None else int(span)
        pending = {}  # src -> derefs planned by this window's pairs
        for slot, pos in slots_positions:
            grew = self._provision(slot, pos + span)
            copies = self._cow_copies(slot, pos, pending, span)
            window.extend((slot, src, dst) for src, dst in copies)
            if grew and not copies:
                window.append((slot, 0, 0))  # rebind-only entry
        return window

    def _dispatch_cow(self, window):
        """ONE coalesced dispatch for a step window's COW pairs and
        growth rebinds. ``window`` is ``[(slot, src, dst)]``;
        ``(slot, 0, 0)`` entries only rebind (a slot whose row grew; the
        trash-page self-copy they carry is a no-op). The window pads up
        the rung ladder by repeating its first slot, every copy lands
        before any repoint, and each slot's FINAL row rides the same
        program.

        A FAILED dispatch may or may not have taken effect on the device,
        so the host puts every shared source back in its slot's row and
        LEAKS every destination page of the window: were the rows
        written, they point at those pages, and recycling one would hand
        a later sequence a page a stale row still writes."""
        if not window:
            return
        n = len(window)
        rung = next((r for r in self._cow_rungs if r >= n),
                    self._cow_rungs[-1])
        if rung < n:  # above the top rung: split
            self._dispatch_cow(window[:rung])
            self._dispatch_cow(window[rung:])
            return
        entries = list(window) + [(window[0][0], 0, 0)] * (rung - n)
        copies = [e for e in window if e[1] or e[2]]
        try:
            self._run(self._cow_prog(rung), {
                "src_pages": np.asarray([e[1] for e in entries], "int64"),
                "dst_pages": np.asarray([e[2] for e in entries], "int64"),
                "slot_idxs": np.asarray([e[0] for e in entries], "int64"),
                "page_rows": np.concatenate(
                    [self._page_row(self._slot_pages[e[0]])
                     for e in entries], axis=0),
            }, [])
        except BaseException:
            for slot, src_pg, dst_pg in copies:
                pages = self._slot_pages[slot]
                pages[pages.index(dst_pg)] = src_pg
                self._leaked_pages += 1  # stays allocated for good
            raise
        for _slot, src_pg, _dst in copies:
            self._pool.deref(src_pg)
        self.cow_dispatches += 1
        self.cow_pairs += len(copies)

    def _write_table_row(self, slot, pages):
        self._run(self._table_prog, {
            "slot_idx": np.asarray([slot], dtype="int64"),
            "page_row": self._page_row(pages),
        }, [])

    def _release_pages(self, slot):
        """Recycle a finished slot's references: its table row points
        back at the trash page FIRST (a done slot still steps, and its
        writes must never land in a recycled page), then every page
        reference drops (a page frees when its LAST reference goes). The
        slot's group loses a member; the group id frees with its last."""
        self._write_table_row(slot, [])
        for pg in self._slot_pages.pop(slot):
            self._pool.deref(pg)
        if self._spec_drafter is not None:
            # the slot's next occupant must not inherit this one's
            # draft-cache watermark
            self._spec_drafter.forget(slot)
        gid = self._slot_group.pop(slot)
        members = self._group_members[gid]
        members.discard(slot)
        if not members:
            del self._group_members[gid]
            self._free_groups.append(gid)
        self._reserved_pages -= pages_for(self._T, self._ps)

    @property
    def free_pages(self):
        """Unallocated KV pages (trash page excluded; 0 when dense)."""
        return self._pool.free_count if self._paged else 0

    @property
    def pages_in_use(self):
        """Pages referenced by live slots or the prefix cache."""
        return self._pool.allocated_count if self._paged else 0

    @property
    def shared_pages(self):
        """Pages with refcount > 1 (fork or prefix sharing in flight)."""
        return self._pool.shared_count if self._paged else 0

    @property
    def cached_pages(self):
        """Distinct pages the prefix cache holds references on."""
        return (self._prefix_cache.pages
                if self._prefix_cache is not None else 0)

    @property
    def free_groups(self):
        return len(self._free_groups) if self._paged else 0

    @property
    def pool_conserved(self):
        """The page-pool conservation law: ``free + allocated == P - 1``
        (True for a dense session, which has no pool)."""
        if not self._paged:
            return True
        return (self._pool.free_count + self._pool.allocated_count
                == self._pool.num_pages - 1)

    def prefix_cache_stats(self):
        """{'lookups', 'hits', 'hit_rate', 'tokens_saved', 'pages'};
        zeros when the cache is disabled."""
        c = self._prefix_cache
        if c is None:
            return {"lookups": 0, "hits": 0, "hit_rate": 0.0,
                    "tokens_saved": 0, "pages": 0}
        return {"lookups": c.lookups, "hits": c.hits,
                "hit_rate": c.hit_rate, "tokens_saved": c.tokens_saved,
                "pages": c.pages}

    def clear_prefix_cache(self):
        """Drop every cached prefix page (references released; pages
        free once no live slot shares them)."""
        if self._prefix_cache is not None:
            self._prefix_cache.clear()

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

    @staticmethod
    def _src_fp(src, length):
        """Prefix-cache source fingerprint: prefix K/V past layer 0
        depends on the source (cross attention feeds every decoder
        layer), so cached pages are keyed by source content too."""
        h = hashlib.sha256(np.ascontiguousarray(src).tobytes())
        h.update(str(int(length)).encode())
        return h.hexdigest()

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
        session exactly as it was. A dense session takes no
        ``prefix_tokens``."""
        if not self._paged:
            if prefix_tokens is not None:
                raise ValueError(
                    "prefix_tokens needs paged=True — the dense layout "
                    "has no prefill program")
            return self._admit_dense(src, src_len)
        return self.admit_group(src, n=1, src_len=src_len,
                                prefix_tokens=prefix_tokens)[0]

    def _admit_dense(self, src, src_len):
        if not self._free:
            raise NoFreeSlotError(
                "all %d slots occupied; step() until one frees" % self._S)
        src = np.asarray(src, dtype="int64").reshape(1, self._T)
        length = self._T if src_len is None else int(np.ravel(src_len)[0])
        slot = self._take_slot()
        try:
            self._run(self._admit_prog, {
                "src_word": src,
                "src_len": np.asarray([[length]], dtype="int64"),
                "slot_idx": np.asarray([slot], dtype="int64"),
            }, [])
        except BaseException:
            # the slot goes back, so a retried admission lands in it
            self._free.append(slot)
            raise
        trg = np.full(self._T, self._eos, dtype="int64")
        trg[0] = self._bos
        self._live[slot] = {"trg": trg, "pos": 0}
        return slot

    def admit_group(self, src, n=1, src_len=None, prefix_tokens=None):
        """Admit ``n`` continuations of ONE source as a fork group: one
        encoder forward, one group-pooled set of cross-attention K/V rows
        shared by every member, and, with a forced prefix, one prefill
        whose pages every member references until copy-on-write splits
        their tails. Members take the lowest free slots in order, so a
        member decodes what a solo admission into the same slot decodes.
        Returns the member slot ids in admission order. Any failure
        mid-admission rolls the whole group back (table rows to the trash
        page FIRST, then references, slots, group and reservations).

        With the prefix cache on, member 0 takes the forced prefix's full
        pages the cache holds for this source by reference and prefills
        only from ``write_from = hits x page_size``; the pages that the
        prefill filled join the cache after it has landed."""
        if not self._paged:
            raise ValueError(
                "admit_group needs paged=True — the dense layout has "
                "no shareable KV state")
        n = int(n)
        if n < 1:
            raise ValueError("admit_group needs n >= 1, got %d" % n)
        if len(self._free) < n:
            raise NoFreeSlotError(
                "admit_group(n=%d): only %d of %d slots free; step() until "
                "more free" % (n, len(self._free), self._S))
        if not self._free_groups:
            raise NoFreeGroupError(
                "all %d cross-K/V groups occupied; step() until a group's "
                "last member completes" % self._G)
        src = np.asarray(src, dtype="int64").reshape(1, self._T)
        length = self._T if src_len is None else int(np.ravel(src_len)[0])
        prefix = self._full_prefix(prefix_tokens)
        L = len(prefix)
        worst = pages_for(self._T, self._ps)
        capacity = self._P - 1 - self._leaked_pages
        if self._reserved_pages + n * worst > capacity:
            raise NoFreePageError(
                "KV pool cannot reserve %d pages for %d new sequence(s) "
                "(%d of %d already reserved); step() until a sequence "
                "completes" % (n * worst, n, self._reserved_pages,
                               capacity))
        self._reserved_pages += n * worst
        gid = self._free_groups.pop()
        slots = []
        start_feed = {
            "group_idx": np.asarray([gid], dtype="int64"),
            "start_tok": np.asarray([[prefix[-1]]], dtype="int64"),
            "start_pos": np.asarray([[L - 1]], dtype="int64"),
        }
        # decode-ahead coverage for the first dispatch: the prefill
        # writes positions [0, L-1), the first step() [L-1, L-1+steps)
        cover = min(L - 1 + self._steps, self._T)
        k_full = (L - 1) // self._ps  # prefix pages that end up full
        try:
            # member 0: encoder forward and (any) prefill
            slot0 = self._take_slot()
            slots.append(slot0)
            cached = []
            if self._prefix_cache is not None and L > 1:
                cached = self._prefix_cache.lookup(
                    self._src_fp(src, length), prefix)[:k_full]
            pages = []
            for pg in cached:
                self._pool.ref(pg)
                pages.append(pg)
            self._slot_pages[slot0] = pages
            self._slot_group[slot0] = gid
            self._provision(slot0, cover)
            feed = {
                "src_word": src,
                "src_len": np.asarray([[length]], dtype="int64"),
                "slot_idx": np.asarray([slot0], dtype="int64"),
                "page_row": self._page_row(pages),
            }
            feed.update(start_feed)
            self._run(self._admit_prog, feed, [])
            write_from = len(cached) * self._ps
            if write_from:
                self._prefix_cache.tokens_saved += write_from
            if write_from < L - 1:
                pw = np.full((1, self._T), self._eos, dtype="int64")
                pw[0, :L] = prefix
                self._run(self._prefill_prog, {
                    "prefix_word": pw,
                    "prefix_len": np.asarray([[L]], dtype="int64"),
                    "write_from": np.asarray([[write_from]],
                                             dtype="int64"),
                    "slot_idx": np.asarray([slot0], dtype="int64"),
                    "group_idx": np.asarray([gid], dtype="int64"),
                }, [])
            if self._prefix_cache is not None and k_full > len(cached):
                # the newly full pages join the cache (one reference
                # each), only after the prefill has landed their K/V
                self._prefix_cache.insert(
                    self._src_fp(src, length), prefix, pages[:k_full])
            # members 1..n-1 fork by reference. Shared: exactly the pages
            # that hold PREFIX content (full pages and the partial tail);
            # decode-ahead pages past the prefix are private per member
            # (sharing an empty page would only buy a certain COW copy).
            shared = pages[:pages_for(max(L - 1, 0), self._ps)]
            for _ in range(1, n):
                s = self._take_slot()
                slots.append(s)
                mpages = []
                for pg in shared:
                    self._pool.ref(pg)
                    mpages.append(pg)
                self._slot_pages[s] = mpages
                self._slot_group[s] = gid
                self._provision(s, cover)
                jfeed = {
                    "slot_idx": np.asarray([s], dtype="int64"),
                    "page_row": self._page_row(mpages),
                }
                jfeed.update(start_feed)
                self._run(self._join_prog, jfeed, [])
        except BaseException:
            self._rollback_admission(slots, gid, n)
            raise
        self._group_members[gid] = set(slots)
        for s in slots:
            trg = np.full(self._T, self._eos, dtype="int64")
            trg[:L] = prefix
            self._live[s] = {"trg": trg, "pos": L - 1}
        return slots

    def _rollback_admission(self, slots, gid, n):
        """A failed admission must leave NO device table row pointing at
        pages that go back to the free list: each admitted slot's row is
        pointed at the trash page FIRST (the order ``_release_pages``
        uses), THEN its page references drop. If even the repoint fails,
        the pages are LEAKED (kept allocated and taken off the
        reservation capacity): a smaller pool can be lived with, a
        recycled page that a stale row writes cannot. The free slots are
        restored exactly, so a retried admission lands in the same
        slots."""
        for s in slots:
            pages = self._slot_pages.pop(s, None)
            self._slot_group.pop(s, None)
            if pages is None:
                continue
            try:
                self._write_table_row(s, [])
            except BaseException:
                self._leaked_pages += len(set(pages))
                continue
            for pg in pages:
                self._pool.deref(pg)
        for s in reversed(slots):
            self._free.append(s)
        self._free_groups.append(gid)
        self._reserved_pages -= n * pages_for(self._T, self._ps)

    def step(self):
        """Advance every in-flight sequence: ``steps`` tokens through one
        ``run_multi_step`` call, or, in a speculative session (unless
        ``FLAGS_speculative=off``), 1 to k + 1 tokens through one verify
        dispatch, or, in a dense session, one token through one
        ``exe.run``. Returns ``{slot: [T] int64 tokens}`` for the
        sequences that finished (their slots and pages are free again).
        No-op ({}) when nothing is in flight."""
        if not self._live:
            return {}
        if not self._paged:
            out = self._step_dense()
        # the oracle: FLAGS_speculative=off routes this very session
        # through the plain sequential step, and flips mid-stream
        elif self._spec_k and flags.get("speculative") != "off":
            out = self._step_speculative()
        else:
            out = self._step_plain()
        self.steps_done += 1
        return out

    def _dense_feed(self):
        """The dense step program's feeds: every live slot's current
        token, position and position-encoding row (eos, 0 and zeros for
        a free slot)."""
        cur = np.full((self._S, 1), self._eos, dtype="int64")
        pos = np.zeros((self._S, 1), dtype="int64")
        pe = np.zeros((self._S, 1, self._D), dtype="float32")
        for slot, st in self._live.items():
            cur[slot, 0] = st["trg"][st["pos"]]
            pos[slot, 0] = st["pos"]
            pe[slot] = transformer.position_encoding_row(st["pos"], self._D)
        return {"cur_tok": cur, "pe_row": pe, "gen_pos": pos}

    def _step_dense(self):
        (toks,) = self._run(self._step_prog, self._dense_feed(),
                            [self._fetch_name])
        self.decode_steps += 1
        # [S, 1] token ids chosen on the device: the logits stay there
        return self._consume_tokens(np.asarray(toks).reshape(1, -1, 1))

    def _step_plain(self):
        # step j writes K/V at pos + j: every live slot's table covers
        # pos + steps before the loop starts, and any page the dispatch
        # will WRITE that is still shared is copy-on-write split first,
        # all in one dispatch
        self._dispatch_cow(self._cow_window(
            [(slot, st["pos"]) for slot, st in self._live.items()]))
        (toks,) = self._exe.run_multi_step(
            self._step_prog, self._steps, feed={},
            fetch_list=[self._fetch_name], scope=self._scope,
            stack_fetches=True)
        self.decode_steps += self._steps
        return self._consume_tokens(np.asarray(toks))  # [K, S, 1]

    def _step_speculative(self):
        """One draft-then-verify round: host drafting, ONE target
        dispatch that scores the anchor and k draft tokens as a tree in
        the slot's write pages, accept and commit in the program, then
        the host's bookkeeping by each slot's accept length."""
        # the verify dispatch writes the whole tree, storage positions
        # [pos, pos + N): COW and provisioning cover that span BEFORE the
        # drafter runs (the model drafter reads the same page tables)
        self._dispatch_cow(self._cow_window(
            [(slot, st["pos"]) for slot, st in self._live.items()],
            span=self._spec_nodes))
        draft = self._spec_drafter.propose(self._live)
        tok_seq, acc_len = self._run(self._spec_prog, {
            "spec_draft": draft.astype("int64"),
            "spec_parent": self._spec_parent,
            "spec_anc": self._spec_anc,
        }, [self._spec_fetches["spec_token_seq"],
            self._spec_fetches["spec_accept_len"]])
        tok_seq = np.asarray(tok_seq).reshape(self._S, self._spec_nodes)
        acc_len = np.asarray(acc_len).reshape(self._S)
        self.spec_proposed += self._spec_k * len(self._live)
        self.spec_accepted += int(sum(max(int(acc_len[s]) - 1, 0)
                                      for s in self._live))
        self.spec_dispatches += 1
        return self._consume_spec(tok_seq, acc_len)

    def _finish(self, slot, finished):
        finished[slot] = self._live.pop(slot)["trg"]
        self._free.append(slot)
        if self._paged:
            self._release_pages(slot)

    def _consume_spec(self, tok_seq, acc_len):
        """Apply one verify dispatch's commits to the live slots: exactly
        ``acc_len[slot]`` tokens per slot (entries past that are eos
        padding, NOT tokens)."""
        finished = {}
        for slot in list(self._live):
            st = self._live[slot]
            for j in range(int(acc_len[slot])):
                t = st["pos"]
                nxt = int(tok_seq[slot, j])
                st["trg"][t + 1] = nxt
                st["pos"] = t + 1
                if nxt == self._eos or t + 1 == self._T - 1:
                    self._finish(slot, finished)
                    break
        return finished

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
                    self._finish(slot, finished)
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

    def generate_best_of(self, src, n, src_len=None, prefix_tokens=None):
        """Best-of-N over ``admit_group``: decode ``n`` continuations of
        ONE source ([T] or [1, T] ids) to completion and return them as
        an [n, T] matrix in member order. Meant for a dedicated session
        (it steps until the group drains; other in-flight slots that
        finish meanwhile are returned to nobody)."""
        slots = self.admit_group(src, n=n, src_len=src_len,
                                 prefix_tokens=prefix_tokens)
        order = {s: i for i, s in enumerate(slots)}
        out = np.full((int(n), self._T), self._eos, dtype="int64")
        remaining = set(slots)
        while remaining:
            for slot, tokens in self.step().items():
                if slot in remaining:
                    out[order[slot]] = tokens
                    remaining.discard(slot)
        return out

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
