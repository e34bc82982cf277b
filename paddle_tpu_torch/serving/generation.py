"""SlotDecodeSession: continuous batching over the block-paged KV pool or
dense slot caches.

Counterpart of ``paddle_tpu/serving/generation.py``: greedy and sampled decode.
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
(``enqueue``/``admit_pending``/``pump``/``take_result``/
``drop_pending``), page provisioning and release, the coalesced
copy-on-write dispatch, the typed rejects ``NoFreeSlotError``,
``NoFreePageError`` and ``NoFreeGroupError``, and what the network
frontend (``serving/frontend.py``) drives: ``cancel`` (a slot's
teardown, conservation-clean), graceful degradation (``degradation=``:
a ``HealthMonitor`` over page and slot occupancy; brownout evicts the
prefix cache and refuses forks, shed refuses admissions), request
tracing (``enqueue(..., trace_id=)``), the chaos sites ``serve.admit``
and ``serve.dispatch`` with the classified retry around an admission,
and ``in_dispatch``. Token selection is greedy or sampled
(``Sampler``: temperature or top-k, drawn from jax's threefry stream as
the JAX package draws it).

Beam search (``beam_width=K``, ``paged=True``, ``steps=1``): the slots
form ``S / K`` beam lanes of K aligned hypotheses. Each dispatch runs one
top-K lattice per lane (``slot_beam_search``, the dense ``beam_search``
op's ``beam_step``) and the hypothesis reorder in the program, as a
parent gather of the page-table rows; the host only rebinds refcounts
(every survivor references its parent's pages, then the old lists
deref), so a pure permutation moves no K/V byte, and copy-on-write fires
only when a duplicated parent's write page is next written.
``FLAGS_beam_reorder=reference`` is the copy-reorder oracle: every moved
hypothesis copies its parent's pages into fresh ones (counted in
``beam_reorder_pages``); its tokens and scores equal the rebind path's.
The step goes through ``Executor.run_multi_step`` (one step, captured on
a card like the greedy step) and the host reads back only the tokens,
parents and scores.

Snapshots (``serving/snapshot.py``): the public ops run inside a
dispatch window (``_begin_op`` / ``_end_op``); when the outermost window
closes, the session calls ``_after_dispatch`` (the snapshot manager's
quiesce hook: a deferred SIGTERM's final snapshot, or a periodic one).
The host books a snapshot reads beside the device state are the JAX
package's: ``_pending`` (``pending_requests``), ``_results``,
``_beam_results``, ``_trace_ids``, the leak ledger (``_leaked_pages`` and
``_leaked_page_ids``) and, on a beam session, ``_last_parents`` (each
lane's last parent permutation). Not ported yet (ROADMAP.md): the
session's metrics, the prefix cache's gauges among them (A9).
"""

import hashlib
import time
from collections import deque

import numpy as np

from paddle_tpu_torch import flags
from paddle_tpu_torch.analysis.lint import suggest_buckets
from paddle_tpu_torch.kernels.paged_attention import pages_for
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.resilience import chaos as _chaos
from paddle_tpu_torch.resilience import retry as _retry
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
    """Token-selection spec for the on-device decode loop.

    ``strategy``: ``"greedy"`` (argmax, the default), ``"temperature"``
    (softmax sampling at ``temperature``), or ``"top_k"`` (restrict to
    the ``top_k`` highest logits, then temperature-sample). Stochastic
    strategies draw from per-slot threefry streams keyed on ``(seed,
    slot, position)``, never the run's key, so a session rebuilt with
    the same ``seed`` replays the same tokens however the token loop is
    split into dispatches, and draws the JAX package's tokens."""

    def __init__(self, strategy="greedy", temperature=1.0, top_k=0,
                 seed=0):
        if strategy not in ("greedy", "temperature", "top_k"):
            raise ValueError(
                "Sampler strategy must be greedy/temperature/top_k, "
                "got %r" % (strategy,))
        if strategy == "top_k" and int(top_k) < 1:
            raise ValueError(
                "Sampler(strategy='top_k') needs top_k >= 1 — top_k=0 "
                "would silently sample the full vocabulary")
        self.strategy = strategy
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)


class SlotDecodeSession(object):
    """Continuous-batching decode over a block-paged KV pool
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

    ``beam_width=K`` (``paged=True``, ``steps=1``, ``num_slots`` a
    multiple of K, greedy only, no speculation) makes a beam session:
    ``admit_beam`` claims a lane of K aligned slots for one source,
    ``step()`` advances every lane one lattice step, and a finished
    lane's n-best goes to ``take_beam_result`` (after
    ``register_beam_owner``) or ``generate_beam``. The solo and fork
    admissions and the queue refuse.

    ``degradation`` (a dict of ``HealthMonitor`` thresholds, or True for
    the defaults) arms the healthy -> brownout -> shed machine over the
    tighter of page reservations / capacity and live slots / slots:
    brownout evicts the prefix cache and refuses forks (n > 1), shed
    refuses every admission, each with a typed retriable
    ``DegradedError``; ``admit_pending`` defers a degraded request to
    the front of the queue.
    """

    def __init__(self, exe, num_slots, max_length=64, d_model=128,
                 bos_id=1, eos_id=2, scope=None, paged=False,
                 page_size=8, num_pages=None, num_groups=None, steps=1,
                 sampler=None, prefix_cache_pages=0, degradation=None,
                 beam_width=1, speculative=None, **decoder_cfg):
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
        if self._spec_k and int(beam_width) > 1:
            raise ValueError(
                "speculative decode verifies the sampler stream — it does "
                "not compose with beam_width > 1")
        self._beam_width = int(beam_width)
        if self._beam_width < 1:
            raise ValueError("beam_width must be >= 1, got %d"
                             % self._beam_width)
        if self._beam_width > 1:
            if not paged:
                raise ValueError(
                    "beam_width > 1 needs paged=True — the zero-copy "
                    "reorder IS the page-table indirection")
            if int(steps) != 1:
                raise ValueError(
                    "beam_width > 1 needs steps=1: the reorder's refcount "
                    "rebinds (and COW of a duplicated parent's write page) "
                    "happen on the host BETWEEN dispatches — a multi-token "
                    "loop would write through unprovisioned, un-COWed rows")
            if int(num_slots) % self._beam_width:
                raise ValueError(
                    "beam_width=%d does not tile num_slots=%d into aligned "
                    "beam lanes" % (self._beam_width, int(num_slots)))
        self._exe = exe
        self._scope = scope
        self._sampler = sampler
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
        # beam bookkeeping: lanes of K aligned slots
        self._beam_live = {}      # lane -> {"slots": [...]}
        self._free_lanes = (list(range(self._S // self._beam_width - 1,
                                       -1, -1))
                            if self._beam_width > 1 else [])
        self._beam_events = {}    # lane -> last step's survivor event
        self._last_finished_beams = {}  # lane -> n-best payload
        self._beam_owner = {}     # lane -> request id
        self._last_parents = {}   # lane -> last local parent permutation
        self._beam_results = {}   # request id -> {"tokens", "scores"}
        self.beam_reorder_pages = 0  # page copies of the reorder oracle
        self.beam_cow_copies = 0     # COW splits charged to beam decode
        # request tracing: rid -> trace id for traced queued requests,
        # slot -> trace id for the step loop; COW copies per slot of the
        # current step window
        self._trace_ids = {}
        self._slot_traces = {}
        self._trace_cow = {}
        # public ops (admit/step/cancel) run inside a dispatch window;
        # ``in_dispatch`` tells a caller not to act on half-updated books
        self._dispatch_depth = 0
        # taken to open the outermost window: a thread other than the
        # owner holds it to keep the owner out of a dispatch (the
        # snapshot manager's idle finalize)
        self._window_lock = lock_witness.make_lock(
            "serving.generation.window")
        # called when the outermost window closes (the quiesce point a
        # DecodeSnapshotManager snapshots at)
        self._after_dispatch = None
        # graceful degradation, opt-in: None keeps the typed rejects
        # (NoFreeSlot/NoFreePage/NoFreeGroup) as the only admission
        # control
        if degradation is not None:
            from paddle_tpu_torch.serving.degradation import HealthMonitor

            cfg = dict(degradation) if isinstance(degradation, dict) \
                else {}
            cfg.setdefault("on_transition", self._on_health_transition)
            self._monitor = HealthMonitor("decode", **cfg)
        else:
            self._monitor = None
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
            beam_width=self._beam_width, speculative=self._spec_k,
            **decoder_cfg)
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
        if self._beam_width > 1:
            # the beam build returns a fetch-name dict (token / parent /
            # score / logits); a step fetches the first three
            self._beam_fetches = dict(self._fetch_name)
            self._fetch_name = self._beam_fetches["token"]
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
        self._leaked_page_ids = set()
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

    # -- dispatch window and degradation -------------------------------------
    def _begin_op(self):
        with self._window_lock:
            self._dispatch_depth += 1

    def _end_op(self):
        self._dispatch_depth -= 1
        if self._dispatch_depth == 0 and self._after_dispatch is not None:
            # the quiesce point: a snapshot manager banks a final
            # snapshot or takes a periodic one here, never mid-dispatch
            self._after_dispatch()

    @property
    def in_dispatch(self):
        """True while a public op (admit/step/cancel) is mutating state."""
        return self._dispatch_depth > 0

    def _health_load(self):
        """Load fraction the degradation monitor keys on: page
        occupancy (reservations over the leak-shrunk capacity) and slot
        occupancy, whichever is tighter."""
        slot_load = len(self._live) / float(self._S)
        if not self._paged:
            return slot_load
        cap = max(1, self._P - 1 - self._leaked_pages)
        return max(slot_load, self._reserved_pages / float(cap))

    def _on_health_transition(self, frm, to):
        from paddle_tpu_torch.serving.degradation import BROWNOUT, HEALTHY

        if frm == HEALTHY and to == BROWNOUT:
            # brownout's first act: cached-but-idle pages go back to the
            # free list, so admissions stop competing with the cache
            self.clear_prefix_cache()

    def _gate_admission(self, n):
        """Degradation gate, before any slot/page/queue mutation (a
        degraded reject is never a partial admission) and outside the
        classified retry (a shed session answers at once with its
        retry-after hint)."""
        if self._monitor is None:
            return
        from paddle_tpu_torch.serving.degradation import BROWNOUT, SHED

        state = self._monitor.observe(self._health_load())
        if state == SHED:
            raise self._monitor.reject("admission (draining in-flight)")
        if state == BROWNOUT and n > 1:
            raise self._monitor.reject(
                "fork admission (n=%d) — brownout serves n=1 only" % n)

    @property
    def health(self):
        """Degradation state ('healthy' when the monitor is off)."""
        from paddle_tpu_torch.serving.degradation import HEALTHY

        return self._monitor.state if self._monitor is not None \
            else HEALTHY

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
                self._leaked_page_ids.add(dst_pg)
            raise
        for _slot, src_pg, _dst in copies:
            self._pool.deref(src_pg)
        if self._slot_traces and copies:
            # per-slot COW attribution for the step window's traces
            for slot, _src, _dst in copies:
                self._trace_cow[slot] = self._trace_cow.get(slot, 0) + 1
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
        self._gate_admission(1)
        self._begin_op()
        try:
            return _retry.call(
                lambda: self._admit_dense_attempt(src, src_len),
                origin="serve.admit")
        finally:
            self._end_op()

    def _admit_dense_attempt(self, src, src_len):
        if not self._free:
            raise NoFreeSlotError(
                "all %d slots occupied; step() until one frees" % self._S)
        src = np.asarray(src, dtype="int64").reshape(1, self._T)
        length = self._T if src_len is None else int(np.ravel(src_len)[0])
        slot = self._take_slot()
        try:
            if _chaos.ENABLED:
                _chaos.fault("serve.admit")
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
        if self._beam_width > 1:
            raise ValueError(
                "this is a beam session (beam_width=%d): slots are "
                "lane-tiled — admissions go through admit_beam()"
                % self._beam_width)
        n = int(n)
        if n < 1:
            raise ValueError("admit_group needs n >= 1, got %d" % n)
        self._gate_admission(n)
        self._begin_op()
        try:
            # classified retry around the whole attempt: a transient fault
            # mid-admission rolls the group back (free stacks restored in
            # pop order), so the retry lands in the same slots and pages;
            # the typed rejects are not transient and surface at once
            return _retry.call(
                lambda: self._admit_group_attempt(src, n, src_len,
                                                  prefix_tokens),
                origin="serve.admit")
        finally:
            self._end_op()

    def _admit_group_attempt(self, src, n, src_len, prefix_tokens,
                             slots_override=None):
        # a beam admission hands the lane's aligned slots in, already off
        # the free stack (the caller returns the lane if this rolls back)
        pending_slots = (deque(slots_override)
                         if slots_override is not None else None)
        beam = self._beam_width > 1
        if pending_slots is None and len(self._free) < n:
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
            slot0 = (pending_slots.popleft() if pending_slots is not None
                     else self._take_slot())
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
            if beam:
                # hypothesis 0 seeds the lane's lattice at score 0, the
                # rest ride at -1e9 (the dense beam convention)
                feed["start_score"] = np.asarray([[0.0]], "float32")
            if _chaos.ENABLED:
                # slots popped, pages provisioned, nothing dispatched: a
                # fault here must roll the whole group back
                _chaos.fault("serve.admit")
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
                s = (pending_slots.popleft() if pending_slots is not None
                     else self._take_slot())
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
                if beam:
                    jfeed["start_score"] = np.asarray([[-1e9]], "float32")
                self._run(self._join_prog, jfeed, [])
        except BaseException:
            self._rollback_admission(slots, gid, n,
                                     restore_free=pending_slots is None)
            raise
        self._group_members[gid] = set(slots)
        for k, s in enumerate(slots):
            trg = np.full(self._T, self._eos, dtype="int64")
            trg[:L] = prefix
            self._live[s] = {"trg": trg, "pos": L - 1}
            if beam:
                self._live[s]["done"] = False
                self._live[s]["score"] = 0.0 if k == 0 else -1e9
        return slots

    def _rollback_admission(self, slots, gid, n, restore_free=True):
        """A failed admission must leave NO device table row pointing at
        pages that go back to the free list: each admitted slot's row is
        pointed at the trash page FIRST (the order ``_release_pages``
        uses), THEN its page references drop. If even the repoint fails,
        the pages are LEAKED (kept allocated and taken off the
        reservation capacity): a smaller pool can be lived with, a
        recycled page that a stale row writes cannot. The free slots are
        restored exactly, so a retried admission lands in the same
        slots (a beam lane's admission, ``restore_free=False``, returns its
        slots itself)."""
        for s in slots:
            pages = self._slot_pages.pop(s, None)
            self._slot_group.pop(s, None)
            if pages is None:
                continue
            try:
                self._write_table_row(s, [])
            except BaseException:
                self._leaked_pages += len(set(pages))
                self._leaked_page_ids.update(pages)
                continue
            for pg in pages:
                self._pool.deref(pg)
        if restore_free:
            for s in reversed(slots):
                self._free.append(s)
        self._free_groups.append(gid)
        self._reserved_pages -= n * pages_for(self._T, self._ps)

    # -- beam decode ---------------------------------------------------------
    @property
    def beam_width(self):
        return self._beam_width

    @property
    def free_beams(self):
        """Unoccupied beam lanes (beam sessions)."""
        return len(self._free_lanes) if self._beam_width > 1 else 0

    @property
    def active_beams(self):
        """Lane ids currently decoding (beam sessions)."""
        return sorted(self._beam_live) if self._beam_width > 1 else []

    def beam_slots(self, beam_id):
        """The K aligned slots of one live beam lane; hypothesis order is
        slot order (top-K keeps the survivors score-sorted)."""
        return list(self._beam_live[int(beam_id)]["slots"])

    def admit_beam(self, src, src_len=None, prefix_tokens=None):
        """Claim one beam LANE (``beam_width`` aligned slots) for one
        source: one encoder forward into a fresh cross-K/V group, one
        causal prefill for a forced prefix (prefix-cache hits provision
        by reference, and all K hypotheses share the prefix pages),
        hypothesis 0 seeded at score 0 and the rest at -1e9. Returns the
        beam id (the lane index). Raises :class:`NoFreeSlotError` when
        every lane is occupied, and ``admit_group``'s page and group
        rejects, each with a full rollback. Beams never queue."""
        if self._beam_width < 2:
            raise ValueError(
                "admit_beam needs a beam session — build with "
                "beam_width >= 2")
        self._gate_admission(self._beam_width)
        self._begin_op()
        try:
            return _retry.call(
                lambda: self._admit_beam_attempt(src, src_len,
                                                 prefix_tokens),
                origin="serve.admit")
        finally:
            self._end_op()

    def _admit_beam_attempt(self, src, src_len, prefix_tokens):
        if not self._free_lanes:
            raise NoFreeSlotError(
                "all %d beam lanes occupied; step() until one finishes"
                % (self._S // self._beam_width))
        K = self._beam_width
        lane = self._free_lanes.pop()
        slots = [lane * K + k for k in range(K)]
        for s in slots:
            self._free.remove(s)
        try:
            self._admit_group_attempt(src, K, src_len, prefix_tokens,
                                      slots_override=slots)
        except BaseException:
            # pages and group are rolled back; the lane returns whole
            for s in reversed(slots):
                self._free.append(s)
            self._free_lanes.append(lane)
            raise
        self._beam_live[lane] = {"slots": slots}
        self._last_parents[lane] = list(range(K))
        return lane

    def register_beam_owner(self, beam_id):
        """Attach a request id to a live beam: when it finishes, its
        n-best lands in the beam result bank under this id. Returns the
        id (drawn from the counter solo requests draw from)."""
        lane = int(beam_id)
        if lane not in self._beam_live:
            raise ValueError("beam %d is not live" % lane)
        rid = self._next_req
        self._next_req += 1
        self._beam_owner[lane] = rid
        return rid

    def take_beam_result(self, request_id):
        """Claim (and remove) a finished beam's n-best by request id:
        ``{"tokens": [K, T] int64 (score-descending), "scores": [K]
        float32}``, or None if unknown or unfinished."""
        if not self._beam_results:
            return None
        return self._beam_results.pop(int(request_id), None)

    @property
    def last_beam_events(self):
        """The LAST dispatch's survivors per live lane: ``{lane:
        {"parents", "tokens", "scores", "done"}}`` (what a streaming
        frontend sends per dispatch). Lanes that finished are in
        :attr:`last_finished_beams` instead."""
        return self._beam_events

    @property
    def last_finished_beams(self):
        """The beams the LAST step completed: ``{lane: {"tokens" [K, T],
        "scores" [K], "slots", "parents", "step_tokens",
        "step_scores"}}`` in score-descending hypothesis order."""
        return self._last_finished_beams

    def _reorder_lane(self, slots, perm):
        """One lane's parent permutation on the host. The device already
        gathered the page-table rows; here the refcounts catch up: each
        survivor references its parent's pages, then every old list
        derefs (new lists first, so no page's count passes through 0). A
        pure permutation leaves every refcount as it was: no page moves,
        frees or is copied. Under ``FLAGS_beam_reorder=reference`` every
        survivor with ``perm[k] != k`` instead COPIES its parent's
        resident pages into fresh private ones (one coalesced dispatch,
        counted in ``beam_reorder_pages``): the copy-reorder oracle."""
        K = len(slots)
        old_pages = [self._slot_pages[s] for s in slots]
        new_pages = []
        for k in range(K):
            lst = list(old_pages[perm[k]])
            for pg in lst:
                self._pool.ref(pg)
            new_pages.append(lst)
        for lst in old_pages:
            for pg in lst:
                self._pool.deref(pg)
        for k, s in enumerate(slots):
            self._slot_pages[s] = new_pages[k]
        if flags.get("beam_reorder") != "reference":
            return
        # every destination page is acquired BEFORE any slot's list
        # changes: a NoFreePageError mid-plan leaves the rebound refcounts
        # as they stand (the fresh pages just go back)
        window = []
        fresh_lists = {}
        try:
            for k, s in enumerate(slots):
                if perm[k] == k:
                    continue
                fresh = []
                for pg in self._slot_pages[s]:
                    dst = self._acquire_page()
                    window.append((s, pg, dst))
                    fresh.append(dst)
                fresh_lists[s] = fresh
        except BaseException:
            for _s, _src, dst in window:
                self._pool.deref(dst)  # acquired at refcount 1
            raise
        for s, fresh in fresh_lists.items():
            self._slot_pages[s] = fresh
        if window:
            self._dispatch_cow(window)  # derefs the sources once it lands
            self.beam_reorder_pages += len(window)

    def _step_beam(self):
        # copy-on-write and provisioning for LIVE hypotheses only: a done
        # hypothesis writes to the trash page in the program
        before_pairs = self.cow_pairs
        self._dispatch_cow(self._cow_window(
            [(s, st["pos"]) for s, st in self._live.items()
             if not st["done"]]))
        # write-page splits of duplicated parents; the oracle's reorder
        # copies count apart (beam_reorder_pages)
        self.beam_cow_copies += self.cow_pairs - before_pairs
        extras = list(getattr(self, "_extra_step_fetches", ()))
        out = self._exe.run_multi_step(
            self._step_prog, 1, feed={},
            fetch_list=[self._beam_fetches["token"],
                        self._beam_fetches["parent"],
                        self._beam_fetches["score"]] + extras,
            scope=self._scope, stack_fetches=True)
        self.decode_steps += 1
        # test hook: extra fetches (the step's logits for the offline
        # lattice check) ride the same dispatch
        self.last_extra_fetches = [np.asarray(x)[0] for x in out[3:]]
        toks = np.asarray(out[0]).reshape(self._S)
        parents = np.asarray(out[1]).reshape(self._S)
        scores = np.asarray(out[2]).reshape(self._S)
        K = self._beam_width
        finished = {}
        self._beam_events = {}
        self._last_finished_beams = {}
        for lane in sorted(self._beam_live):
            slots = self._beam_live[lane]["slots"]
            perm = [int(parents[s]) - slots[0] for s in slots]
            old = [self._live[s] for s in slots]
            if perm != list(range(K)):
                self._reorder_lane(slots, perm)
            new_states = []
            for k, s in enumerate(slots):
                parent = old[perm[k]]
                tok = int(toks[s])
                sc = float(scores[s])
                if parent["done"]:
                    # a frozen hypothesis carried forward unchanged (its
                    # lattice candidate was (eos, score))
                    st = {"trg": parent["trg"].copy(), "pos": parent["pos"],
                          "done": True, "score": sc}
                else:
                    pos = min(parent["pos"] + 1, self._T - 1)
                    trg = parent["trg"].copy()
                    trg[pos] = tok
                    st = {"trg": trg, "pos": pos,
                          "done": (tok == self._eos
                                   or parent["pos"] + 1 >= self._T - 1),
                          "score": sc}
                new_states.append(st)
            for k, s in enumerate(slots):
                self._live[s] = new_states[k]
            self._last_parents[lane] = perm
            step_tokens = [int(toks[s]) for s in slots]
            step_scores = [float(scores[s]) for s in slots]
            if all(st["done"] for st in new_states):
                tokens = np.stack([st["trg"] for st in new_states])
                lane_scores = np.asarray([st["score"] for st in new_states],
                                         "float32")
                self._last_finished_beams[lane] = {
                    "tokens": tokens, "scores": lane_scores,
                    "slots": list(slots),
                    # the final survivor chunk: a streaming frontend sends
                    # it before the n-best
                    "parents": perm, "step_tokens": step_tokens,
                    "step_scores": step_scores,
                }
                for s in slots:
                    finished[s] = self._live.pop(s)["trg"]
                    self._free.append(s)
                    self._release_pages(s)
                del self._beam_live[lane]
                self._last_parents.pop(lane, None)
                self._free_lanes.append(lane)
                rid = self._beam_owner.pop(lane, None)
                if rid is not None:
                    self._beam_results[rid] = {"tokens": tokens,
                                               "scores": lane_scores}
            else:
                self._beam_events[lane] = {
                    "parents": perm, "tokens": step_tokens,
                    "scores": step_scores,
                    "done": [bool(st["done"]) for st in new_states],
                }
        return finished

    def generate_beam(self, src, src_len=None, prefix_tokens=None,
                      len_penalty=None):
        """Run ONE beam to completion on a dedicated session and return
        ``(tokens [K, T] int64, scores [K] float32)`` in score-descending
        hypothesis order (bos-led, eos-padded rows). With ``len_penalty``
        the n-best is reordered under the GNMT length penalty
        (``transformer.gnmt_rescore_nbest``, the formula the offline
        ``beam_generate`` picks with) and the scores returned are the
        penalized ones. Lanes that finish meanwhile go to nobody: use
        :meth:`register_beam_owner` and :meth:`take_beam_result` for
        concurrent consumers."""
        lane = self.admit_beam(src, src_len=src_len,
                               prefix_tokens=prefix_tokens)
        rid = self.register_beam_owner(lane)
        while lane in self._beam_live:
            self.step()
        out = self.take_beam_result(rid)
        if len_penalty is None:
            return out["tokens"], out["scores"]
        _order, tokens, scores = transformer.gnmt_rescore_nbest(
            out["tokens"], out["scores"], self._eos, float(len_penalty))
        return tokens, scores

    def cancel(self, slot):
        """Abort one in-flight sequence (the frontend's disconnect and
        cancel teardown): the slot frees, its table row is repointed at
        the trash page FIRST and then its page references drop (the
        ``_release_pages`` order), its group loses a member and any
        request ownership is dropped WITHOUT banking a result. Returns
        True when the slot was live. Call between dispatches;
        :attr:`pool_conserved` holds afterwards.

        On a beam session a slot is one hypothesis of a lane, and a lane
        is one request: cancelling any member releases the WHOLE beam
        (every sibling slot, the lane and its owner binding; nothing
        banks)."""
        slot = int(slot)
        if slot not in self._live:
            return False
        if self._beam_width > 1:
            lane = slot // self._beam_width
            binfo = self._beam_live.pop(lane, None)
            if binfo is None:
                return False
            ok = True
            for s in binfo["slots"]:
                if s in self._live:
                    ok = self._cancel_one(s) and ok
            self._free_lanes.append(lane)
            self._last_parents.pop(lane, None)
            self._beam_events.pop(lane, None)
            self._beam_owner.pop(lane, None)  # cancelled, never banked
            return ok
        return self._cancel_one(slot)

    def _cancel_one(self, slot):
        self._begin_op()
        try:
            del self._live[slot]
            if self._paged:
                try:
                    self._release_pages(slot)
                except BaseException:
                    if slot not in self._slot_pages:
                        raise  # the deref path broke: a real bug
                    # the trash repoint failed: the device row may still
                    # point at these pages, so they are LEAKED (kept
                    # allocated) rather than handed to a later sequence;
                    # the group and reservation books still close
                    pages = self._slot_pages.pop(slot)
                    self._leaked_pages += len(set(pages))
                    self._leaked_page_ids.update(pages)
                    gid = self._slot_group.pop(slot, None)
                    members = self._group_members.get(gid)
                    if members is not None:
                        members.discard(slot)
                        if not members:
                            del self._group_members[gid]
                            self._free_groups.append(gid)
                    self._reserved_pages -= pages_for(self._T, self._ps)
            self._free.append(slot)
            rid = self._owner.pop(slot, None)
            if self._slot_traces or self._trace_ids:
                self._trace_cancel(slot, rid)
        finally:
            self._end_op()
        return True

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
        traced = bool(self._slot_traces) and _tracing.ENABLED
        if traced:
            t_step = time.time()
            pre_pos = {s: self._live[s]["pos"]
                       for s in self._slot_traces if s in self._live}
            pre_spec = self.spec_dispatches
            self._trace_cow.clear()
        self._begin_op()
        try:
            if _chaos.ENABLED:
                _chaos.fault("serve.dispatch", step=self.steps_done)
            if not self._paged:
                out = self._step_dense()
            elif self._beam_width > 1:
                out = self._step_beam()
            # the oracle: FLAGS_speculative=off routes this very session
            # through the plain sequential step, and flips mid-stream
            elif self._spec_k and flags.get("speculative") != "off":
                out = self._step_speculative()
            else:
                out = self._step_plain()
            self.steps_done += 1
        finally:
            self._end_op()
        if traced and pre_pos:
            self._trace_step(pre_pos, out, t_step, time.time(),
                             self.spec_dispatches > pre_spec)
        if self._monitor is not None:
            self._monitor.observe(self._health_load())
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
    @property
    def pending_requests(self):
        """Queued request ids not yet admitted, in admission order."""
        return [r["id"] for r in self._pending]

    def enqueue(self, src, src_len=None, prefix_tokens=None,
                trace_id=None):
        """Queue one request ([T] or [1, T] int ids); :meth:`pump` admits
        queued requests as capacity frees. Returns a request id
        (monotonic per session). ``trace_id`` binds the request to an
        in-flight request trace (``observability/tracing.py``)."""
        if self._beam_width > 1:
            raise ValueError(
                "beam sessions are admit-or-reject (admit_beam): a beam's "
                "K x worst-case reservation is too large to queue")
        rid = self._next_req
        self._next_req += 1
        entry = {
            "id": rid,
            "src": np.asarray(src, dtype="int64").reshape(1, self._T),
            "len": self._T if src_len is None
            else int(np.ravel(src_len)[0]),
            "prefix": (None if prefix_tokens is None
                       else [int(t) for t in prefix_tokens]),
        }
        if trace_id:
            # t_enq feeds the queue-wait span at admission
            self._trace_ids[rid] = str(trace_id)
            entry["t_enq"] = time.time()
        self._pending.append(entry)
        return rid

    def drop_pending(self, request_id):
        """Remove one not-yet-admitted request from the backlog (the
        disconnect path of a queued wire request). Returns True when it
        was still queued."""
        rid = int(request_id)
        for i, req in enumerate(self._pending):
            if req["id"] == rid:
                del self._pending[i]
                if self._trace_ids:
                    tid = self._trace_ids.pop(rid, None)
                    tr = (_tracing.inflight_get(tid) if tid is not None
                          else None)
                    if tr is not None and tr.origin == "session":
                        _tracing.finish(tr, outcome="dropped")
                return True
        return False

    def admit_pending(self):
        """Admit queued requests in order while capacity allows (a
        page/group reject, or a degradation reject when the monitor is
        armed, defers the request back to the FRONT). Returns
        ``{slot: request_id}`` for the requests admitted by this call."""
        from paddle_tpu_torch.serving.degradation import DegradedError

        admitted = {}
        while self._pending and self._free:
            # pop -> admit -> owner record is one dispatch window
            self._begin_op()
            deferred = False
            try:
                req = self._pending.popleft()
                traced = req["id"] in self._trace_ids
                t_admit = time.time() if traced else 0.0
                try:
                    slot = self.admit(req["src"], req["len"],
                                      prefix_tokens=req["prefix"])
                except (NoFreePageError, NoFreeGroupError, DegradedError):
                    self._pending.appendleft(req)
                    deferred = True
                else:
                    self._owner[slot] = req["id"]
                    admitted[slot] = req["id"]
                    if traced:
                        self._trace_admitted(req, slot, t_admit)
            finally:
                self._end_op()
            if deferred:
                break
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
                self._trace_bank(rid)
        return finished

    def take_result(self, request_id):
        """Claim (and remove) a finished request's [T] tokens, or None.
        Claiming retires the request's trace-id binding."""
        rid = int(request_id)
        out = self._results.pop(rid, None)
        if out is not None and self._trace_ids:
            self._trace_ids.pop(rid, None)
        return out

    # -- request tracing -----------------------------------------------------
    def _trace_admitted(self, req, slot, t_admit):
        """A queued traced request's admission: the queue-wait and
        prefill spans, and the slot -> trace binding for the step
        loop."""
        rid = req["id"]
        tid = self._trace_ids.get(rid)
        if tid is None:
            return
        tr = _tracing.inflight_get(tid)
        if tr is None:
            tr = _tracing.start(tid, endpoint="generate", origin="session")
        t_enq = req.get("t_enq")
        if t_enq is not None:
            tr.span("queue", t_enq, t_admit, rid=int(rid))
        hit_pages = (getattr(self._prefix_cache, "last_hit_pages", 0)
                     if self._paged and self._prefix_cache is not None
                     else 0)
        tr.span("prefill", t_admit, time.time(), kind="solo",
                slot=int(slot), rid=int(rid),
                prefix_hit_pages=int(hit_pages))
        self._slot_traces[slot] = tid

    def _trace_bank(self, rid):
        """Close a session-origin trace when its result banks (a finish
        no wire stream owns). The rid -> trace binding stays until
        :meth:`take_result` claims the row."""
        if not self._trace_ids:
            return
        tid = self._trace_ids.get(int(rid))
        tr = _tracing.inflight_get(tid) if tid is not None else None
        if tr is not None and tr.origin == "session":
            _tracing.finish(tr, outcome="banked")

    def _trace_cancel(self, slot, rid):
        """Cancel-side trace teardown: unbind the slot, retire the rid
        binding and close a session-origin trace, so a cancelled request
        never leaves an open span in flight."""
        tid = self._slot_traces.pop(slot, None)
        if rid is not None:
            tid = self._trace_ids.pop(int(rid), None) or tid
        tr = _tracing.inflight_get(tid) if tid is not None else None
        if tr is None:
            return
        tr.sample_pages(0)
        if tr.origin == "session":
            _tracing.finish(tr, outcome="cancelled")

    def _tokens_past(self, trg, prev):
        """Tokens a finished row generated past position ``prev``
        (through its terminal eos, or the max-length cap)."""
        for idx in range(prev + 1, self._T):
            if int(trg[idx]) == self._eos:
                return idx - prev
        return self._T - 1 - prev

    def _trace_step(self, pre_pos, out, t0, t1, was_spec):
        """One ``decode.step`` span per traced slot that was live when
        the step launched (tokens committed, COW copies, speculative or
        not), the trace's accumulators, and a page-count sample per
        trace. Host bookkeeping after the dispatch window."""
        touched = set()
        for slot, prev in pre_pos.items():
            tid = self._slot_traces.get(slot)
            tr = (_tracing.inflight_get(tid) if tid is not None
                  else None)
            if tr is None:
                continue
            finished_here = slot not in self._live
            if finished_here:
                trg = out.get(slot)
                delta = (self._tokens_past(trg, prev)
                         if trg is not None else 0)
            else:
                delta = self._live[slot]["pos"] - prev
            cow = self._trace_cow.pop(slot, 0)
            tr.span("decode.step", t0, t1, slot=int(slot),
                    tokens=int(delta), cow_copies=int(cow),
                    speculative=bool(was_spec))
            if delta > 0:
                tr.bump("tokens", int(delta))
                if was_spec:
                    tr.bump("tokens_from_spec", int(delta) - 1)
            if cow:
                tr.bump("cow_copies", int(cow))
            if finished_here:
                self._slot_traces.pop(slot, None)
            touched.add(tid)
        for tid in touched:
            tr = _tracing.inflight_get(tid)
            if tr is None:
                continue
            npages = (sum(len(self._slot_pages.get(s, ()))
                          for s, t in self._slot_traces.items()
                          if t == tid)
                      if self._paged else 0)
            tr.sample_pages(npages)

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
