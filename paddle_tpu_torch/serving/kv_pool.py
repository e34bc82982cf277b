"""Refcounted KV page pool + prefix cache: the host side of the paged
KV cache.

A copy of ``paddle_tpu/serving/kv_pool.py`` (host-only Python), without
its chaos-injection site, which comes with the resilience slice:

* :class:`PagePool` — pages carry a REFCOUNT. ``acquire()`` hands out a
  private page (refcount 1), ``ref()`` shares it, ``deref()`` frees it
  when the last reference drops. A page with refcount > 1 is read-shared
  and must not be written. Conservation: ``free_count + allocated_count
  == num_pages - 1`` at every step (page 0 is the reserved trash page and
  never circulates).
* :class:`PrefixCache` — a token trie keyed by ``(source fingerprint,
  prefix tokens)`` mapping to refcounted FULL pages; ``reclaim()`` is the
  free-list pressure valve. (The session of this slice does not enable
  it yet.)
"""

from paddle_tpu_torch.serving.server import ServingError

__all__ = ["PagePool", "PrefixCache", "NoFreePageError",
           "NoFreeGroupError"]


class NoFreePageError(ServingError):
    """The paged KV pool cannot RESERVE a new sequence's worst-case
    pages (``num_pages`` sized below worst-case occupancy) — the
    page-level admission reject; retry after a step() completes
    sequences and releases their reservations. Raised only at
    ``admit()``/``admit_group()`` (reservation-based admission
    control): a sequence that was admitted can always be provisioned
    mid-flight, so an oversubscribed pool degrades to fewer concurrent
    slots, never to a wedged session. The reject is a clean rollback —
    slot, group, page and reservation counts are exactly what they
    were before the call."""


class NoFreeGroupError(ServingError):
    """Every cross-attention K/V group row is occupied (``num_groups``
    sized below the concurrent-source worst case) — the group-level
    admission reject; retry after a step() drains a group's last
    member. Like :class:`NoFreePageError`, raised only at admission
    with full rollback."""


class PagePool(object):
    """Refcounted allocator over pages ``1..num_pages-1`` (page 0 is
    the caller's reserved trash page and never enters circulation).

    The free list is LIFO (the lowest page id is handed out first, as
    in the JAX package's allocator) so recycling behavior — and every
    bit-exactness test that depends on which physical page a sequence
    lands in — is deterministic.
    """

    def __init__(self, num_pages):
        self._P = int(num_pages)
        if self._P < 2:
            raise ValueError(
                "PagePool needs num_pages >= 2 (page 0 is the trash "
                "page), got %d" % self._P)
        self._free = list(range(self._P - 1, 0, -1))
        self._ref = {}  # page id -> refcount (> 0)

    @property
    def num_pages(self):
        return self._P

    @property
    def free_count(self):
        return len(self._free)

    @property
    def allocated_count(self):
        """Distinct pages with at least one reference."""
        return len(self._ref)

    @property
    def shared_count(self):
        """Distinct pages with refcount > 1 — the ``kv_pages_shared``
        gauge's source."""
        return sum(1 for c in self._ref.values() if c > 1)

    @property
    def extra_refs(self):
        """Sum of (refcount - 1): references that would each be a full
        physical page copy without sharing — the dedup-bytes gauge's
        page term."""
        return sum(c - 1 for c in self._ref.values())

    def refcount(self, page):
        return self._ref.get(int(page), 0)

    def acquire(self, reclaim=None):
        """Allocate a private page (refcount 1). With the free list
        empty, ``reclaim`` (the prefix cache's pressure valve) is given
        one chance to evict; still empty raises
        :class:`NoFreePageError` — which reservation-based admission
        control guarantees never happens for an admitted sequence."""
        if not self._free and reclaim is not None:
            reclaim()
        if not self._free:
            raise NoFreePageError(
                "KV page pool exhausted (%d pages, all referenced) — "
                "admission reservations should have prevented this; "
                "an unreserved caller must admit() first" % (self._P - 1))
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def ref(self, page):
        """Add a reference to an ALLOCATED page (share it)."""
        page = int(page)
        if page not in self._ref:
            raise ValueError(
                "PagePool.ref(%d): page is not allocated — only live "
                "pages can be shared" % page)
        self._ref[page] += 1

    def deref(self, page):
        """Drop one reference; the page returns to the free list only
        at refcount 0. Returns the remaining refcount."""
        page = int(page)
        c = self._ref.get(page, 0)
        if c <= 0:
            raise ValueError(
                "PagePool.deref(%d): page is not allocated (double "
                "free?)" % page)
        if c == 1:
            del self._ref[page]
            self._free.append(page)
            return 0
        self._ref[page] = c - 1
        return c - 1

    # -- snapshot dialect (serving/snapshot.py) -----------------------------
    def state_dict(self):
        """JSON-serializable allocator state: the exact free-list ORDER
        (LIFO recycling determinism is part of the bit-exactness
        contract — a restored pool must hand out the same physical
        pages a never-interrupted one would) plus every live
        refcount."""
        return {"num_pages": self._P,
                "free": list(self._free),
                "ref": {str(p): c for p, c in self._ref.items()}}

    @classmethod
    def from_state(cls, state):
        """Rebuild a pool from :meth:`state_dict` output, re-checking
        the conservation law (free + unique-allocated == P - 1) so a
        tampered/torn snapshot fails loud at restore, not as silent
        corruption three admissions later."""
        pool = cls(int(state["num_pages"]))
        free = [int(p) for p in state["free"]]
        ref = {int(p): int(c) for p, c in state["ref"].items()}
        if (len(free) + len(ref) != pool._P - 1
                or set(free) & set(ref)
                or not all(1 <= p < pool._P for p in list(free) + list(ref))
                or not all(c > 0 for c in ref.values())):
            raise ValueError(
                "PagePool state violates conservation: %d free + %d "
                "allocated != %d allocatable pages (or overlapping/"
                "out-of-range ids)" % (len(free), len(ref), pool._P - 1))
        pool._free = free
        pool._ref = ref
        return pool


class PrefixCache(object):
    """Token trie from (source fingerprint, forced-prefix tokens) to
    refcounted FULL KV pages.

    Only fully-written pages are cached: page ``k`` holds positions
    ``[k*page_size, (k+1)*page_size)`` and its content is a pure
    function of the source (cross-attention flows into every decoder
    layer past the first) and the first ``(k+1)*page_size`` forced
    tokens — exactly the trie key. The partial tail page is never
    cached: the admitted slot keeps writing into it. Cached pages are
    immutable by the COW contract (any writer sees refcount > 1 and
    copies first), so a hit is bit-identical to a cold prefill.

    Keys are stored chain-flat: an entry per page depth
    (``tokens[:page_size]``, ``tokens[:2*page_size]``, ...). Eviction
    is LRU and chain-aware — evicting a page orphans every deeper
    entry that extends it, so those are evicted with it (an orphaned
    deeper page would hold a reference lookup() can never reach).
    """

    def __init__(self, pool, page_size, max_pages=64):
        self._pool = pool
        self._ps = int(page_size)
        self._max = int(max_pages)
        self._entries = {}  # (fp, tokens tuple) -> page id
        self._lru = {}      # same keys -> last-use seq
        self._seq = 0
        self.lookups = 0
        self.hits = 0
        self.tokens_saved = 0
        # pages the MOST RECENT lookup matched: per-request attribution
        # (the admission's prefill trace span reads it right after its
        # lookup; cumulative hit_rate can't say which request hit)
        self.last_hit_pages = 0

    def __len__(self):
        return len(self._entries)

    @property
    def pages(self):
        """Distinct pages the cache holds references on."""
        return len(set(self._entries.values()))

    @property
    def hit_rate(self):
        return self.hits / self.lookups if self.lookups else 0.0

    def _touch(self, key):
        self._seq += 1
        self._lru[key] = self._seq

    def lookup(self, fp, tokens):
        """Longest cached run: the consecutive full pages covering
        ``tokens[:r*page_size]``. Takes NO references (the caller refs
        exactly what it provisions). Counts one lookup, and a hit when
        at least one page matched."""
        self.lookups += 1
        pages = []
        depth = self._ps
        tokens = tuple(int(t) for t in tokens)
        while depth <= len(tokens):
            page = self._entries.get((fp, tokens[:depth]))
            if page is None:
                break
            self._touch((fp, tokens[:depth]))
            pages.append(page)
            depth += self._ps
        if pages:
            self.hits += 1
        self.last_hit_pages = len(pages)
        return pages

    def insert(self, fp, tokens, pages):
        """Cache ``pages`` (``pages[k]`` = positions ``k*ps..(k+1)*ps-1``
        of this prefix, all fully written), one pool reference per NEW
        entry. Capacity pressure evicts LRU chains first; if the cache
        cannot make room the remaining pages simply stay uncached.
        A depth is only inserted while its PREDECESSOR depth is present
        (lookup walks the chain shallow-to-deep, so a deeper entry
        without its predecessor is unreachable and would pin a page
        reference forever) — eviction during this very insert can take
        the chain's own shallower entries, so the predecessor is
        re-checked after making room."""
        tokens = tuple(int(t) for t in tokens)
        for k, page in enumerate(pages):
            prev = (fp, tokens[:k * self._ps])
            if k and prev not in self._entries:
                return  # chain broken: deeper entries are unreachable
            key = (fp, tokens[:(k + 1) * self._ps])
            if key in self._entries:
                self._touch(key)
                continue
            while len(self._entries) >= self._max:
                if not self._evict_lru():
                    return
            if k and prev not in self._entries:
                return  # eviction consumed this chain's own prefix
            self._pool.ref(page)
            self._entries[key] = page
            self._touch(key)

    def _evict_lru(self):
        if not self._entries:
            return False
        key = min(self._lru, key=self._lru.get)
        self._evict_chain(key)
        return True

    def _evict_chain(self, key):
        fp, toks = key
        doomed = [k for k in self._entries
                  if k[0] == fp and len(k[1]) >= len(toks)
                  and k[1][:len(toks)] == toks]
        for k in doomed:
            self._pool.deref(self._entries.pop(k))
            self._lru.pop(k, None)

    def reclaim(self):
        """Free-list pressure valve (wired into ``PagePool.acquire``):
        evict LRU chains until a page actually frees — an entry whose
        page is still referenced by a live slot frees nothing, so
        eviction continues past it — or the cache is empty."""
        while self._entries and self._pool.free_count == 0:
            self._evict_lru()

    def clear(self):
        """Drop every entry (and its page references)."""
        while self._entries:
            self._evict_lru()

    # -- snapshot dialect (serving/snapshot.py) -----------------------------
    def state_dict(self):
        """JSON-serializable trie state: entries with their LRU
        sequence (eviction order must survive a restore) and the
        lifetime hit counters the gauges are derived from. Page
        REFERENCES are not transferable — the restoring side re-refs
        each entry's page against its own pool."""
        return {
            "page_size": self._ps,
            "max_pages": self._max,
            "entries": [[fp, list(toks), int(page), self._lru[(fp, toks)]]
                        for (fp, toks), page
                        in sorted(self._entries.items(),
                                  key=lambda kv: self._lru[kv[0]])],
            "seq": self._seq,
            "lookups": self.lookups,
            "hits": self.hits,
            "tokens_saved": self.tokens_saved,
        }

    @classmethod
    def from_state(cls, pool, state):
        """Rebuild a cache over ``pool`` from :meth:`state_dict` output.
        Takes NO new pool references: the allocator state serialized
        beside this trie already counts one reference per entry (the
        pool and cache snapshot together, restore together), so
        re-referencing here would inflate every cached page's refcount
        by one per restore. Entries pointing at unallocated pages are a
        torn snapshot and fail loud."""
        cache = cls(pool, int(state["page_size"]),
                    max_pages=int(state["max_pages"]))
        for fp, toks, page, seq in state["entries"]:
            key = (fp, tuple(int(t) for t in toks))
            if pool.refcount(int(page)) < 1:
                raise ValueError(
                    "PrefixCache state references page %d which the "
                    "restored pool does not hold allocated — torn "
                    "snapshot" % int(page))
            cache._entries[key] = int(page)
            cache._lru[key] = int(seq)
        cache._seq = int(state["seq"])
        cache.lookups = int(state["lookups"])
        cache.hits = int(state["hits"])
        cache.tokens_saved = int(state["tokens_saved"])
        return cache
