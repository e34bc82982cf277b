"""Runtime lock witness: named locks and their acquisition-order graph.

Counterpart of ``paddle_tpu/observability/lock_witness.py`` (a copy).
The serving plane builds its locks through the factories here
(``make_lock``/``make_rlock``/``make_condition``) under stable dotted
names. With ``FLAGS_lock_witness`` armed the returned wrapper records,
per thread, which named locks were held when each further lock was
acquired; the (held -> acquired) edges form one order graph where a
cycle is an ABBA deadlock waiting for the right interleave.
:func:`note_dispatch` reports a thread entering a device dispatch while
it holds a witnessed lock, and :func:`held_by_thread` annotates the
black box's thread stacks.

Overhead contract: ``ENABLED`` is read at lock CONSTRUCTION time. Off
(the default), every factory returns a plain ``threading`` primitive.
Arm with ``FLAGS_lock_witness=1`` before the subsystems import, or
:func:`enable` before they construct. Sinks: the
``paddle_tpu_lock_witness_{edges,cycles_total,long_holds_total}``
metrics, black-box events and the dump annotation. The witness's own
lock is never witnessed and only taken with a short timed acquire.
"""

import threading
import time

from paddle_tpu_torch.observability.metrics_registry import REGISTRY

__all__ = [
    "ENABLED", "enable", "disable", "reset",
    "make_lock", "make_rlock", "make_condition",
    "note_dispatch", "held_by_thread", "report", "registered_locks",
]

ENABLED = False

# guards the graph/report structures below; deliberately plain (never
# witnessed) and only ever taken via a short timed acquire
_WLOCK_TIMEOUT = 0.2
_wlock = threading.Lock()

_edges = {}        # (held_name, acquired_name) -> count
_edge_sites = {}   # (held_name, acquired_name) -> (thread_name,) sample
_cycles = []       # [{"cycle": [names...], "thread": name}]
_cycle_keys = set()  # dedup: frozenset of the cycle's edge pairs
_long_holds = []   # [{"locks": [...], "thread": name}]
_registered = {}   # name -> construction count (lock census)

# per-thread held stack, registered globally so forensics can read OTHER
# threads' holds: ident -> the thread's own held list (entries are
# [wrapper, t_acquire, depth]; list/dict ops ride the GIL, and readers
# only snapshot names — a torn read costs one stale annotation line)
_all_held = {}

_tls = threading.local()

_edges_gauge = REGISTRY.gauge(
    "paddle_tpu_lock_witness_edges",
    "distinct (held -> acquired) lock-order edges observed since arm")
_cycles_total = REGISTRY.counter(
    "paddle_tpu_lock_witness_cycles_total",
    "lock-order cycles (potential ABBA deadlocks) detected in the "
    "acquisition-order graph")
_long_holds_total = REGISTRY.counter(
    "paddle_tpu_lock_witness_long_holds_total",
    "device dispatches entered while the dispatching thread held a "
    "witnessed lock not registered allow_dispatch")


def enable(on=True):
    """Arm the witness for locks constructed AFTER this call."""
    global ENABLED
    ENABLED = bool(on)
    return ENABLED


def disable():
    return enable(False)


def reset():
    """Drop the recorded graph and reports (tests)."""
    with _wlock:
        _edges.clear()
        _edge_sites.clear()
        del _cycles[:]
        _cycle_keys.clear()
        del _long_holds[:]
        _registered.clear()
    _edges_gauge.set(0)


# -- factories ---------------------------------------------------------------

def make_lock(name, allow_dispatch=False):
    """A named mutex: plain ``threading.Lock()`` when the witness is
    off, a recording wrapper when armed. ``allow_dispatch=True`` marks a
    lock whose CONTRACT is to be held across a device dispatch (e.g. the
    per-Predictor serialization lock) — exempt from the long-hold check,
    still in the order graph."""
    if not ENABLED:
        return threading.Lock()
    return _WitnessLock(name, threading.Lock(), allow_dispatch)


def make_rlock(name, allow_dispatch=False):
    """Named reentrant lock (same contract as :func:`make_lock`).
    Reacquisition by the owning thread records no new edges."""
    if not ENABLED:
        return threading.RLock()
    return _WitnessLock(name, threading.RLock(), allow_dispatch)


def make_condition(name, lock=None):
    """Named condition variable. When armed, the underlying mutex is a
    witnessed lock (``Condition.wait``'s release/re-acquire cycles are
    recorded like any other); pass ``lock`` to share one witnessed mutex
    between several conditions (the reader-queue pattern)."""
    if not ENABLED:
        return threading.Condition(lock)
    if lock is None:
        lock = _WitnessLock(name, threading.Lock(), False)
    return threading.Condition(lock)


# -- the wrapper -------------------------------------------------------------

class _WitnessLock(object):
    """Duck-typed threading.Lock/RLock shell that reports acquisitions.

    ``acquire`` accepts the positional ``(blocking, timeout)`` shapes the
    stdlib uses internally (``Condition._is_owned`` probes with
    ``acquire(0)``), and ``__enter__``/``__exit__`` make it a context
    manager, so it drops into every ``with lock:`` site unchanged.
    """

    __slots__ = ("name", "allow_dispatch", "_inner")

    def __init__(self, name, inner, allow_dispatch):
        self.name = name
        self.allow_dispatch = allow_dispatch
        self._inner = inner
        _registered[name] = _registered.get(name, 0) + 1

    def acquire(self, blocking=True, timeout=-1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            _note_acquired(self)
        return got

    def release(self):
        _note_released(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    # Condition(lock) support: the stdlib saves/restores through these
    # when the backing lock is an RLock; for our wrapper the plain
    # release/acquire pair keeps the bookkeeping exact.
    def _release_save(self):
        self.release()

    def _acquire_restore(self, state):
        self.acquire()

    def _is_owned(self):
        held = getattr(_tls, "held", None)
        if held:
            for e in held:
                if e[0] is self:
                    return True
        # fall back to the stdlib probe for holds recorded before the
        # witness was armed on this thread
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return "<WitnessLock %s %s>" % (
            self.name, "locked" if self.locked() else "unlocked")


# -- bookkeeping -------------------------------------------------------------

def _held_list():
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
        _all_held[threading.get_ident()] = held
    return held


def _note_acquired(w):
    held = _held_list()
    for e in held:
        if e[0] is w:         # RLock reacquire: bump depth, no new edge
            e[2] += 1
            return
    if getattr(_tls, "busy", False):
        # witness reporting re-entered a witnessed lock (blackbox ring):
        # record nothing — a recursive report would deadlock on _wlock
        held.append([w, time.monotonic(), 1])
        return
    if held:
        _record_edges([e[0].name for e in held], w)
    held.append([w, time.monotonic(), 1])


def _note_released(w):
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is w:
            held[i][2] -= 1
            if held[i][2] <= 0:
                del held[i]
            return


def _record_edges(held_names, acquired):
    """Fold (held -> acquired) edges into the global graph; detect any
    cycle the new edges close. Lock discipline: graph mutation under a
    TIMED _wlock (drop the edge rather than block), reporting (metrics,
    blackbox) outside it under the thread-local busy flag."""
    new_cycles = []
    new_edge = False
    if not _wlock.acquire(timeout=_WLOCK_TIMEOUT):
        return
    try:
        tname = threading.current_thread().name
        for h in held_names:
            key = (h, acquired.name)
            if key in _edges:
                _edges[key] += 1
                continue
            _edges[key] = 1
            _edge_sites[key] = tname
            new_edge = True
            cyc = _find_cycle(acquired.name, h)
            if cyc is not None:
                ck = frozenset(zip(cyc, cyc[1:] + cyc[:1]))
                if ck not in _cycle_keys:
                    _cycle_keys.add(ck)
                    rec = {"cycle": cyc, "thread": tname}
                    _cycles.append(rec)
                    new_cycles.append(rec)
        n_edges = len(_edges)
    finally:
        _wlock.release()
    _tls.busy = True
    try:
        if new_edge:
            _edges_gauge.set(n_edges)
        for rec in new_cycles:
            _cycles_total.inc()
            from paddle_tpu_torch.observability import blackbox

            if blackbox.ENABLED:
                blackbox.record("lock_order_cycle",
                                cycle=list(rec["cycle"]),
                                thread=rec["thread"])
    finally:
        _tls.busy = False


def _find_cycle(start, target):
    """DFS over _edges (held under _wlock by the caller): a path
    start -> ... -> target means the new (target -> start) edge closes a
    cycle; returns the node list [start, ..., target] or None."""
    succ = {}
    for (a, b) in _edges:
        succ.setdefault(a, []).append(b)
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == target:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in succ.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


# -- dispatch / forensics hooks ----------------------------------------------

def note_dispatch():
    """Called by the executor immediately before handing a step to the
    device. A witnessed lock held RIGHT NOW by this thread (minus
    allow_dispatch registrations) is a hold spanning a device dispatch —
    the runtime twin of lint rule C002."""
    if not ENABLED:
        return
    held = getattr(_tls, "held", None)
    if not held:
        return
    names = [e[0].name for e in held if not e[0].allow_dispatch]
    if not names:
        return
    tname = threading.current_thread().name
    if _wlock.acquire(timeout=_WLOCK_TIMEOUT):
        try:
            _long_holds.append({"locks": names, "thread": tname})
        finally:
            _wlock.release()
    _tls.busy = True
    try:
        _long_holds_total.inc()
        from paddle_tpu_torch.observability import blackbox

        if blackbox.ENABLED:
            blackbox.record("lock_held_across_dispatch", locks=names,
                            thread=tname)
    finally:
        _tls.busy = False


def held_by_thread():
    """ident -> [named locks held right now], live threads only. The
    blackbox dump annotation; lock-free (snapshot reads of per-thread
    lists, torn reads cost one stale line in a forensics dump)."""
    live = {t.ident for t in threading.enumerate()}
    out = {}
    for ident, held in list(_all_held.items()):
        if ident not in live:
            _all_held.pop(ident, None)   # dead thread: drop its slot
            continue
        names = [e[0].name for e in list(held)]
        if names:
            out[ident] = names
    return out


def registered_locks():
    """name -> construction count (the lock census a smoke can assert
    coverage against)."""
    with _wlock:
        return dict(_registered)


def report():
    """The witness verdict: edges, cycles, dispatch holds. What the
    witness-armed frontend smoke asserts on (zero cycles, zero long
    holds)."""
    if not _wlock.acquire(timeout=_WLOCK_TIMEOUT):
        return {"edges": {}, "cycles": [], "long_holds": [],
                "registered": {}, "degraded": True}
    try:
        return {
            "edges": {"%s -> %s" % k: v for k, v in _edges.items()},
            "cycles": [dict(c) for c in _cycles],
            "long_holds": [dict(h) for h in _long_holds],
            "registered": dict(_registered),
            "degraded": False,
        }
    finally:
        _wlock.release()


def _init_from_flags():
    from paddle_tpu_torch import flags

    try:
        on = flags.get("lock_witness")
    except KeyError:  # pragma: no cover - flag table always has it
        on = False
    if on:
        enable()


_init_from_flags()
