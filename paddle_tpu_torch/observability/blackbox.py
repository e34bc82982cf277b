"""Crash black box: bounded flight-event ring, dumped on failure.

Counterpart of ``paddle_tpu/observability/blackbox.py`` (a copy). A
bounded ring collects compact flight events (the lock witness, chaos
faults, retries, the watchdog and the health monitors write into it);
on a fatal signal, a watchdog-declared hang or an explicit :func:`dump`
the ring, the telemetry step tail, the flags and (optionally) every
Python thread's stack go to one JSON file. The JAX package's dump also
carries its recompile explainer, step profiler and lint fold; those
modules are not ported (ROADMAP.md A9), so their keys hold empty lists.

Overhead contract: hooks guard on the module bool ``ENABLED``; with
``FLAGS_blackbox_path`` unset nothing is recorded and no handler is
installed.
"""

import atexit
import collections
import json
import os
import sys
import threading

from paddle_tpu_torch.observability import lock_witness
import time
import traceback

__all__ = [
    "ENABLED", "enable", "disable", "record", "record_dispatch",
    "record_exception", "record_nan_diagnostic", "record_oom_diagnostic",
    "dump", "snapshot", "thread_stacks", "events", "path",
    "install_handlers", "reset", "guard",
]

ENABLED = False

_RING_CAP = 512
_TAIL = 64           # telemetry/explainer records carried into a dump

_lock = lock_witness.make_lock("observability.blackbox")
_events = collections.deque(maxlen=_RING_CAP)
_path = [""]
_nan_diagnostic = [None]
_oom_diagnostic = [None]
_failure_dumped = [False]    # a failure dump exists: the atexit/benign
                             # dump must not overwrite the crash artifact

# Once-per-exception dump dedup marks the exception OBJECT itself:
# nested handlers (Predictor wrapping Executor, then sys.excepthook) see
# the same instance and skip the re-write. Not id()-based — CPython
# reuses a freed exception's address, and an id match would silently
# skip a NEW crash's dump. (Exceptions aren't weakref-able, so an
# attribute is the only per-object mark available.)
_DUMPED_ATTR = "_paddle_tpu_blackbox_dumped"


def _already_dumped(exc):
    return getattr(exc, _DUMPED_ATTR, False)


def _mark_dumped(exc):
    try:
        setattr(exc, _DUMPED_ATTR, True)
    except Exception:
        pass  # __slots__-only exception: a double dump beats a missing one
_handlers_installed = [False]
_prev_excepthook = [None]
_prev_signal = {}


def path():
    """The armed dump path ('' when disabled)."""
    return _path[0]


def enable(dump_path, handlers=True):
    """Arm the black box: record events, dump to ``dump_path`` on
    failure. ``handlers=True`` also chains ``sys.excepthook`` and the
    fatal-signal handlers (SIGTERM/SIGABRT) so crashes outside any
    executor still leave a dump."""
    global ENABLED
    if not dump_path:
        return disable()
    _path[0] = str(dump_path)
    ENABLED = True
    if handlers:
        install_handlers()
    return _path[0]


def disable():
    global ENABLED
    ENABLED = False
    _path[0] = ""
    return ""


def reset():
    """Drop recorded events and the NaN/OOM diagnostics (tests)."""
    with _lock:
        _events.clear()
        _nan_diagnostic[0] = None
        _oom_diagnostic[0] = None
        _failure_dumped[0] = False


def record(kind, **fields):
    """Append one compact flight event to the ring. Callers guard on
    ``ENABLED``; calling directly always records. The append is a TIMED
    acquire [C003]: record() is called straight from the preemption
    signal handlers (TrainSession, DecodeSnapshotManager), which run on
    the main thread and may have interrupted it mid-append — a blocking
    acquire there deadlocks the process short of dying. On timeout the
    event is dropped; a lost flight event beats a hung teardown."""
    ev = {"ts": time.time(), "kind": kind}
    ev.update(fields)
    if _lock.acquire(timeout=1.0):
        try:
            _events.append(ev)
        finally:
            _lock.release()
    return ev


def record_dispatch(origin, feed_specs=None, fetch_names=None,
                    fingerprint=None, **extra):
    """One executor/Predictor dispatch about to run: the event a crash
    dump's LAST entry points at when the step itself dies."""
    return record(
        "dispatch", origin=origin,
        feed_specs=sorted(
            (n, list(s), d) for n, (s, d) in (feed_specs or {}).items()),
        fetch_names=list(fetch_names or ()),
        fingerprint=str(fingerprint)[:16] if fingerprint else None,
        **extra)


def record_exception(origin, exc, dump_now=True, stacks=True):
    """An exception escaping ``origin``. Records the event always; writes
    the dump once per exception object (nested wrappers re-record but
    don't re-write). Crash dumps default to carrying thread stacks —
    the cost is paid only on the failure path."""
    ev = record(
        "exception", origin=origin,
        exc_type=type(exc).__name__,
        exc_message=str(exc)[:2000],
        traceback=traceback.format_exception(
            type(exc), exc, exc.__traceback__)[-12:],
    )
    if dump_now and ENABLED and not _already_dumped(exc):
        _mark_dumped(exc)
        dump(reason="unhandled_exception:%s" % origin, stacks=stacks)
    return ev


def record_nan_diagnostic(diag):
    """File the NaN-provenance finding (an analysis Diagnostic or its
    dict form) so dumps and tools/blackbox_dump.py can report — and CI
    can gate on — the blamed op."""
    d = diag.as_dict() if hasattr(diag, "as_dict") else dict(diag)
    with _lock:
        _nan_diagnostic[0] = d
    record("nan_diagnostic", **d)
    return d


def record_oom_diagnostic(diag, top_holders=None, predicted_peak_bytes=None,
                          live_bytes=None):
    """File the M001 OOM finding (observability/memory.py) with the
    ledger evidence — top live-buffer holders and the predicted peak —
    so the dump answers 'who held the memory' without a live process.
    tools/blackbox_dump.py exits 4 on it (distinct from NaN's 3)."""
    d = diag.as_dict() if hasattr(diag, "as_dict") else dict(diag)
    d["top_holders"] = list(top_holders or ())
    d["predicted_peak_bytes"] = predicted_peak_bytes
    d["live_bytes"] = live_bytes
    with _lock:
        _oom_diagnostic[0] = d
    record("oom_diagnostic", **d)
    return d


def events():
    with _lock:
        return [dict(e) for e in _events]


def thread_stacks():
    """Formatted stacks of every live Python thread — what the watchdog
    and fatal-signal dumps carry (sys._current_frames is the only
    in-process view of where a hung thread actually is). With the lock
    witness armed, each label carries the named locks that thread holds
    RIGHT NOW — a "hung in acquire" stack plus a "[holds: x]" peer line
    is a root cause, not a symptom."""
    names = {t.ident: t.name for t in threading.enumerate()}
    held = {}
    try:
        from paddle_tpu_torch.observability import lock_witness

        if lock_witness.ENABLED:
            held = lock_witness.held_by_thread()
    except Exception:
        pass  # annotation must never break a crash dump
    out = {}
    for ident, frame in sys._current_frames().items():
        label = "%s(%d)" % (names.get(ident, "thread"), ident)
        if ident in held:
            label += " [holds: %s]" % ", ".join(held[ident])
        out[label] = traceback.format_stack(frame)
    return out


def _read_locked(lock, read, default, timeout):
    """Read shared state under ``lock``. ``timeout=None`` blocks (the
    normal path); otherwise a timed acquire — the SIGNAL-HANDLER path,
    which runs on the main thread between bytecodes and may have
    interrupted that very thread while it HELD the lock (non-reentrant:
    a blocking acquire would deadlock the process instead of letting it
    die). On timeout the component degrades to ``default``; a partial
    dump beats a hung teardown."""
    if timeout is None:
        # conclint: C003 reason=flow-insensitive hit — every handler-context caller passes lock_timeout (the timed branch below); this branch is the ordinary off-handler path
        with lock:
            return read()
    if lock.acquire(timeout=timeout):
        try:
            return read()
        finally:
            lock.release()
    return default


def snapshot(reason="on_demand", stacks=False, extra=None,
             lock_timeout=None):
    """The dump payload as a dict (what :func:`dump` writes). With
    ``lock_timeout`` set, every lock-guarded component is read with a
    timed acquire directly off the backing structures (signal-handler
    safety — see :func:`_read_locked`); components whose lock can't be
    taken degrade to empty."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.observability import telemetry

    ring, nan, oom = _read_locked(
        _lock,
        lambda: ([dict(e) for e in _events],
                 dict(_nan_diagnostic[0]) if _nan_diagnostic[0] else None,
                 dict(_oom_diagnostic[0]) if _oom_diagnostic[0] else None),
        ([], None, None), lock_timeout)
    snap = {
        "blackbox_version": 1,
        "ts": time.time(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "reason": reason,
        "events": ring,
        "steps": _read_locked(
            telemetry._lock,
            lambda: [dict(r) for r in telemetry._records][-_TAIL:],
            [], lock_timeout),
        # the recompile explainer is not ported (ROADMAP.md A9)
        "recompiles": [],
        "flags": flags.all_flags(),
        "nan_diagnostic": nan,
        "oom_diagnostic": oom,
    }
    # requests in flight at crash time, by trace id (the forensics
    # question "WHOSE request died here" — resolve the ids against the
    # victim's .traces.jsonl or a surviving peer's ring)
    from paddle_tpu_torch.observability import tracing

    snap["inflight_traces"] = _read_locked(
        tracing._lock,
        lambda: [{"trace_id": t.id, "endpoint": t.endpoint,
                  "origin": t.origin,
                  "age_s": round(time.time() - t.t0, 3),
                  "spans_open": sum(1 for sp in t.spans
                                    if sp["t1"] is None)}
                 for t in tracing._inflight.values()],
        [], lock_timeout)
    # the step profiler and the lint fold of recompile events are not
    # ported (ROADMAP.md A9): their keys stay, empty
    snap["step_profile"] = []
    snap["step_inflight"] = []
    snap["lint_events"] = []
    if stacks:
        snap["thread_stacks"] = thread_stacks()
    if extra:
        snap.update(extra)
    return snap


def dump(dump_path=None, reason="on_demand", stacks=False, extra=None,
         lock_timeout=None):
    """Write the black box JSON (atomic rename so a reader never sees a
    torn file). Returns the path, or None when no path is configured.
    Never raises — a broken dump must not mask the original failure."""
    dump_path = dump_path or _path[0]
    if not dump_path:
        return None
    try:
        snap = snapshot(reason=reason, stacks=stacks, extra=extra,
                        lock_timeout=lock_timeout)
        tmp = "%s.tmp.%d" % (dump_path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(snap, f, sort_keys=True, default=repr)
        os.replace(tmp, dump_path)
        if reason not in ("atexit", "on_demand"):
            _failure_dumped[0] = True
        return dump_path
    except Exception:
        return None


class guard(object):
    """The forensics shell every blocking entry point wears, in ONE
    place: arms the watchdog for the duration (unless ``arm=False`` —
    serving layers whose inner executor call already arms) and records
    any escaping exception with this origin. Class-based, slot-bound:
    one small allocation per call, no generator frames — the hot path
    with both subsystems off stays two module-bool loads::

        with blackbox.guard("Executor.run"):
            ...blocking work...
    """

    __slots__ = ("origin", "arm", "scale", "_token")

    def __init__(self, origin, arm=True, scale=1):
        self.origin = origin
        self.arm = arm
        self.scale = scale  # timeout multiplier (K-step dispatches)
        self._token = None

    def __enter__(self):
        if self.arm:
            from paddle_tpu_torch.observability import watchdog

            if watchdog.ENABLED:
                self._token = watchdog.arm(self.origin, scale=self.scale)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None and ENABLED:
            record_exception(self.origin, exc)
        if self._token is not None:
            from paddle_tpu_torch.observability import watchdog

            watchdog.disarm(self._token)
        return False


# -- failure hooks -----------------------------------------------------------

def _excepthook(exc_type, exc, tb):
    try:
        if ENABLED and not _already_dumped(exc):
            _mark_dumped(exc)
            record("exception", origin="sys.excepthook",
                   exc_type=exc_type.__name__, exc_message=str(exc)[:2000],
                   traceback=traceback.format_exception(
                       exc_type, exc, tb)[-12:])
            dump(reason="unhandled_exception:sys.excepthook", stacks=True)
    finally:
        prev = _prev_excepthook[0] or sys.__excepthook__
        prev(exc_type, exc, tb)


def _signal_handler(signum, frame):
    import signal as _signal

    try:
        name = _signal.Signals(signum).name
    except Exception:
        name = str(signum)
    # This runs ON the main thread, possibly having interrupted it while
    # it held one of the observability locks — every lock here is a
    # timed acquire (see _read_locked), never a blocking one: a dump
    # with a degraded component beats a process that can no longer die
    # on SIGTERM.
    ev = {"ts": time.time(), "kind": "fatal_signal", "signal": name}
    if _lock.acquire(timeout=1.0):
        try:
            _events.append(ev)
        finally:
            _lock.release()
    dump(reason="fatal_signal:%s" % name, stacks=True, lock_timeout=1.0)
    # restore the pre-install disposition and re-raise so the process
    # still dies BY the signal (exit status and core behavior preserved —
    # supervisors keyed on "killed by SIGTERM" must not see a clean exit)
    prev = _prev_signal.get(signum, _signal.SIG_DFL)
    _signal.signal(signum, prev if callable(prev) or prev in (
        _signal.SIG_DFL, _signal.SIG_IGN) else _signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install_handlers():
    """Chain sys.excepthook and the catchable fatal signals
    (SIGTERM/SIGABRT; SIGINT is left to KeyboardInterrupt). Idempotent
    per handler: a first call from a NON-main thread (where
    signal.signal raises ValueError) chains only the excepthook and
    leaves the signals un-latched, so a later main-thread call still
    installs them — one early worker-thread enable() must not
    permanently disable fatal-signal dumps.

    Known tradeoff (any Python-level signal handler has it): the handler
    runs only when the main thread re-enters the interpreter loop, so a
    main thread wedged inside a non-interruptible C call (a dead-device
    ``block_until_ready``) neither dumps nor dies on SIGTERM — pair the
    black box with the watchdog (``FLAGS_watchdog_abort``) for hangs,
    and rely on the supervisor's SIGKILL escalation as the backstop."""
    if not _handlers_installed[0]:
        _handlers_installed[0] = True
        _prev_excepthook[0] = sys.excepthook
        sys.excepthook = _excepthook
    import signal as _signal

    for sig in (_signal.SIGTERM, _signal.SIGABRT):
        if sig in _prev_signal:
            continue  # already latched (only on success)
        try:
            _prev_signal[sig] = _signal.signal(sig, _signal_handler)
        except (ValueError, OSError):  # non-main thread / exotic platform
            pass


@atexit.register
def _dump_at_exit():
    # a process that armed the box but never crashed still leaves its
    # final flight picture (cheap; the file is tiny and atomic). NEVER
    # over a failure dump: the crash artifact — its reason line and its
    # thread stacks — must survive interpreter shutdown untouched.
    try:
        if ENABLED and not _failure_dumped[0]:
            dump(reason="atexit")
    except Exception:
        pass


def _init_from_flags():
    from paddle_tpu_torch import flags

    try:
        p = flags.get("blackbox_path")
    except KeyError:  # pragma: no cover - flag table always has it
        p = ""
    if p:
        enable(p)


_init_from_flags()
