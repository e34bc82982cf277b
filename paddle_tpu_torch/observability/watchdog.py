"""Hang watchdog: declare and diagnose a stall.

Counterpart of ``paddle_tpu/observability/watchdog.py`` (a copy). Code
that may block (a batch dispatch's result wait, a client's socket read)
*arms* the watchdog and disarms on completion, guarded by the module
bool ``ENABLED``. A daemon thread declares a hang when armed work makes
no progress within the timeout: it dumps every thread's stack and the
black box, bumps ``paddle_tpu_watchdog_fires_total``, calls the
registered ``on_hang`` callbacks and, with ``FLAGS_watchdog_abort``,
aborts the process.

The timeout: an explicit ``start(timeout=)``, else
``FLAGS_watchdog_timeout``, else a multiple of telemetry's p95 step
time (``telemetry.step_stats()``, fed by the port's ``Executor``), else
300 s.
"""

import os
import threading
import time

from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability.metrics_registry import REGISTRY

__all__ = [
    "ENABLED", "start", "stop", "arm", "disarm", "progress",
    "effective_timeout", "is_running", "last_hang", "suspend",
    "register_on_hang", "unregister_on_hang",
]

ENABLED = False

# auto-timeout shape: max(p95 * _AUTO_MULT, _AUTO_MIN), else _AUTO_DEFAULT
_AUTO_MULT = 30.0
_AUTO_MIN = 10.0
_AUTO_DEFAULT = 300.0

_lock = lock_witness.make_lock("observability.watchdog")
_armed = {}              # token -> {"tag", "t_armed", "reported", "scale"}
_token_counter = [0]
_state = {
    "thread": None,
    "stop": None,        # threading.Event of the running thread
    "timeout": None,     # explicit override (start arg); None = flag/auto
    "on_hang": None,
    "abort": None,       # None = follow FLAGS_watchdog_abort
    "last_hang": None,
}

_on_hang_extra = []  # registered callbacks, called AFTER start()'s on_hang


def register_on_hang(fn):
    """Add a hang callback without displacing ``start(on_hang=...)``'s —
    how TrainSession banks an emergency checkpoint before
    ``FLAGS_watchdog_abort`` kills the process. Returns ``fn`` (the
    deregistration handle)."""
    with _lock:
        _on_hang_extra.append(fn)
    return fn


def unregister_on_hang(fn):
    # Timed acquire [C003]: reachable from TrainSession's SIGTERM
    # handler via close(), which may have interrupted the very thread
    # that holds _lock; a leaked callback beats a hung teardown.
    if _lock.acquire(timeout=1.0):
        try:
            try:
                _on_hang_extra.remove(fn)
            except ValueError:
                pass
        finally:
            _lock.release()


_fires = REGISTRY.counter(
    "paddle_tpu_watchdog_fires_total", "hangs declared by the watchdog")
_stalled_gauge = REGISTRY.gauge(
    "paddle_tpu_watchdog_stalled", "1 while a declared hang is unresolved")


def effective_timeout():
    """Explicit start() timeout > FLAGS_watchdog_timeout > auto from
    telemetry's p95 step time > 300s."""
    if _state["timeout"] and _state["timeout"] > 0:
        return float(_state["timeout"])
    from paddle_tpu_torch import flags

    try:
        flag = float(flags.get("watchdog_timeout"))
    except (KeyError, TypeError, ValueError):
        flag = 0.0
    if flag > 0:
        return flag
    from paddle_tpu_torch.observability import telemetry

    p95_ms = telemetry.step_stats().get("p95_ms")
    if p95_ms:
        return max(p95_ms / 1e3 * _AUTO_MULT, _AUTO_MIN)
    return _AUTO_DEFAULT


def arm(tag="work", scale=1):
    """Mark blocking work in flight; returns a token for :func:`disarm`.
    Callers guard on ``ENABLED``. Each token carries its own clock
    (``t_armed``): a process that sat idle for an hour is NOT instantly
    hung when the next step starts, and one wedged token cannot be
    absolved by other threads finishing their own work. ``scale``
    multiplies the timeout for THIS token — a run_multi_step dispatch of
    K steps legitimately blocks ~K times longer than the per-step p95
    the auto timeout is derived from."""
    with _lock:
        _token_counter[0] += 1
        token = _token_counter[0]
        _armed[token] = {"tag": tag, "t_armed": time.monotonic(),
                         "reported": False, "scale": max(1, int(scale))}
    return token


def disarm(token):
    """The armed work completed (or raised). Removes ONLY this token —
    a concurrent serving thread finishing its request must not reset the
    clock of another thread's wedged fetch."""
    with _lock:
        _armed.pop(token, None)
    _stalled_gauge.set(0)


def progress(token=None):
    """A liveness heartbeat without disarming. With ``token``, refresh
    that work unit's clock (multi-phase work that IS advancing); without
    one, an explicit whole-process heartbeat refreshing every armed
    token."""
    now = time.monotonic()
    with _lock:
        if token is not None:
            if token in _armed:
                _armed[token]["t_armed"] = now
                _armed[token]["reported"] = False
        else:
            for a in _armed.values():
                a["t_armed"] = now
                a["reported"] = False
    _stalled_gauge.set(0)


def last_hang():
    """The most recent hang report dict, or None (tests, post-mortems)."""
    with _lock:
        return dict(_state["last_hang"]) if _state["last_hang"] else None


_suspended = [0]


class suspend(object):
    """Context manager: no hang is declared while inside. For host work
    that is slow but provably alive (a first kernel build, which can
    run for seconds while the step-derived timeout is far shorter).
    On exit every armed token's clock restarts, so the suspended
    interval never counts against the work that follows."""

    def __enter__(self):
        with _lock:
            _suspended[0] += 1
        return self

    def __exit__(self, *exc):
        with _lock:
            _suspended[0] -= 1
            now = time.monotonic()
            for a in _armed.values():
                a["t_armed"] = now
        return False


def _fire(stalled, waited, timeout):
    from paddle_tpu_torch.observability import blackbox

    report = {
        "ts": time.time(),
        "waited_s": waited,
        "timeout_s": timeout,
        "stalled": [
            {"tag": a["tag"], "armed_for_s": time.monotonic() - a["t_armed"]}
            for a in stalled
        ],
    }
    # the JAX package also names the stalled step phase from its step
    # profiler here; that profiler is not ported (ROADMAP.md A9)
    with _lock:
        _state["last_hang"] = report
        on_hang = _state["on_hang"]
        abort = _state["abort"]
        extra_cbs = list(_on_hang_extra)
    _fires.inc()
    _stalled_gauge.set(1)
    stacks = blackbox.thread_stacks()
    blackbox.record("watchdog_hang", **{k: v for k, v in report.items()
                                        if k != "ts"})
    dump_path = blackbox.dump(
        reason="watchdog_hang", stacks=False,
        extra={"thread_stacks": stacks, "watchdog": report})
    report["dump_path"] = dump_path
    import logging

    phase_note = ""
    if report.get("stalled_phases"):
        phase_note = "; phase: " + ", ".join(
            "%s %.1fs" % (p["phase"], p["phase_age_s"])
            for p in report["stalled_phases"])
    logging.getLogger("paddle_tpu_torch.observability.watchdog").error(
        "watchdog: no progress for %.1fs (timeout %.1fs); stalled: %s%s; "
        "black box: %s", waited, timeout,
        ", ".join(s["tag"] for s in report["stalled"]), phase_note,
        dump_path)
    for cb in [on_hang] + extra_cbs:
        if cb is None:
            continue
        try:
            cb(report)
        except Exception:
            pass
    if abort is None:
        from paddle_tpu_torch import flags

        try:
            abort = bool(flags.get("watchdog_abort"))
        except KeyError:  # pragma: no cover
            abort = False
    if abort:
        # os.abort → SIGABRT: the blackbox signal handler already wrote
        # the dump; the supervisor sees a signal death, not a clean exit
        os.abort()


def _loop(stop_event):
    while not stop_event.wait(_poll_interval()):
        with _lock:
            if not _armed or _suspended[0]:
                continue
        timeout = effective_timeout()  # outside the lock: imports flags
        with _lock:
            # per-token aging: a hang is an ARMED unit of work older
            # than its (scale-adjusted) timeout, regardless of what
            # other threads are getting done — and each token is
            # reported ONCE per stall episode (a progress() on it
            # re-arms the report)
            now = time.monotonic()
            stalled = []
            worst = 0.0
            for a in _armed.values():
                age = now - a["t_armed"]
                worst = max(worst, age)
                if age > timeout * a["scale"] and not a["reported"]:
                    a["reported"] = True
                    stalled.append(dict(a))
        if stalled:
            _fire(stalled, worst, timeout)


def _poll_interval():
    try:
        return max(0.05, min(effective_timeout() / 4.0, 1.0))
    except Exception:
        return 1.0


def is_running():
    t = _state["thread"]
    return t is not None and t.is_alive()


def start(timeout=None, on_hang=None, abort=None):
    """Start the watchdog daemon thread (idempotent; re-calling updates
    timeout/on_hang/abort). ``timeout`` in seconds overrides the flag and
    the auto heuristic; ``abort=None`` follows ``FLAGS_watchdog_abort``."""
    global ENABLED
    with _lock:
        _state["timeout"] = timeout
        _state["on_hang"] = on_hang
        _state["abort"] = abort
    ENABLED = True
    if is_running():
        return _state["thread"]
    stop_event = threading.Event()
    t = threading.Thread(target=_loop, args=(stop_event,),
                         name="paddle-tpu-watchdog", daemon=True)
    _state["stop"] = stop_event
    _state["thread"] = t
    t.start()
    return t


def stop():
    """Stop the thread and disable the executor hooks."""
    global ENABLED
    ENABLED = False
    ev, t = _state["stop"], _state["thread"]
    if ev is not None:
        ev.set()
    if t is not None and t.is_alive():
        t.join(timeout=2.0)
    _state["thread"] = None
    _state["stop"] = None
    with _lock:
        _armed.clear()
    _stalled_gauge.set(0)


def _init_from_flags():
    from paddle_tpu_torch import flags

    try:
        if flags.get("watchdog"):
            start()
    except KeyError:  # pragma: no cover
        pass


_init_from_flags()
