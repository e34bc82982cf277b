"""Deterministic fault injection: the chaos harness recovery code is
proved against.

Counterpart of ``paddle_tpu/resilience/chaos.py`` (a copy): the same
spec grammar, fault kinds and site names, so one ``FLAGS_chaos_spec``
arms both packages alike. Faults are *seeded and reproducible*, so the
tests exercise the exact recovery paths flaky IO and overload take.

Spec grammar (``FLAGS_chaos_spec``)::

    spec    := clause (';' clause)*
    clause  := 'seed=' INT                      -- RNG seed for p= draws
             | kind '@' param (',' param)*
    kind    := 'kill' | 'io' | 'compile' | 'slow' | 'oom'
    param   := 'site=' NAME    -- site to arm (default: kind's home site)
             | 'step=' INT     -- fire exactly when the caller's step == N
             | 'p=' FLOAT      -- fire probability per visit (seeded draw)
             | 'n=' INT        -- total fire budget (default: kill 1, else
                                  unlimited)
             | 'skip=' INT     -- ignore the first K visits to the site
                                  (deterministic "fail LATER" at sites
                                  that don't pass a step number, e.g.
                                  exec.dispatch after warmup steps)
             | 'secs=' FLOAT   -- sleep length (slow only, default 0.1)

Examples::

    kill@step=7                       # SIGKILL self entering step 7
    kill@site=ckpt.write,n=1          # die mid-checkpoint-write, once
    io@site=ckpt.write,p=0.5          # checkpoint writes fail half the time
    compile@n=2;seed=11               # first two fresh compiles fail
    slow@site=exec.dispatch,p=0.1,secs=0.3

Sites instrumented in the port: ``serve.dispatch`` (the
BatchingServer batch dispatch and the decode session's step dispatch,
which passes ``step=steps_done``), ``serve.admit`` (inside a slot
admission, after slots and pages are claimed and before the dispatch: a
fault here must roll the whole group back and, under retry, re-admit
into the same slots), ``pool.acquire`` (the KV page allocator) and the
wire sites of ``distributed/master.py``'s ``serve_json_lines``:
``net.accept`` (sever a just-accepted connection before any request is
read; the client must reconnect) and ``net.send`` (fail a response
write, severing the connection; the client retries a unary call or
raises a typed StreamBrokenError on a broken stream, never hangs).
``master.call`` is the MasterClient RPC. The JAX package's training,
checkpoint, router and migration sites come with their modules.

Determinism: each clause owns a ``random.Random`` seeded by
``(seed, clause index)``, advanced once per visit to its site — a fixed
spec against a fixed single-threaded training loop fires at the same
steps every run, which is what lets the chaos CI stage assert *exact*
resume behavior instead of flaky approximations.

Injected faults raise :class:`ChaosIOError` (an ``IOError``) or
:class:`ChaosTransientError` — both classified retryable by
``resilience/retry.py``, so a run with retries enabled must *survive*
them and a run without must die loudly. The ``oom`` kind raises
:class:`ChaosOOMError`, a RESOURCE_EXHAUSTED-style failure classified
NEVER-transient: a run with retries enabled must die on the FIRST
attempt (no budget burned on a deterministic allocator death) and leave
an M001 black-box dump (observability/memory.py). Every fire is counted
(``paddle_tpu_chaos_faults_total{site,kind}``) and filed to the black
box, so a test can prove the fault actually happened rather than pass
vacuously. ``ENABLED`` is a module bool: with the flag unset every
instrumented site costs one attribute load.
"""

import os
import random
import signal
import threading
import time

from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability.metrics_registry import REGISTRY

__all__ = [
    "ENABLED", "ChaosIOError", "ChaosTransientError", "ChaosOOMError",
    "configure", "disable", "fault", "clauses", "fires",
]

ENABLED = False


class ChaosIOError(IOError):
    """Injected IO failure (classified transient by resilience.retry)."""


class ChaosTransientError(RuntimeError):
    """Injected transient runtime failure (compile/dispatch/RPC)."""


class ChaosOOMError(RuntimeError):
    """Injected RESOURCE_EXHAUSTED: deterministic, classified
    never-transient (observability/memory.py M001 path)."""


_KINDS = ("kill", "io", "compile", "slow", "oom")
_HOME_SITE = {"kill": "session.step", "compile": "exec.compile"}

_lock = lock_witness.make_lock("resilience.chaos")
_clauses = []  # [{"kind", "site", "step", "p", "n", "secs", "rng", "fired"}]

_faults_total = REGISTRY.counter(
    "paddle_tpu_chaos_faults_total", "injected chaos faults by site",
    ["site", "kind"])


def _parse_clause(text, index, seed):
    kind, _, params = text.partition("@")
    kind = kind.strip()
    if kind not in _KINDS:
        raise ValueError(
            "chaos_spec: unknown fault kind %r (valid: %s)"
            % (kind, ", ".join(_KINDS)))
    c = {"kind": kind, "site": _HOME_SITE.get(kind), "step": None,
         "p": None, "n": 1 if kind == "kill" else None, "secs": 0.1,
         "skip": 0, "visits": 0,
         # int-mixed per-clause stream: deterministic across processes
         # (unlike tuple seeding, which hashes) and independent per clause
         "rng": random.Random(seed * 1000003 + index), "fired": 0}
    for param in filter(None, (p.strip() for p in params.split(","))):
        k, _, v = param.partition("=")
        k = k.strip()
        if k == "site":
            c["site"] = v.strip()
        elif k == "step":
            c["step"] = int(v)
        elif k == "p":
            c["p"] = float(v)
        elif k == "n":
            c["n"] = int(v)
        elif k == "skip":
            c["skip"] = int(v)
        elif k == "secs":
            c["secs"] = float(v)
        else:
            raise ValueError("chaos_spec: unknown param %r in %r"
                             % (k, text))
    if c["site"] is None:
        raise ValueError(
            "chaos_spec: %r needs an explicit site= (only %s have a "
            "default site)" % (text, sorted(_HOME_SITE)))
    if c["step"] is None and c["p"] is None:
        c["p"] = 1.0  # bare "io@site=x" fires every visit (up to n)
    return c


def configure(spec=None):
    """Parse and arm ``spec`` (default: ``FLAGS_chaos_spec``). An empty
    spec disarms. Returns the parsed clause list (tests)."""
    global ENABLED
    if spec is None:
        from paddle_tpu_torch import flags

        spec = flags.get("chaos_spec")
    with _lock:
        _clauses[:] = []
        if not spec:
            ENABLED = False
            return []
        parts = [p.strip() for p in str(spec).split(";") if p.strip()]
        seed = 0
        for p in parts:
            if p.startswith("seed="):
                seed = int(p[len("seed="):])
        for i, p in enumerate(parts):
            if p.startswith("seed="):
                continue
            _clauses.append(_parse_clause(p, i, seed))
        ENABLED = bool(_clauses)
        return [dict(c, rng=None) for c in _clauses]


def disable():
    configure("")


def clauses():
    """Parsed clauses with live fire counts (introspection/tests)."""
    with _lock:
        return [dict(c, rng=None) for c in _clauses]


def fires(site=None):
    """Total faults fired (optionally for one site)."""
    with _lock:
        return sum(c["fired"] for c in _clauses
                   if site is None or c["site"] == site)


def _record(site, kind):
    _faults_total.inc(site=site, kind=kind)
    from paddle_tpu_torch.observability import blackbox

    if blackbox.ENABLED:
        blackbox.record("chaos_fault", site=site, fault=kind)


def fault(site, step=None):
    """The kill-point: every instrumented site calls this (guarded on
    ``ENABLED``). Raises/kills/sleeps according to armed clauses; a
    no-match visit costs one lock + list scan, paid only while chaos is
    configured."""
    fire = None
    # Timed acquire [C003]: the ckpt.write site sits inside the SIGTERM
    # handler chain chaos runs deliberately exercise, and the signal may
    # have interrupted this very thread mid-scan. Uncontended (the only
    # deterministic case the schedules rely on) the acquire is
    # immediate; on timeout the visit is skipped rather than deadlock.
    if not _lock.acquire(timeout=5.0):
        return
    try:
        for c in _clauses:
            if c["site"] != site:
                continue
            if c["n"] is not None and c["fired"] >= c["n"]:
                continue
            c["visits"] += 1
            if c["visits"] <= c["skip"]:
                continue
            if c["step"] is not None:
                if step is None or int(step) != c["step"]:
                    continue
            elif c["p"] is not None and c["rng"].random() >= c["p"]:
                continue
            c["fired"] += 1
            fire = (c["kind"], c["secs"])
            break
    finally:
        _lock.release()
    if fire is None:
        return
    kind, secs = fire
    _record(site, kind)
    if kind == "kill":
        # SIGKILL, not SystemExit: the preemption being simulated gives
        # no cleanup opportunity — that is the entire point
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "io":
        raise ChaosIOError("chaos: injected IO failure at %s" % site)
    elif kind == "compile":
        raise ChaosTransientError(
            "chaos: injected transient failure at %s" % site)
    elif kind == "oom":
        # the JAX package's allocator status wording, so every layer that keys
        # on RESOURCE_EXHAUSTED (retry veto, M001 enrichment) treats the
        # injected fault exactly like the real one
        raise ChaosOOMError(
            "RESOURCE_EXHAUSTED: chaos: injected out-of-memory at %s"
            % site)
    elif kind == "slow":
        time.sleep(secs)


def _init_from_flags():
    try:
        configure()
    except Exception:
        # a malformed spec must not mask the import; surface it loudly
        # but once, then stay disabled
        import logging

        logging.getLogger("paddle_tpu_torch.resilience.chaos").exception(
            "FLAGS_chaos_spec is malformed; chaos disabled")


_init_from_flags()
