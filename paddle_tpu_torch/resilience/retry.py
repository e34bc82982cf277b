"""Classified retry policy: transient failures backed off and retried,
user errors surfaced at once, every retry counted.

Counterpart of ``paddle_tpu/resilience/retry.py`` (a copy). Transient:
an RPC reset, a connection severed across a frontend restart, an
injected chaos fault, a ``DegradedError`` (retriable by type).
Permanent: a verifier diagnostic, a shape mismatch, a NaN trip, an
out-of-memory (``observability.memory.is_oom``, which counts
``torch.cuda.OutOfMemoryError`` too): retrying replays the same
deterministic failure.

Policy: up to ``FLAGS_dispatch_retries`` retries, exponential backoff
(``FLAGS_retry_backoff_s`` * 2^attempt) with up to 50% jitter. Every
retry increments ``paddle_tpu_retries_total{origin}`` and, when the
black box is armed, files a ``retry`` event.

Donation: the JAX package's dispatch donates its state buffers and
refuses to retry once a donated leaf was consumed (``donated=``). The
port donates nothing (state is updated in place or replaced by new
tensors the scope holds), so ``donated`` is accepted and never vetoes.
"""

import random
import time

from paddle_tpu_torch.observability.metrics_registry import REGISTRY

__all__ = [
    "TransientError", "is_transient", "call", "retries_enabled",
]

# substrings of RPC-ish status messages worth retrying when they arrive
# wrapped in a backend RuntimeError instead of a typed OSError.
# RESOURCE_EXHAUSTED is deliberately NOT here: an allocator OOM is
# deterministic for a given program and batch — retrying replays the
# same death N times, burning the budget AND the accelerator-hours
# (observability/memory.py classifies it, rule M001).
_TRANSIENT_MARKERS = (
    "UNAVAILABLE", "DEADLINE_EXCEEDED",
    "connection reset", "temporarily unavailable",
)

_retries_total = REGISTRY.counter(
    "paddle_tpu_retries_total", "transient-failure retries by origin",
    ["origin"])
_exhausted_total = REGISTRY.counter(
    "paddle_tpu_retries_exhausted_total",
    "operations that failed even after the full retry budget", ["origin"])


class TransientError(RuntimeError):
    """Raise (or wrap with) this to mark a failure explicitly retryable
    regardless of its concrete type."""


# OSErrors that are deterministic configuration/programming failures, not
# infrastructure flake: retrying replays them verbatim
_PERMANENT_OS_ERRORS = (FileNotFoundError, PermissionError,
                        IsADirectoryError, NotADirectoryError)


def is_transient(exc):
    """The classification table (docs/RESILIENCE.md):

    retry     ChaosIOError/ChaosTransientError (injected), TransientError,
              ConnectionError/EOFError/TimeoutError, OSError/IOError
              (except the deterministic kinds: missing path, permission,
              not-a-directory), RuntimeErrors carrying RPC status markers
              (UNAVAILABLE...)
    never     ProgramVerifyError, NaN/Inf trips (deterministic replays),
              RESOURCE_EXHAUSTED/OOM (deterministic allocator deaths —
              rule M001, observability/memory.py),
              ValueError/TypeError/KeyError/AssertionError (user errors —
              including ``distributed.master.AuthError``: a credential
              rejection replays verbatim until the token changes),
              FileNotFoundError/PermissionError and kin, everything else
    """
    from paddle_tpu_torch.observability.memory import is_oom
    from paddle_tpu_torch.resilience.chaos import (
        ChaosIOError, ChaosTransientError)

    if isinstance(exc, (TransientError, ChaosIOError,
                        ChaosTransientError)):
        return True
    if is_oom(exc):
        # checked BEFORE the marker scan: the same program at the same
        # batch OOMs the same way every attempt — a retry budget spent
        # here masks the real fix (donate, shrink, shard)
        return False
    if isinstance(exc, (ValueError, TypeError, KeyError, AssertionError)):
        return False
    try:
        from paddle_tpu_torch.analysis import ProgramVerifyError

        if isinstance(exc, ProgramVerifyError):
            return False
    except Exception:
        pass
    msg = str(exc)
    if "NaN/Inf" in msg:  # a FLAGS_check_nan_inf trip: deterministic
        return False
    if isinstance(exc, _PERMANENT_OS_ERRORS):
        return False
    if isinstance(exc, (ConnectionError, EOFError, TimeoutError, OSError)):
        return True
    if isinstance(exc, RuntimeError):
        return any(m in msg for m in _TRANSIENT_MARKERS)
    return False


def retries_enabled():
    from paddle_tpu_torch import flags

    try:
        return int(flags.get("dispatch_retries")) > 0
    except (KeyError, TypeError, ValueError):
        return False


def _backoff_s(attempt):
    from paddle_tpu_torch import flags

    try:
        base = float(flags.get("retry_backoff_s"))
    except (KeyError, TypeError, ValueError):
        base = 0.05
    if base <= 0:
        return 0.0
    return base * (2 ** attempt) * (1.0 + 0.5 * random.random())


def _donation_consumed(donated):
    """Whether a failed dispatch consumed a donated buffer. The port's
    dispatch donates nothing, so nothing is ever consumed: the JAX
    package's veto (a deleted jax array among ``donated``'s leaves)
    has no counterpart here."""
    return False


def call(fn, origin="work", donated=None, retries=None, classify=None):
    """Run ``fn()`` under the retry policy. ``retries=None`` reads
    ``FLAGS_dispatch_retries`` (0 = call straight through — the default
    hot path adds one flag read and nothing else). ``classify``
    overrides :func:`is_transient`. ``donated`` is accepted for the JAX
    package's signature and never vetoes (module docstring)."""
    if retries is None:
        from paddle_tpu_torch import flags

        try:
            retries = int(flags.get("dispatch_retries"))
        except (KeyError, TypeError, ValueError):
            retries = 0
    if retries <= 0:
        return fn()
    classify = classify or is_transient
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 - reclassified below
            if (attempt >= retries or not classify(exc)
                    or _donation_consumed(donated)):
                if attempt > 0:
                    _exhausted_total.inc(origin=origin)
                raise
            delay = _backoff_s(attempt)
            attempt += 1
            _retries_total.inc(origin=origin)
            from paddle_tpu_torch.observability import blackbox

            if blackbox.ENABLED:
                blackbox.record(
                    "retry", origin=origin, attempt=attempt,
                    backoff_s=round(delay, 4),
                    exc_type=type(exc).__name__,
                    exc_message=str(exc)[:500])
            if delay > 0:
                time.sleep(delay)
