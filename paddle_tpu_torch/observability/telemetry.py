"""Step telemetry: the step-time window the executors feed.

Counterpart of the step-time half of ``paddle_tpu/observability/
telemetry.py``. ``Executor.run`` / ``run_async`` / ``run_multi_step``
call :func:`record_step` with each dispatch's wall time; each record
lands in a bounded ring (``step_stats`` percentiles, the black box's
step tail) and in the metrics registry
(``paddle_tpu_steps_total``, ``paddle_tpu_step_seconds``). The
watchdog's automatic timeout reads ``step_stats()['p95_ms']``.

Not ported yet (ROADMAP.md A9): the device-memory gauges, FLOP
registration and MFU, the per-device series and the JSONL flush. Those
entry points raise ``NotImplementedError`` naming A9.

Overhead contract: the executors guard on the module bool ``ENABLED``
(``FLAGS_telemetry`` at import, :func:`enable` at run time); off, a run
pays one attribute read.
"""

import collections
import math
import time

from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability.metrics_registry import REGISTRY

__all__ = [
    "ENABLED", "enable", "reset", "record_step", "step_stats",
    "record_fetch_materialize",
    "register_flops", "estimate_flops", "device_memory_bytes",
    "peak_flops", "flush",
]

ENABLED = False

_RING_CAP = 4096

_lock = lock_witness.make_lock("observability.telemetry")
_records = collections.deque(maxlen=_RING_CAP)

# step-time buckets: 100us .. 100s (training steps span ms..minutes)
_STEP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                 50.0, 100.0)
# async-fetch materialize: dominated by the device wait + copy to host
_FETCH_BUCKETS = (0.00001, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                  0.5, 1.0, 5.0, 10.0)

_steps_total = REGISTRY.counter(
    "paddle_tpu_steps_total", "program steps executed", labels=("executor",))
_step_seconds = REGISTRY.histogram(
    "paddle_tpu_step_seconds", "per-step wall time (seconds)",
    labels=("executor",), buckets=_STEP_BUCKETS)
_feed_bytes = REGISTRY.counter(
    "paddle_tpu_feed_bytes_total", "bytes fed host->device")
_fetch_materialize = REGISTRY.histogram(
    "paddle_tpu_fetch_materialize_seconds",
    "async-fetch dispatch-to-numpy latency", buckets=_FETCH_BUCKETS)

_NOT_PORTED = ("telemetry's %s is not ported yet (ROADMAP.md A9: device "
               "memory, FLOP accounting and MFU)")


def enable(on=True):
    """Flip telemetry at run time; the flag only sets the import-time
    default."""
    global ENABLED
    ENABLED = bool(on)
    return ENABLED


def _init_from_flags():
    from paddle_tpu_torch import flags

    enable(flags.get("telemetry"))


def reset():
    """Drop the ring buffer (phase-scoped measurement)."""
    with _lock:
        _records.clear()


def record_step(executor, wall_s, steps=1, feed_bytes=0,
                dispatch_only=False):
    """One executed dispatch: ``steps`` program steps in ``wall_s``
    seconds (``run_multi_step`` dispatches K at once). ``dispatch_only``
    marks async dispatches whose wall time is host latency, not step
    duration: they count in ``steps_total`` but stay out of the
    ``step_stats`` percentiles. Callers guard on ``ENABLED``."""
    steps = max(1, int(steps))
    per_step = wall_s / steps
    rec = {
        "ts": time.time(),
        "executor": executor,
        "wall_s": wall_s,
        "steps": steps,
        "step_s": per_step,
        "feed_bytes": int(feed_bytes),
        "dispatch_only": bool(dispatch_only),
    }
    with _lock:
        _records.append(rec)
    _steps_total.inc(steps, executor=executor)
    if not dispatch_only:
        _step_seconds.observe(per_step, executor=executor)
    if feed_bytes:
        _feed_bytes.inc(int(feed_bytes))
    return rec


def record_fetch_materialize(seconds):
    """``FetchHandle.result()`` latency: dispatch -> numpy in hand."""
    _fetch_materialize.observe(seconds)


def _percentile(sorted_vals, q):
    """Nearest-rank percentile: the smallest value with at least q% of
    the sample at or below it."""
    if not sorted_vals:
        return None
    k = max(0, min(len(sorted_vals) - 1,
                   int(math.ceil(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[k]


def step_stats():
    """Percentiles over the recorded window: ``{"count", "p50_ms",
    "p95_ms", "p99_ms", "mean_ms", "total_s"}`` (the JAX package's keys
    without its FLOP and MFU entries)."""
    with _lock:
        recs = list(_records)
    per_step = sorted(r["step_s"] for r in recs if not r["dispatch_only"])
    out = {
        "count": sum(r["steps"] for r in recs),
        "p50_ms": None, "p95_ms": None, "p99_ms": None, "mean_ms": None,
        "total_s": sum(r["wall_s"] for r in recs),
    }
    if per_step:
        out["p50_ms"] = _percentile(per_step, 50) * 1e3
        out["p95_ms"] = _percentile(per_step, 95) * 1e3
        out["p99_ms"] = _percentile(per_step, 99) * 1e3
        out["mean_ms"] = sum(per_step) / len(per_step) * 1e3
    return out


def register_flops(*_args, **_kwargs):
    raise NotImplementedError(_NOT_PORTED % "register_flops")


def estimate_flops(*_args, **_kwargs):
    raise NotImplementedError(_NOT_PORTED % "estimate_flops")


def device_memory_bytes(*_args, **_kwargs):
    raise NotImplementedError(_NOT_PORTED % "device_memory_bytes")


def peak_flops(*_args, **_kwargs):
    raise NotImplementedError(_NOT_PORTED % "peak_flops")


def flush(*_args, **_kwargs):
    raise NotImplementedError(_NOT_PORTED % "flush")


_init_from_flags()
