"""BatchingServer: shape-bucketed continuous batching over Predictor.

Counterpart of ``paddle_tpu/serving/server.py`` (a copy over the port's
``Predictor``, ``FetchHandle`` and flags). Requests are coalesced into
batches and padded UP a small ladder of bucketed batch sizes (and, with
``pad_buckets``, non-batch dims), so the set of live shapes stays
finite; padding is sliced off before delivery. ``run_reference`` is the
oracle: the same request alone, padded to its own rung. A request's rows
equal the oracle's wherever the backend's row computations do not depend
on the batch they ride in; the CPU's matrix products may round the last
bit differently at another batch size (the JAX package's XLA CPU GEMM
does the same, 1.49e-8 absolute), so the tests hold a coalesced request
to the oracle within 1e-6 relative, and exactly where its rung equals
its size.

Contract points:

* **Admission control.** ``submit`` rejects with ``QueueFullError``
  when the queue is at ``max_queue_depth``, and with
  ``ServerClosedError`` after ``close()``. A queued request whose
  deadline lapses is completed with ``DeadlineExceededError``; a
  dispatched batch that outlives the latest deadline in it is abandoned
  via ``FetchHandle.result(timeout=...)`` (the handle stays valid; the
  REQUESTS are rejected, the device work is not torn down).
* **Multi-tenant execution.** Each worker thread serves through its own
  ``Predictor.clone()`` (its own ``Executor``, the shared weights).
* **Observability.** Per-request latency (by outcome), queue depth,
  batch occupancy and reject counters land in
  ``observability.REGISTRY``; ``latency_percentiles()`` gives exact
  p50/p99 over a recent window.
"""

import threading
import time
from collections import deque

import numpy as np

from paddle_tpu_torch.analysis.lint import suggest_buckets
from paddle_tpu_torch.executor import FetchTimeoutError
from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.observability import watchdog as _watchdog
from paddle_tpu_torch.observability.metrics_registry import (
    DECODE_BUCKETS,
    REGISTRY as _REGISTRY,
    SERVING_BUCKETS,
)
from paddle_tpu_torch.resilience import chaos as _chaos
from paddle_tpu_torch.resilience import retry as _retry

__all__ = [
    "BatchingServer", "ServingFuture", "ServingError", "QueueFullError",
    "DeadlineExceededError", "ServerClosedError", "WaitTimeoutError",
]


class ServingError(RuntimeError):
    """Base of the typed serving failures."""


class QueueFullError(ServingError):
    """Admission reject: the request queue is at max_queue_depth."""


class DeadlineExceededError(ServingError):
    """The request's deadline lapsed (queued or in flight)."""


class ServerClosedError(ServingError):
    """submit() after close(), or queued work abandoned by
    close(drain=False)."""


class WaitTimeoutError(ServingError):
    """``ServingFuture.result(timeout=...)`` expired before the request
    completed. The request itself is STILL in flight (or queued) — this
    is the caller's wait giving up, not the server rejecting anything;
    ask the future again later."""


_queue_depth = _REGISTRY.gauge(
    "paddle_tpu_serving_queue_depth",
    "requests waiting in the batching server's admission queue")
_requests_total = _REGISTRY.counter(
    "paddle_tpu_serving_requests_total",
    "batching-server requests by outcome",
    labels=("outcome",))  # ok | queue_full | deadline | error | closed |
#                           degraded (typed retriable shed reject)
_request_seconds = _REGISTRY.histogram(
    "paddle_tpu_serving_request_seconds",
    "submit->completion latency (the caller-visible SLO); "
    "decode-resolution ladder — sub-millisecond buckets below the "
    "coarse SERVING_BUCKETS band, trace-id exemplars per bucket",
    labels=("outcome",), buckets=DECODE_BUCKETS)
_batch_occupancy = _REGISTRY.histogram(
    "paddle_tpu_serving_batch_occupancy",
    "real rows / bucket rows per dispatched batch (1.0 = no padding)",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_batches_total = _REGISTRY.counter(
    "paddle_tpu_serving_batches_total",
    "batches dispatched, by bucket (padded batch rows)",
    labels=("bucket",))


class ServingFuture(object):
    """Result slot for one submitted request."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """The request's fetch list (numpy, in Predictor fetch order).
        Raises the typed serving error (or the execution error) the
        request failed with; ``WaitTimeoutError`` if ``timeout`` expires
        first (the request stays in flight — ask again)."""
        if not self._event.wait(timeout):
            raise WaitTimeoutError(
                "request not completed within %.3fs" % float(timeout))
        if self._exc is not None:
            raise self._exc
        return self._value

    def _finish(self, value=None, exc=None):
        self._value, self._exc = value, exc
        self._event.set()


class _Request(object):
    __slots__ = ("inputs", "rows", "future", "t_submit", "deadline",
                 "group", "trace_id", "t_queue")

    def __init__(self, inputs, rows, deadline, group, trace_id=None):
        self.inputs = inputs
        self.rows = rows
        self.future = ServingFuture()
        self.t_submit = time.monotonic()
        self.deadline = deadline
        self.group = group
        self.trace_id = trace_id      # request trace, or None
        # wall-clock twin of t_submit: trace spans are wall-time
        self.t_queue = time.time() if trace_id else 0.0


def _round_up(value, ladder):
    for rung in ladder:
        if value <= rung:
            return rung
    return None


def _misaligned_fetches(outs, rows):
    """(index, shape) of the first fetch whose leading dim isn't the
    batch row count — such outputs cannot be sliced per request."""
    for i, o in enumerate(outs):
        if o.ndim == 0 or o.shape[0] != rows:
            return (i, tuple(o.shape))
    return None


class BatchingServer(object):
    """Continuous-batching front end over a loaded ``Predictor``.

    Parameters
    ----------
    predictor : inference.Predictor
        The loaded model; the server clones it per worker.
    max_batch : int
        Row capacity of one dispatched batch; also the top of the
        default batch ladder.
    batch_buckets : sequence of int, optional
        Explicit batch-row ladder (ascending). Default: power-of-two
        rungs from 2 up to ``max_batch``
        (``analysis.lint.suggest_buckets``). Rung 1 is deliberately
        absent: backends lower single-row matmuls to gemv kernels whose
        accumulation order differs from the batched gemm path, so
        padding 1-row requests to 2 keeps every dispatch on the gemm
        path. Explicit ladders get the same floor
        (a rung 1 is dropped unless it's the only rung). Production
        fit: pass ``suggest_buckets(observed_batch_sizes)``.
    pad_buckets : dict, optional
        ``{feed_name: per-dim ladders}`` as ``suggest_buckets`` emits
        for shape tuples: non-batch dims of those feeds are padded up
        their rung with ``pad_value``. Requires a model that MASKS
        padded positions (length feeds); batch-row padding alone needs
        no model cooperation.
    pad_value : float/int
        Fill for pad_buckets padding (batch-row padding repeats the
        last real row instead — no degenerate values, no NaN bait).
    max_queue_depth : int
        Admission bound; beyond it ``submit`` raises QueueFullError.
    batch_linger_s : float
        How long the dispatcher holds a young, not-yet-full batch open
        for more arrivals before dispatching what it has.
    default_deadline_s : float, optional
        Deadline applied when ``submit`` gets none; None = no deadline.
    workers : int
        Dispatch threads (one Predictor clone each).
    """

    def __init__(self, predictor, max_batch=8, batch_buckets=None,
                 pad_buckets=None, pad_value=0, max_queue_depth=64,
                 batch_linger_s=0.002, default_deadline_s=None,
                 workers=1, degradation=None):
        if max_batch < 1 or workers < 1 or max_queue_depth < 1:
            raise ValueError("max_batch, workers and max_queue_depth "
                             "must be >= 1")
        # graceful degradation (serving/degradation.py), opt-in: a dict
        # of HealthMonitor thresholds arms the healthy->brownout->shed
        # machine over queue-depth fraction — shed answers submit()
        # with a typed retriable DegradedError (retry-after hint)
        # INSTEAD of letting callers ride the queue to the QueueFull
        # cliff; None keeps admission control to the queue bound alone
        if degradation is not None:
            from paddle_tpu_torch.serving.degradation import HealthMonitor

            self._monitor = HealthMonitor(
                "server", **(dict(degradation)
                             if isinstance(degradation, dict) else {}))
        else:
            self._monitor = None
        self._predictor = predictor
        self._feed_names = list(predictor.feed_names)
        self._feed_shapes = dict(predictor.feed_shapes)
        ladder = tuple(batch_buckets) if batch_buckets else \
            suggest_buckets(range(min(2, int(max_batch)),
                                  int(max_batch) + 1))
        if list(ladder) != sorted(ladder):
            raise ValueError("batch_buckets must be ascending: %r"
                             % (ladder,))
        # enforce the rung-2 floor on EXPLICIT ladders too (unless the
        # whole server is single-row): a rung-1 executable would break
        # the bit-exactness contract the moment a 1-row request
        # coalesces — see the batch_buckets note above
        ladder = tuple(r for r in ladder if r >= 2) or ladder[-1:]
        if batch_buckets and ladder[-1] > int(max_batch):
            # an explicit ladder above max_batch is a contradictory
            # config — fail loud instead of silently clamping away
            # rungs the caller provisioned for
            raise ValueError(
                "batch_buckets top rung %d exceeds max_batch %d; raise "
                "max_batch or trim the ladder" % (ladder[-1],
                                                  int(max_batch)))
        # ... and the max_batch CEILING on DERIVED ladders: max_batch=5
        # must not quietly become capacity-8 because the power-of-two
        # ladder overshot (the top rung is clamped, not dropped, so
        # 5-row requests still have a home)
        self._ladder = tuple(sorted({min(r, int(max_batch))
                                     for r in ladder}))
        self._max_batch = int(self._ladder[-1])
        self._pad_buckets = dict(pad_buckets or {})
        self._pad_value = pad_value
        self._max_queue_depth = int(max_queue_depth)
        self._linger = float(batch_linger_s)
        self._default_deadline = default_deadline_s
        self._queue = deque()
        self._cond = lock_witness.make_condition("serving.server.cond")
        self._closed = False
        self._drain = True
        self._latencies = deque(maxlen=4096)  # seconds, completed only
        # guards _counts (+ _latencies appends): _finish runs both under
        # _cond (expire/close paths) and outside it (dispatch workers),
        # so the counters need their own lock — always acquired LAST,
        # never while calling back into queue machinery
        self._stats_lock = lock_witness.make_lock("serving.server.stats")
        self._counts = {"submitted": 0, "ok": 0, "queue_full": 0,
                        "deadline": 0, "error": 0, "closed": 0,
                        "degraded": 0, "batches": 0, "padded_rows": 0,
                        "real_rows": 0}
        self._workers = [
            threading.Thread(
                target=self._worker, name="paddle-tpu-serve-%d" % i,
                args=(predictor.clone() if i else predictor,),
                daemon=True)
            for i in range(int(workers))
        ]
        for t in self._workers:
            t.start()

    # -- admission -----------------------------------------------------------
    def _normalize(self, inputs):
        if not isinstance(inputs, dict):
            if len(inputs) != len(self._feed_names):
                raise ServingError(
                    "expected %d inputs (%s), got %d"
                    % (len(self._feed_names), self._feed_names,
                       len(inputs)))
            inputs = dict(zip(self._feed_names, inputs))
        missing = set(self._feed_names) - set(inputs)
        extra = set(inputs) - set(self._feed_names)
        if missing or extra:
            raise ServingError(
                "feed mismatch: missing %s, unknown %s"
                % (sorted(missing), sorted(extra)))
        feeds = {}
        rows = None
        for name in self._feed_names:
            arr = np.asarray(inputs[name])
            declared = self._feed_shapes.get(name)
            if declared is not None and arr.ndim != len(declared):
                raise ServingError(
                    "feed %r: rank %d, declared %s"
                    % (name, arr.ndim, list(declared)))
            if rows is None:
                rows = arr.shape[0] if arr.ndim else 1
            elif arr.ndim and arr.shape[0] != rows:
                raise ServingError(
                    "feed %r has %d rows; request carries %d"
                    % (name, arr.shape[0], rows))
            if declared is not None:
                for axis, want in enumerate(declared):
                    if axis == 0 or want is None or want < 0:
                        continue
                    if arr.shape[axis] != want:
                        raise ServingError(
                            "feed %r dim %d is %d, declared %d"
                            % (name, axis, arr.shape[axis], want))
            feeds[name] = arr
        if rows is None or rows < 1:
            raise ServingError("empty request")
        if rows > self._max_batch:
            raise ServingError(
                "request carries %d rows > max_batch %d; split it"
                % (rows, self._max_batch))
        return feeds, rows

    def _pad_request(self, feeds):
        """pad_buckets padding of non-batch dims, before grouping: the
        padded shape IS the group signature, so two requests landing on
        the same rungs share a batch (and an executable)."""
        for name, ladders in self._pad_buckets.items():
            arr = feeds.get(name)
            if arr is None:
                continue
            pads = []
            for axis in range(arr.ndim):
                if axis == 0 or axis >= len(ladders):
                    pads.append((0, 0))
                    continue
                rung = _round_up(arr.shape[axis], ladders[axis])
                if rung is None:
                    raise ServingError(
                        "feed %r dim %d size %d exceeds its bucket "
                        "ladder top %d" % (name, axis, arr.shape[axis],
                                           ladders[axis][-1]))
                pads.append((0, rung - arr.shape[axis]))
            if any(p != (0, 0) for p in pads):
                feeds[name] = np.pad(arr, pads, mode="constant",
                                     constant_values=self._pad_value)
        return feeds

    def submit(self, inputs, deadline_s=None, trace_id=None):
        """Queue one request (dict feed-name -> array, or list in feed
        order; leading dim = rows, up to ``max_batch``). Returns a
        :class:`ServingFuture`. Raises ``QueueFullError`` /
        ``ServerClosedError`` at admission; the future raises
        ``DeadlineExceededError`` when the deadline lapses.
        ``trace_id`` binds the request to an in-flight request trace
        (observability/tracing.py): the batch worker emits queue-wait
        and dispatch spans into it, and the completion latency
        histogram carries it as an exemplar."""
        feeds, rows = self._normalize(inputs)
        feeds = self._pad_request(feeds)
        group = tuple(
            (name, feeds[name].shape[1:], str(feeds[name].dtype))
            for name in self._feed_names)
        if deadline_s is None:
            deadline_s = self._default_deadline
        deadline = (time.monotonic() + float(deadline_s)
                    if deadline_s is not None else None)
        req = _Request(feeds, rows, deadline, group,
                       trace_id=trace_id)
        with self._cond:
            if self._closed:
                with self._stats_lock:
                    self._counts["closed"] += 1
                _requests_total.inc(outcome="closed")
                raise ServerClosedError("server is closed")
            if self._monitor is not None:
                from paddle_tpu_torch.serving.degradation import SHED

                state = self._monitor.observe(
                    len(self._queue) / float(self._max_queue_depth))
                if state == SHED:
                    # shed: refuse BEFORE the queue mutates — the
                    # in-flight/queued work drains, the caller gets a
                    # typed retriable answer with a retry-after hint
                    # sized to the drain (a full queue at the linger
                    # cadence), never a wedged future
                    with self._stats_lock:
                        self._counts["degraded"] = \
                            self._counts.get("degraded", 0) + 1
                    _requests_total.inc(outcome="degraded")
                    raise self._monitor.reject(
                        "admission (queue at %d/%d, draining)"
                        % (len(self._queue), self._max_queue_depth))
            if len(self._queue) >= self._max_queue_depth:
                with self._stats_lock:
                    self._counts["queue_full"] += 1
                _requests_total.inc(outcome="queue_full")
                raise QueueFullError(
                    "queue depth %d at max_queue_depth %d"
                    % (len(self._queue), self._max_queue_depth))
            with self._stats_lock:
                self._counts["submitted"] += 1
            self._queue.append(req)
            _queue_depth.set(len(self._queue))
            self._cond.notify_all()
        return req.future

    def run(self, inputs, deadline_s=None):
        """Synchronous convenience: ``submit(...).result()``."""
        return self.submit(inputs, deadline_s=deadline_s).result()

    def run_reference(self, inputs):
        """The parity oracle: this request ALONE — same pad-to-rung
        policy, no coalescing — through ``Predictor.run`` on the
        caller's thread (module docstring: how close the batched path's
        rows come to it); for a request whose rows sit exactly on a
        rung it degenerates to plain ``Predictor.run`` of the raw
        request."""
        feeds, rows = self._normalize(inputs)
        feeds = self._pad_request(feeds)
        bucket = _round_up(rows, self._ladder) or self._max_batch
        if bucket > rows:
            feeds = {
                n: np.concatenate(
                    [a, np.repeat(a[-1:], bucket - rows, axis=0)])
                for n, a in feeds.items()}
        outs = [np.asarray(o) for o in self._predictor.run(feeds)]
        bad = _misaligned_fetches(outs, bucket)
        if bad is not None:
            raise ServingError(
                "fetch output %d has shape %r: leading dim != batch "
                "rows %d — batch-reduced fetches cannot be served "
                "through the batching path" % (bad + (bucket,)))
        return [o[:rows] for o in outs]

    # -- dispatch ------------------------------------------------------------
    def _finish(self, req, value=None, exc=None, outcome="ok"):
        req.future._finish(value, exc)
        latency = time.monotonic() - req.t_submit
        with self._stats_lock:
            self._counts[outcome] = self._counts.get(outcome, 0) + 1
            if outcome == "ok":
                self._latencies.append(latency)
        _requests_total.inc(outcome=outcome)
        _request_seconds.observe(latency, exemplar=req.trace_id,
                                 outcome=outcome)

    def _expire_locked(self, now):
        kept = deque()
        for req in self._queue:
            if req.deadline is not None and now > req.deadline:
                self._finish(req, exc=DeadlineExceededError(
                    "deadline lapsed after %.3fs in queue"
                    % (now - req.t_submit)), outcome="deadline")
            else:
                kept.append(req)
        self._queue = kept
        _queue_depth.set(len(self._queue))

    def _take_batch_locked(self, group):
        batch, total, kept = [], 0, deque()
        for req in self._queue:
            if req.group == group and total + req.rows <= self._max_batch:
                batch.append(req)
                total += req.rows
            else:
                kept.append(req)
        self._queue = kept
        _queue_depth.set(len(self._queue))
        return batch, total

    def _worker(self, predictor):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:
                    return  # closed and drained
                now = time.monotonic()
                self._expire_locked(now)
                if not self._queue:
                    if self._closed and self._drain is False:
                        return
                    continue
                # first group (in arrival order) that is dispatchable:
                # full, past its linger window, or the server is
                # closing. Scanning ALL groups — not just the head's —
                # keeps a young head request from head-of-line-blocking
                # another group's already-full batch.
                rows_by_group, oldest, urgent = {}, {}, {}
                for r in self._queue:
                    rows_by_group[r.group] = (
                        rows_by_group.get(r.group, 0) + r.rows)
                    oldest.setdefault(r.group, r.t_submit)
                    if r.deadline is not None:
                        urgent[r.group] = min(
                            urgent.get(r.group, r.deadline), r.deadline)
                ready = None
                for r in self._queue:
                    g = r.group
                    linger_end = oldest[g] + self._linger
                    if (self._closed
                            or rows_by_group[g] >= self._max_batch
                            or now >= linger_end
                            # a member's deadline lands inside the
                            # linger window: dispatch NOW — holding the
                            # batch open would turn a servable request
                            # into a guaranteed deadline reject
                            or urgent.get(g, linger_end + 1) <= linger_end):
                        ready = g
                        break
                if ready is None:
                    # every group is young and unfilled: linger for
                    # coalescing — the continuous-batching tradeoff
                    # knob. Wake early for the nearest queued deadline
                    # so a lapsed request is rejected promptly.
                    wake = min(
                        [t + self._linger for t in oldest.values()]
                        + [r.deadline for r in self._queue
                           if r.deadline is not None])
                    if wake > now:
                        self._cond.wait(wake - now)
                    continue
                if self._closed and not self._drain:
                    while self._queue:
                        self._finish(self._queue.popleft(),
                                     exc=ServerClosedError(
                                         "server closed before dispatch"),
                                     outcome="closed")
                    _queue_depth.set(0)
                    return
                batch, total = self._take_batch_locked(ready)
                if self._monitor is not None:
                    # the drain side of the state machine: dispatching
                    # a batch is what shrinks the queue, so recovery
                    # (shed -> brownout -> healthy, one level per
                    # crossing) is observed here
                    self._monitor.observe(
                        len(self._queue) / float(self._max_queue_depth))
            if batch:
                self._execute(predictor, batch, total)

    def _trace_spans(self, batch, t_dispatch, t_done):
        """Queue-wait + dispatch spans for every traced request of one
        dispatched batch (they share the dispatch window — the batch is
        the unit of execution)."""
        for req in batch:
            if not req.trace_id:
                continue
            tr = _tracing.inflight_get(req.trace_id)
            if tr is None:
                continue
            tr.span("queue", req.t_queue, t_dispatch,
                    rows=int(req.rows))
            tr.span("dispatch", t_dispatch, t_done,
                    rows=int(req.rows))

    def _execute(self, predictor, batch, total):
        traced = any(r.trace_id for r in batch)
        t_dispatch = time.time() if traced else 0.0
        bucket = _round_up(total, self._ladder) or self._max_batch
        feeds = {}
        for name in self._feed_names:
            parts = [r.inputs[name] for r in batch]
            arr = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if bucket > total:
                # pad rows by repeating the last real row: sliced away
                # below, and (unlike zeros) incapable of manufacturing
                # NaNs/denormals that would trip FLAGS_check_nan_inf
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], bucket - total, axis=0)])
            feeds[name] = arr
        offsets, off = {}, 0
        for req in batch:
            offsets[id(req)] = off
            off += req.rows
        deadlines = [r.deadline for r in batch if r.deadline is not None]
        timeout = (max(deadlines) - time.monotonic()) if deadlines else None
        # the watchdog brackets the whole blocking dispatch (the
        # run_async dispatch AND the result wait): a hung
        # serving dispatch produces thread stacks + a black-box dump
        # exactly like a hung executor step, instead of a silently
        # wedged worker thread
        wd_token = (_watchdog.arm("serve.dispatch")
                    if _watchdog.ENABLED else None)
        try:

            def _dispatch():
                # serve.dispatch chaos site + classified retry: an
                # injected (or real) transient fault between batches is
                # retried with backoff — rollback-safe, because the
                # batch's feeds are host arrays and nothing was
                # delivered yet; a deterministic failure (verifier,
                # OOM, user error) surfaces to every caller at once
                if _chaos.ENABLED:
                    _chaos.fault("serve.dispatch")
                return predictor.run_async(feeds)

            handle = _retry.call(_dispatch, origin="serve.dispatch")
            # dispatch accounting happens HERE, not after the results
            # land: a batch whose every request later times out still
            # occupied the device at this bucket shape, and an operator
            # debugging overload needs to see it
            with self._stats_lock:
                self._counts["batches"] += 1
                self._counts["real_rows"] += total
                self._counts["padded_rows"] += bucket - total
            _batch_occupancy.observe(total / float(bucket))
            _batches_total.inc(bucket=str(bucket))
            try:
                if timeout is not None:
                    outs = [np.asarray(o)
                            for o in handle.result(
                                timeout=max(0.0, timeout))]
                else:
                    outs = [np.asarray(o) for o in handle.result()]
            except FetchTimeoutError:
                # the timeout is the LATEST deadline in the batch, so
                # every deadlined request has lapsed — reject those; but
                # requests WITHOUT a deadline asked to wait as long as
                # it takes, and the timed-out handle is reusable: block
                # for them (their rows keep their offsets in the batch)
                remaining = []
                for req in batch:
                    if req.deadline is not None:
                        self._finish(req, exc=DeadlineExceededError(
                            "batch exceeded the request deadline"),
                            outcome="deadline")
                    else:
                        remaining.append(req)
                if not remaining:
                    return
                batch = remaining
                outs = [np.asarray(o) for o in handle.result()]
        except Exception as exc:  # noqa: BLE001 - delivered to callers
            for req in batch:
                self._finish(req, exc=exc, outcome="error")
            return
        finally:
            if wd_token is not None:
                _watchdog.disarm(wd_token)
        if traced:
            self._trace_spans(batch, t_dispatch, time.time())
        bad = _misaligned_fetches(outs, bucket)
        if bad is not None:
            exc = ServingError(
                "fetch output %d has shape %r: leading dim != batch "
                "rows %d, so per-request slicing is impossible — "
                "batch-reduced (pooled/scalar) fetches cannot be "
                "served through the batching path" % (bad + (bucket,)))
            for req in batch:
                self._finish(req, exc=exc, outcome="error")
            return
        now = time.monotonic()
        for req in batch:
            offset = offsets[id(req)]
            sliced = [o[offset:offset + req.rows] for o in outs]
            if req.deadline is not None and now > req.deadline:
                self._finish(req, exc=DeadlineExceededError(
                    "completed %.3fs past the deadline"
                    % (now - req.deadline)), outcome="deadline")
            else:
                self._finish(req, value=sliced, outcome="ok")

    # -- lifecycle / introspection ------------------------------------------
    def _warmup_rows(self, example):
        """One zero-valued template row per pad-rung COMBINATION (the
        cartesian product over every bucketed (feed, dim) ladder), so
        warmup covers every shape a steady-state request can resolve
        to — not just the top rungs."""
        import itertools

        ex_row = None
        if example is not None:
            feeds, _rows = self._normalize(example)
            ex_row = {n: a[:1] for n, a in self._pad_request(feeds).items()}
        dtypes = getattr(self._predictor, "feed_dtypes", None) or {}
        choices = []  # (feed name, axis, rung ladder)
        for name in self._feed_names:
            ladders = self._pad_buckets.get(name)
            declared = self._feed_shapes.get(name) or ()
            if not ladders:
                continue
            for axis in range(1, len(declared)):
                if axis < len(ladders) and ladders[axis]:
                    choices.append((name, axis, tuple(ladders[axis])))
        combos = (list(itertools.product(*(c[2] for c in choices)))
                  if choices else [()])
        if len(combos) * len(self._ladder) > 256:
            raise ServingError(
                "warmup would compile %d shapes (%d pad combinations x "
                "%d batch rungs); trim the ladders"
                % (len(combos) * len(self._ladder), len(combos),
                   len(self._ladder)))
        rows = []
        for combo in combos:
            sel = {(n, ax): rung
                   for (n, ax, _l), rung in zip(choices, combo)}
            row = {}
            for name in self._feed_names:
                declared = self._feed_shapes.get(name) or ()
                dims = [1]
                for axis, d in enumerate(declared):
                    if axis == 0:
                        continue
                    if (name, axis) in sel:
                        dims.append(int(sel[(name, axis)]))
                    elif d is not None and d >= 0:
                        dims.append(int(d))
                    elif ex_row is not None:
                        dims.append(int(ex_row[name].shape[axis]))
                    else:
                        raise ServingError(
                            "warmup without an example needs static or "
                            "pad_bucketed dims; feed %r dim %d is "
                            "dynamic" % (name, axis))
                dtype = dtypes.get(name) or (
                    str(ex_row[name].dtype) if ex_row is not None
                    else "float32")
                row[name] = np.zeros(dims, dtype=dtype)
            rows.append(row)
        return rows

    def warmup(self, example=None):
        """Run every servable shape once up front — each batch-ladder
        rung crossed with each pad-bucket combination — through the
        predictor: the kernels build, the analysis cache and the
        library handles warm, so the first real batch of each shape
        pays none of it. ``example`` is one request used only to pin
        dynamic dims no ladder covers (its values never matter)."""
        for row in self._warmup_rows(example):
            for rung in self._ladder:
                self._predictor.run(
                    {n: np.repeat(a, rung, axis=0)
                     for n, a in row.items()})
        return list(self._ladder)

    def latency_percentiles(self):
        """Exact p50/p99 (ms) over the recent completed-request window —
        the numbers ``loadgen.serving_capture`` reports."""
        with self._stats_lock:
            window = list(self._latencies)
        if not window:
            return {"p50_ms": None, "p99_ms": None, "n": 0}
        window.sort()

        def pct(p):
            idx = min(len(window) - 1, int(round(p * (len(window) - 1))))
            return window[idx] * 1000.0

        return {"p50_ms": pct(0.50), "p99_ms": pct(0.99),
                "n": len(window)}

    def stats(self):
        """Counter snapshot + occupancy + latency percentiles."""
        with self._cond:
            depth = len(self._queue)
        with self._stats_lock:
            counts = dict(self._counts)
        dispatched = counts["real_rows"] + counts["padded_rows"]
        return dict(
            counts,
            queue_depth=depth,
            health=(self._monitor.state if self._monitor is not None
                    else "healthy"),
            batch_buckets=list(self._ladder),
            mean_occupancy=(counts["real_rows"] / float(dispatched)
                            if dispatched else None),
            latency_ms=self.latency_percentiles(),
        )

    def close(self, drain=True):
        """Stop the workers. ``drain=True`` serves what's queued first;
        ``drain=False`` fails queued requests with ServerClosedError."""
        with self._cond:
            self._closed = True
            self._drain = bool(drain)
            self._cond.notify_all()
        for t in self._workers:
            t.join(timeout=60.0)

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()
        return False
