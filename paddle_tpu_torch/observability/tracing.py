"""Request-scoped tracing for the serving plane.

Counterpart of ``paddle_tpu/observability/tracing.py`` (a copy). One
trace per request, minted by ``ServingClient`` (a random id plus the
client's send time in the JSON-lines envelope) and continued by
``ServingFrontend``, ``BatchingServer`` and the decode session: queue
wait, admission, decode dispatches and wire flushes as spans, with
derived SLO stats (TTFT, queue/prefill/decode split, inter-token
latency, page-seconds) banked in a bounded ring at :func:`finish`.
Latency histograms carry the ids as exemplars.

Overhead contract: ``ENABLED`` is a module bool flipped by
``FLAGS_request_tracing`` / :func:`enable`; off, every hook costs one
attribute read and the wire carries no ``trace`` field.
"""

import json
import os
import threading
import time
from collections import deque

from paddle_tpu_torch import flags
from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability.metrics_registry import (
    DECODE_BUCKETS,
    REGISTRY,
)

ENABLED = False

RING = 512  # completed traces kept for exemplar resolution / trace_view

_lock = lock_witness.make_lock("observability.tracing")
_inflight = {}                 # trace_id -> Trace
_completed = deque(maxlen=RING)

# inter-token gaps (consecutive chunk flushes of one stream), observed
# at finish() — ms-scale, hence the decode-resolution ladder
_intertoken_seconds = REGISTRY.histogram(
    "paddle_tpu_serving_intertoken_seconds",
    "gap between consecutive streamed token chunks of one traced "
    "request (observed at trace finish; DECODE_BUCKETS resolution)",
    buckets=DECODE_BUCKETS)


def enable(on=True):
    """Flip request tracing; OFF restores the untouched hot path."""
    global ENABLED
    ENABLED = bool(on)


def mint_id():
    """A fresh 16-hex-char trace id (random, not time-derived — ids
    must stay unique across the SIGTERM/restore process boundary)."""
    return os.urandom(8).hex()


class Trace(object):
    """One request's span timeline + accumulators. Mutated from both
    the handler thread (wire flush spans) and the decode worker
    (dispatch spans); list/dict mutation rides the GIL — the module
    lock only guards the in-flight/ring registries."""

    __slots__ = ("id", "origin", "endpoint", "t0", "t_client_send",
                 "spans", "marks", "acc", "baggage", "_root",
                 "_page_ts")

    def __init__(self, trace_id, endpoint, origin, t_client_send,
                 baggage):
        self.id = trace_id
        self.origin = origin
        self.endpoint = endpoint
        self.t0 = time.time()
        self.t_client_send = t_client_send
        self.spans = []
        self.marks = {}
        self.acc = {}
        self.baggage = dict(baggage) if baggage else {}
        self._root = None
        self._page_ts = None

    # -- span API -----------------------------------------------------------
    def begin(self, name, **meta):
        sp = {"name": name, "t0": time.time(), "t1": None,
              "meta": meta}
        self.spans.append(sp)
        return sp

    def end(self, sp, **meta):
        sp["t1"] = time.time()
        if meta:
            sp["meta"].update(meta)
        return sp

    def span(self, name, t0, t1, **meta):
        """Append an already-closed span (e.g. queue wait measured from
        an enqueue stamp)."""
        sp = {"name": name, "t0": float(t0), "t1": float(t1),
              "meta": meta}
        self.spans.append(sp)
        return sp

    def mark(self, name):
        """First-occurrence timestamp mark (e.g. ``first_token``)."""
        self.marks.setdefault(name, time.time())

    def bump(self, key, delta=1):
        """Accumulate a derived-stat counter (tokens, tokens_from_spec,
        cow_copies, ...)."""
        self.acc[key] = self.acc.get(key, 0) + delta

    def sample_pages(self, npages):
        """Integrate page-seconds held: called per decode dispatch and
        at release with the slot's CURRENT page count."""
        now = time.time()
        if self._page_ts is not None:
            self.acc["page_seconds"] = (
                self.acc.get("page_seconds", 0.0)
                + npages * (now - self._page_ts))
        self._page_ts = now


def start(trace_id=None, endpoint="generate", origin="frontend",
          t_client_send=None, baggage=None):
    """Register a new in-flight trace (root span opens immediately and
    closes at :func:`finish` — the whole server-side handling window is
    always covered). ``trace_id=None`` mints one."""
    tr = Trace(trace_id or mint_id(), endpoint, origin, t_client_send,
               baggage)
    tr._root = tr.begin("request", endpoint=endpoint, origin=origin)
    with _lock:
        _inflight[tr.id] = tr
    return tr


def inflight_get(trace_id):
    with _lock:
        return _inflight.get(trace_id)


def inflight_ids():
    with _lock:
        return sorted(_inflight)


def _percentile(vals, q):
    if not vals:
        return None
    vals = sorted(vals)
    k = max(0, min(len(vals) - 1,
                   int(round(q / 100.0 * len(vals) + 0.5)) - 1))
    return vals[k]


def _union_seconds(spans, t1_default):
    ivals = sorted((sp["t0"], sp["t1"] if sp["t1"] is not None
                    else t1_default) for sp in spans)
    total, hi = 0.0, None
    for a, b in ivals:
        if hi is None or a > hi:
            total += max(0.0, b - a)
            hi = b
        elif b > hi:
            total += b - hi
            hi = b
    return total


def finish(tr, outcome="ok", **meta):
    """Close the trace: force-close leaked spans (flagged in their
    meta — the cancel/disconnect tests sweep the ring for the flag),
    derive per-request stats, bank the record, drop the in-flight
    entry. Returns the record."""
    now = time.time()
    with _lock:
        _inflight.pop(tr.id, None)
    for sp in tr.spans:
        if sp["t1"] is None:
            sp["t1"] = now
            if sp is not tr._root:
                sp["meta"]["force_closed"] = True
    wall = max(now - tr.t0, 1e-9)
    client_wall = (max(now - tr.t_client_send, wall)
                   if tr.t_client_send is not None else wall)
    by_name = {}
    for sp in tr.spans:
        if sp is tr._root:
            continue
        by_name.setdefault(sp["name"], 0.0)
        by_name[sp["name"]] += sp["t1"] - sp["t0"]
    # inter-token gaps: consecutive chunk deliveries — wire flushes for
    # frontend streams, decode dispatches for in-process/session traces
    chunk_ts = sorted(sp["t1"] for sp in tr.spans
                      if sp["name"] == "wire.flush")
    if not chunk_ts:
        chunk_ts = sorted(sp["t1"] for sp in tr.spans
                          if sp["name"] == "decode.step")
    gaps = [b - a for a, b in zip(chunk_ts, chunk_ts[1:])]
    for g in gaps:
        _intertoken_seconds.observe(g, exemplar=tr.id)
    first = tr.marks.get("first_token")
    tokens = tr.acc.get("tokens", 0)
    spec = tr.acc.get("tokens_from_spec", 0)
    stats = {
        "wall_s": round(wall, 6),
        "client_wall_s": round(client_wall, 6),
        "ttft_s": (round(first - (tr.t_client_send
                                  if tr.t_client_send is not None
                                  else tr.t0), 6)
                   if first is not None else None),
        "queue_s": round(by_name.get("queue", 0.0), 6),
        "admit_s": round(by_name.get("admit", 0.0), 6),
        "prefill_s": round(by_name.get("prefill", 0.0), 6),
        "decode_s": round(by_name.get("decode.step", 0.0), 6),
        "flush_s": round(by_name.get("wire.flush", 0.0), 6),
        "intertoken_p50_ms": (round(_percentile(gaps, 50) * 1e3, 3)
                              if gaps else None),
        "intertoken_p95_ms": (round(_percentile(gaps, 95) * 1e3, 3)
                              if gaps else None),
        "intertoken_max_ms": (round(max(gaps) * 1e3, 3)
                              if gaps else None),
        "tokens": tokens,
        "tokens_from_spec": spec,
        "spec_fraction": (round(spec / float(tokens), 4)
                          if tokens else None),
        "page_seconds": round(tr.acc.get("page_seconds", 0.0), 6),
        "cow_copies": tr.acc.get("cow_copies", 0),
        # the acceptance number: fraction of the CLIENT-observed wall
        # the trace's spans account for (root span == the server-side
        # handling window; the remainder is wire + client scheduling)
        "span_coverage": round(
            min(1.0, _union_seconds(tr.spans, now) / client_wall), 4),
    }
    rec = {
        "trace_id": tr.id,
        "endpoint": tr.endpoint,
        "origin": tr.origin,
        "outcome": outcome,
        "t0": tr.t0,
        "t1": now,
        "t_client_send": tr.t_client_send,
        "stats": stats,
        "spans": tr.spans,
        "baggage": tr.baggage,
    }
    if meta:
        rec.update(meta)
    with _lock:
        _completed.append(rec)
    return rec


def get(trace_id):
    """Resolve a trace id (e.g. a histogram exemplar) to its completed
    ring record, newest first; None when it aged out."""
    with _lock:
        for rec in reversed(_completed):
            if rec["trace_id"] == trace_id:
                return rec
    return None


def completed():
    with _lock:
        return list(_completed)


def write_traces_jsonl(path):
    """One JSON line per completed trace; returns the record count."""
    with _lock:
        recs = list(_completed)
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec) + "\n")
    return len(recs)


def perfetto_events(rec, row=0, pid=1):
    """One completed record -> Chrome/Perfetto ``traceEvents`` (complete
    'X' events, microsecond timestamps; ``row`` is the track the
    request renders on). Shared by tools/trace_view.py and the smoke's
    validity check."""
    events = [{
        "name": "trace %s" % rec["trace_id"], "ph": "M",
        "pid": pid, "tid": row, "cat": "__metadata",
        "ts": 0, "args": {"name": rec["trace_id"]},
    }]
    for sp in rec["spans"]:
        args = {"trace_id": rec["trace_id"]}
        args.update(sp.get("meta") or {})
        events.append({
            "name": sp["name"], "ph": "X", "cat": "serving",
            "pid": pid, "tid": row,
            "ts": round(sp["t0"] * 1e6, 3),
            "dur": round(max(sp["t1"] - sp["t0"], 0.0) * 1e6, 3),
            "args": args,
        })
    return events


def reset():
    """Drop every in-flight and completed trace (tests)."""
    with _lock:
        _inflight.clear()
        _completed.clear()


def _init_from_flags():
    try:
        enable(bool(flags.get("request_tracing")))
    except Exception:
        pass


_init_from_flags()
