"""ServingFrontend: the network serving plane over the JSON-lines
substrate.

Counterpart of ``paddle_tpu/serving/frontend.py`` over the port's
``BatchingServer`` and ``SlotDecodeSession``; the wire grammar, method
names, events and typed errors are the JAX package's, so a client of
either package drives a frontend of the other.

Endpoints (one JSON line per request):

* ``predict`` — unary, routed to a :class:`serving.server.BatchingServer`.
  Deadlines ride the wire; the server's typed admission errors
  (``QueueFullError``/``DeadlineExceededError``/``DegradedError``...)
  serialize as typed wire errors (``serving.client.error_to_wire``)
  the client re-raises as the same exception classes.
* ``generate`` — STREAMING, routed to a
  :class:`serving.generation.SlotDecodeSession`: token chunks are
  flushed to the socket as each decode dispatch (``step()``) completes.
  ``n > 1`` forks a best-of-N group through ``admit_group`` and
  ``prefix_tokens`` rides the prefix cache. Solo requests queue in the
  session's backlog; forks are admit-or-reject. ``beam=true`` admits one
  beam lane of a beam session (admit-or-reject): its ``admitted`` event
  carries ``beam``, ``beam_width`` and the claim ``id``, each dispatch
  sends one ``beam`` survivor chunk (parents, tokens, scores, done), and
  a final ``beam_end`` carries the n-best, rescored under the GNMT length
  penalty when the request gives ``len_penalty``. ``n > 1`` with
  ``beam`` and ``len_penalty`` without it are typed rejects.
* ``metrics`` — the process's Prometheus scrape; ``health`` — the
  ``HealthMonitor`` states; ``stats`` / ``take_result`` — introspection
  and banked-result claims; ``trace`` — a completed request trace.
* ``snapshot`` — a quiesced synchronous decode snapshot whose files ride
  the wire (base64 per file); ``restore`` — install such a payload into
  this frontend's session (``MigrationBusyError`` unless it is
  quiesced; the in-flight async snapshot writer is joined first);
  ``attach`` — re-bind a stream to a solo request by rid (banked, live
  or pending), replaying its tokens from position 1 in a ``resumed``
  event; the client trims against its own ``next_seq``. Without a
  ``snapshot_manager`` the first two answer a typed error.

Preemption: construct the ``DecodeSnapshotManager(
install_signal_handlers=True)`` first, then the frontend with
``install_signal_handlers=True``: on SIGTERM the frontend stops the
transport and chains to the manager, which finishes the in-flight
dispatch, banks a final snapshot (live slots and the queued backlog)
and re-raises, so the process dies by the signal with the work
recoverable.

Disconnect safety: a client that dies (or cancels) mid-stream costs the
pool nothing. Three hooks converge on one teardown — the substrate's
per-connection close callback, the in-band ``cancel`` line, and the
stream generator's ``GeneratorExit`` (a failed socket write) — each
routing to ``SlotDecodeSession.cancel`` / ``drop_pending`` on the decode
worker thread; ``pool_conserved`` holds afterwards.

One decode-worker thread owns the session (admissions, steps and
cancellations serialize through it; the session is not thread-safe). On
a card its first ``step()`` per key captures the decode loop into a CUDA
graph from that thread while ``BatchingServer`` workers may be launching
kernels: the executor captures in ``thread_local`` mode, so their work
neither fails the capture nor enters the graph. Handler threads only
move messages between the worker and their sockets.
"""

import base64
import json
import os
import queue
import select
import shutil
import signal
import socket
import threading
import time
from collections import deque

import numpy as np

from paddle_tpu_torch.distributed.master import (
    close_json_server,
    serve_json_lines,
)
from paddle_tpu_torch.models.transformer import gnmt_rescore_nbest
from paddle_tpu_torch.observability import lock_witness
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.observability.metrics_registry import (
    REGISTRY as _REGISTRY,
    SERVING_BUCKETS,
)
from paddle_tpu_torch.serving.client import (
    MigrationBusyError,
    decode_array,
    encode_array,
    error_from_wire,
    error_to_wire,
)
from paddle_tpu_torch.serving.degradation import SHED as _SHED
from paddle_tpu_torch.serving.degradation import DegradedError
from paddle_tpu_torch.serving.generation import (
    NoFreeGroupError,
    NoFreePageError,
    NoFreeSlotError,
)
from paddle_tpu_torch.serving.server import (
    DeadlineExceededError,
    QueueFullError,
    ServerClosedError,
    ServingError,
)

__all__ = ["ServingFrontend"]


_fe_request_seconds = _REGISTRY.histogram(
    "paddle_tpu_frontend_request_seconds",
    "wire request latency by endpoint and outcome (streams: request "
    "arrival to terminal event)",
    labels=("endpoint", "outcome"), buckets=SERVING_BUCKETS)
_fe_active_conns = _REGISTRY.gauge(
    "paddle_tpu_frontend_active_connections",
    "established frontend client connections")
_fe_bytes_sent = _REGISTRY.counter(
    "paddle_tpu_frontend_bytes_sent_total",
    "response bytes written to frontend sockets")
_fe_bytes_received = _REGISTRY.counter(
    "paddle_tpu_frontend_bytes_received_total",
    "request bytes read from frontend sockets")
_fe_ttft = _REGISTRY.histogram(
    "paddle_tpu_frontend_ttft_seconds",
    "stream time-to-first-token: generate request arrival to the first "
    "token chunk flushed", buckets=SERVING_BUCKETS)
_fe_streams_total = _REGISTRY.counter(
    "paddle_tpu_frontend_streams_total",
    "generate streams by terminal outcome",
    labels=("outcome",))  # ok | cancelled | disconnect | error | ...


def _outcome(exc):
    """Metrics outcome label for one typed failure."""
    if isinstance(exc, QueueFullError):
        return "queue_full"
    if isinstance(exc, DeadlineExceededError):
        return "deadline"
    if isinstance(exc, DegradedError):
        return "degraded"
    if isinstance(exc, ServerClosedError):
        return "closed"
    if isinstance(exc, (NoFreeSlotError, NoFreePageError,
                        NoFreeGroupError)):
        return "no_capacity"
    return "error"


class _Stream(object):
    """One wire generate stream: the handler thread consumes ``q``;
    the decode worker produces into it and tracks the live slots."""

    __slots__ = ("q", "spec", "cancelled", "live", "rid", "done",
                 "beam_lane", "beam_rid")

    def __init__(self, spec):
        self.q = queue.Queue()
        self.spec = spec       # {"src", "src_len", "n", "prefix", "trace_id"}
        self.cancelled = threading.Event()
        self.live = {}         # slot -> member index
        self.rid = None        # session request id when deferred
        self.done = False
        self.beam_lane = None  # beam streams: the lane this stream owns
        self.beam_rid = None   # ... and its banked-result claim id


class _DecodeWorker(object):
    """The one thread that owns the SlotDecodeSession.

    Handler threads enqueue admissions/cancellations; the worker admits
    (directly for fork groups, through the session's queue for solo
    requests), steps the shared pool, and streams each tracked slot's
    per-dispatch token increments to its wire stream. Finished slots
    that no stream owns are banked in the session's result bank,
    exactly like ``pump()``. ``call(fn)`` runs ``fn`` on the worker
    between dispatches.
    """

    def __init__(self, session, max_backlog=64):
        self._s = session
        self._cond = lock_witness.make_condition("serving.frontend.decode")
        self._incoming = deque()
        self._cancels = deque()
        self._ops = deque()      # (fn, box, done) session ops executed
        #                          between dispatches
        self._stop = False
        self._drain = True
        self._slot_stream = {}   # slot -> (stream, member)
        self._beam_stream = {}   # lane -> stream (beam generations)
        self._rid_stream = {}    # rid -> stream (queued, not yet admitted)
        self._prev_pos = {}      # slot -> last streamed position
        self._max_backlog = int(max_backlog)
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-frontend-decode",
            daemon=True)
        self._thread.start()

    # -- handler-thread API --------------------------------------------------

    def submit(self, stream):
        with self._cond:
            if self._stop:
                stream.q.put(error_to_wire(
                    ServerClosedError("frontend is closed")))
                return
            self._incoming.append(stream)
            self._cond.notify_all()

    def cancel(self, stream):
        stream.cancelled.set()
        with self._cond:
            self._cancels.append(stream)
            self._cond.notify_all()

    def stop(self, drain=True, timeout=60.0):
        with self._cond:
            self._stop = True
            self._drain = bool(drain)
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def call(self, fn, timeout=60.0):
        """Run ``fn()`` ON the decode worker thread, between dispatches
        (a quiesce point — the session is never mid-dispatch there),
        the one way to reach the session from another thread while the
        frontend is up."""
        box = {}
        done = threading.Event()
        with self._cond:
            if self._stop:
                raise ServerClosedError("frontend is closed")
            self._ops.append((fn, box, done))
            self._cond.notify_all()
        if not done.wait(timeout=timeout):
            raise TimeoutError("decode worker op timed out")
        if "exc" in box:
            raise box["exc"]
        return box["val"]

    def _run_ops(self, ops):
        for fn, box, done in ops:
            try:
                box["val"] = fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised in call
                box["exc"] = exc
            done.set()

    def _fail_ops(self):
        with self._cond:
            ops = list(self._ops)
            self._ops.clear()
        for _fn, box, done in ops:
            box["exc"] = ServerClosedError("frontend is closed")
            done.set()

    # -- worker loop ---------------------------------------------------------

    def _loop(self):
        s = self._s
        while True:
            with self._cond:
                while (not self._incoming and not self._cancels
                        and not self._ops
                        and not self._stop and not s.active_slots
                        and not (s.pending_requests and s.free_slots)):
                    # the timeout re-checks capacity-deferred backlog
                    # (a NoFreePage defer relaxes only as leaks/cache
                    # pressure do, not on any notify)
                    self._cond.wait(0.25)
                incoming = list(self._incoming)
                self._incoming.clear()
                cancels = list(self._cancels)
                self._cancels.clear()
                ops = list(self._ops)
                self._ops.clear()
                stop, drain = self._stop, self._drain
            progressed = bool(incoming or cancels or ops)
            for stream in cancels:
                self._teardown(stream)
            # ops run at this quiesce point: after cancels (so a drain's
            # "no live streams" check sees the teardowns) and before
            # this pass's admissions/dispatch
            self._run_ops(ops)
            for stream in incoming:
                if stop:
                    stream.q.put(error_to_wire(
                        ServerClosedError("frontend is closed")))
                    stream.done = True
                elif not stream.cancelled.is_set():
                    self._admit(stream)
            if stop and not drain:
                self._abort_all()
                self._fail_ops()
                return
            progressed |= self._admit_backlog()
            if s.active_slots:
                try:
                    self._step_once()
                except Exception as exc:  # noqa: BLE001 - typed below
                    # a hard decode failure (not the classified-retry
                    # transients — those were retried inside the
                    # executor) must not kill the worker and wedge
                    # every stream: every tracked stream gets the
                    # typed failure, its slots are cancelled, the
                    # worker lives on for the next admission
                    self._fail_tracked(exc)
                progressed = True
            if (stop and drain and not s.active_slots
                    and not s.pending_requests and not self._slot_stream
                    and not self._rid_stream and not self._beam_stream):
                self._fail_ops()
                return
            if not progressed:
                # a whole pass moved nothing — the backlog is
                # capacity/degradation-deferred with no live slots to
                # drain it (e.g. leaked pages shrank capacity): sleep
                # instead of spinning on admit_pending, but wake
                # immediately for new work. Deliberately NOT gated on
                # _stop: a close(drain=True) over an undrainable
                # backlog must idle at this cadence, not burn a core
                # until the join timeout
                with self._cond:
                    if not self._incoming and not self._cancels:
                        self._cond.wait(0.1)

    def _admit_backlog(self):
        """Admit queued requests and map the newly admitted ones back
        to their wire streams. ``admit_pending`` raising mid-way (a
        failed admission dispatch past the retry budget, a request the
        session type refuses — e.g. a forced prefix on a dense
        session) must not kill the worker: the failed request's stream
        gets the typed error, requests admitted BEFORE the failure are
        recovered from the session's owner map. Returns True when the
        pass made progress (an admission or an error delivery) — a
        fully deferred backlog returns False so the loop can throttle
        instead of spinning."""
        s = self._s
        before = set(s.pending_requests)
        exc = None
        try:
            s.admit_pending()
        except Exception as e:  # noqa: BLE001 - delivered to the stream
            exc = e
        progressed = before != set(s.pending_requests)
        # newly admitted = owner entries a wire stream is waiting on
        # (rids no stream waits on stay owned and bank on finish)
        for slot, rid in list(s._owner.items()):
            stream = self._rid_stream.pop(rid, None)
            if stream is None:
                continue
            if stream.cancelled.is_set():
                self._safe_cancel(slot)
                continue
            self._track(stream, {slot: 0})
            stream.q.put(self._admitted_event(stream))
        if exc is not None:
            # the request that failed was popped but neither admitted
            # nor re-deferred: its id is gone from both views
            lost = (before - set(s.pending_requests)
                    - set(s._owner.values()))
            for rid in lost:
                stream = self._rid_stream.pop(rid, None)
                if stream is not None and not stream.done:
                    stream.done = True
                    stream.q.put(error_to_wire(exc))
            progressed = True
        return progressed

    def _tracked_streams(self):
        return set(list(st for st, _m in self._slot_stream.values())
                   + list(self._beam_stream.values()))

    def _fail_tracked(self, exc):
        wire = error_to_wire(exc)
        for stream in self._tracked_streams():
            # teardown marks the stream done; the terminal error line
            # must still be delivered (a tracked stream has not yet
            # seen a terminal event — it was live until this failure)
            self._teardown(stream)
            stream.q.put(dict(wire))

    def _admit(self, stream):
        s = self._s
        spec = stream.spec
        tid = spec.get("trace_id")
        t_admit = time.time() if tid else 0.0
        try:
            if spec.get("attach") is not None:
                self._attach_stream(stream)
            elif spec.get("beam"):
                # a beam request: admit-or-reject into one lane (its K x
                # worst-case reservation never queues); the survivor
                # chunks stream from _step_once, the n-best from the
                # session's result bank
                lane = s.admit_beam(spec["src"], spec["src_len"],
                                    prefix_tokens=spec["prefix"])
                stream.beam_lane = lane
                stream.beam_rid = s.register_beam_owner(lane)
                self._beam_stream[lane] = stream
                for k, slot in enumerate(s.beam_slots(lane)):
                    stream.live[slot] = k
                self._trace_admitted(stream, t_admit, kind="beam")
                stream.q.put(self._admitted_event(stream))
            elif spec["n"] == 1:
                # the shed answer at the WIRE edge: a shed session
                # refuses with the typed retriable DegradedError
                # (retry-after hint) instead of silently parking the
                # request behind a queue it is trying to drain. A pure
                # STATE read — never observe(): the admission path's
                # own gate observes, and a second observation per
                # request would let one request step the monitor two
                # recovery levels (forks don't need this check at all:
                # admit_group gates internally)
                monitor = s._monitor
                if monitor is not None and s.health == _SHED:
                    raise monitor.reject("admission (draining "
                                         "in-flight)")
                # solo requests ride the session's queue, admitted in
                # arrival order by admit_pending (possibly this same
                # pass)
                if len(s.pending_requests) >= self._max_backlog:
                    raise QueueFullError(
                        "decode backlog at max_stream_backlog %d"
                        % self._max_backlog)
                rid = s.enqueue(spec["src"], spec["src_len"],
                                prefix_tokens=spec["prefix"],
                                trace_id=tid)
                stream.rid = rid
                self._rid_stream[rid] = stream
                ev = {"ok": True, "event": "queued", "id": int(rid)}
                if tid:
                    ev["trace_id"] = tid
                stream.q.put(ev)
            else:
                # forks are admit-or-reject: their n x worst-case page
                # reservation is too large to head-of-line park in the
                # backlog
                slots = s.admit_group(
                    spec["src"], n=spec["n"], src_len=spec["src_len"],
                    prefix_tokens=spec["prefix"])
                self._track(stream,
                            {slot: m for m, slot in enumerate(slots)})
                self._trace_admitted(stream, t_admit, kind="group")
                stream.q.put(self._admitted_event(stream))
        except Exception as exc:  # noqa: BLE001 - typed to the wire
            stream.done = True
            stream.q.put(error_to_wire(exc))

    def _attach_stream(self, stream):
        """Re-bind a wire stream to an EXISTING solo request by rid —
        the router's failover/drain splice point. The first event is
        ``resumed`` replaying the request's tokens from absolute
        position 1 (trg index 0 is bos); the consumer trims against its
        own ``next_seq``, which handles both a snapshot BEHIND the
        delivered stream (overlap) and a drain snapshot AHEAD of the
        relay (gap-fill) with one splice. Every ``resumed`` variant
        carries ``bos`` — a router synthesizes a correct admission
        from it when a stream failed over before its admission event
        reached the client. Three states attach cleanly:
        banked (finished headless — replay + end), live (track the slot
        mid-flight), pending (wait for admission like a fresh enqueue).
        """
        s = self._s
        rid = int(stream.spec["attach"])
        if rid in s._results:
            trg = s.take_result(rid)
            toks = self._final_tokens(trg, 0)
            stream.done = True
            stream.q.put({
                "ok": True, "event": "resumed", "id": rid, "seq": 1,
                "bos": int(s._bos),
                "tokens": [int(t) for t in toks], "finished": True,
                "max_length": int(s._T), "eos": int(s._eos)})
            stream.q.put({"ok": True, "event": "end", "id": rid})
            return
        slot = next((sl for sl, r in s._owner.items() if r == rid),
                    None)
        if slot is not None:
            if slot in self._slot_stream:
                raise ServingError(
                    "request %d already has a live stream" % rid)
            stream.rid = rid
            self._track(stream, {slot: 0})
            pos = s._live[slot]["pos"]
            stream.q.put({
                "ok": True, "event": "resumed", "id": rid, "seq": 1,
                "bos": int(s._bos),
                "tokens": [int(t)
                           for t in s._live[slot]["trg"][1:pos + 1]],
                "finished": False,
                "max_length": int(s._T), "eos": int(s._eos)})
            return
        if rid in s.pending_requests:
            pend = next((p for p in s._pending if p["id"] == rid), None)
            if pend is not None:
                stream.spec["prefix"] = pend.get("prefix")
            stream.rid = rid
            self._rid_stream[rid] = stream
            stream.q.put({
                "ok": True, "event": "resumed", "id": rid, "seq": 1,
                "bos": int(s._bos),
                "tokens": [], "finished": False,
                "max_length": int(s._T), "eos": int(s._eos)})
            return
        raise ServingError("unknown request id %d (not banked, live or "
                           "pending on this frontend)" % rid)

    def _trace_admitted(self, stream, t_admit, kind):
        """Direct admissions (fork groups, beam lanes) bypass the session
        queue, so their admit span and slot->trace binding are emitted
        here; queued solos get both from ``admit_pending``."""
        tid = stream.spec.get("trace_id")
        if not tid:
            return
        tr = _tracing.inflight_get(tid)
        if tr is not None:
            tr.span("admit", t_admit, time.time(), kind=kind,
                    members=len(stream.live))
        for slot in stream.live:
            self._s._slot_traces[slot] = tid

    def _track(self, stream, slots_members):
        s = self._s
        for slot, member in slots_members.items():
            stream.live[slot] = member
            self._slot_stream[slot] = (stream, member)
            # the worker owns the session thread; reading the live
            # mirror directly is the package-internal contract
            self._prev_pos[slot] = s._live[slot]["pos"]

    def _admitted_event(self, stream):
        s = self._s
        prefix = [s._bos] + [int(t)
                             for t in (stream.spec["prefix"] or ())]
        slots = sorted(stream.live, key=lambda sl: stream.live[sl])
        ev = {"ok": True, "event": "admitted",
              "members": len(slots), "slots": [int(x) for x in slots],
              "prefix": prefix, "pos": len(prefix) - 1,
              "max_length": int(s._T), "eos": int(s._eos)}
        tid = stream.spec.get("trace_id")
        if tid:
            ev["trace_id"] = tid
        if stream.rid is not None:
            # solo streams carry their rid (the (rid, seq) splice key of
            # the wire grammar; fork groups have no single rid)
            ev["id"] = int(stream.rid)
        if stream.beam_lane is not None:
            ev["beam"] = int(stream.beam_lane)
            ev["beam_width"] = int(s.beam_width)
            ev["id"] = int(stream.beam_rid)
        return ev

    def _final_tokens(self, trg, prev):
        """Tokens a finished slot generated past ``prev``: through the
        first eos (the terminal token — post-finish positions are
        forced-eos padding) or the max-length cap."""
        s = self._s
        for idx in range(prev + 1, s._T):
            if int(trg[idx]) == s._eos:
                return trg[prev + 1:idx + 1]
        return trg[prev + 1:s._T]

    def _step_beams(self):
        """The beam streams' part of one dispatch: one survivor chunk per
        live lane (parents, tokens, scores, done flags), and for a lane
        that finished its last chunk, then the n-best (``beam_end``) from
        the session's bank and ``end``."""
        s = self._s
        for lane, ev in s.last_beam_events.items():
            stream = self._beam_stream.get(lane)
            if stream is None or stream.cancelled.is_set():
                continue
            stream.q.put({"ok": True, "event": "beam",
                          "parents": [int(p) for p in ev["parents"]],
                          "tokens": [int(t) for t in ev["tokens"]],
                          "scores": [float(x) for x in ev["scores"]],
                          "done": [bool(d) for d in ev["done"]]})
        for lane, fin in s.last_finished_beams.items():
            stream = self._beam_stream.pop(lane, None)
            if stream is None:
                continue  # no stream waits: the n-best stays banked
            stream.live.clear()
            res = s.take_beam_result(stream.beam_rid)
            if res is None:
                res = fin
            stream.beam_lane = None
            if stream.cancelled.is_set():
                continue
            stream.q.put({"ok": True, "event": "beam",
                          "parents": [int(p) for p in fin["parents"]],
                          "tokens": [int(t) for t in fin["step_tokens"]],
                          "scores": [float(x) for x in fin["step_scores"]],
                          "done": [True] * len(fin["parents"])})
            end_ev = {"ok": True, "event": "beam_end",
                      "tokens": [[int(t) for t in row]
                                 for row in res["tokens"]],
                      "scores": [float(x) for x in res["scores"]]}
            lp = stream.spec.get("len_penalty")
            if lp is not None:
                # GNMT rescoring: the n-best reordered under the penalized
                # scores; ``order`` lets a client realign its survivor
                # replay
                order, toks, pscores = gnmt_rescore_nbest(
                    res["tokens"], res["scores"], s._eos, lp)
                end_ev["tokens"] = [[int(t) for t in row] for row in toks]
                end_ev["scores"] = [float(x) for x in pscores]
                end_ev["order"] = [int(i) for i in order]
                end_ev["len_penalty"] = float(lp)
            stream.q.put(end_ev)
            stream.done = True
            stream.q.put({"ok": True, "event": "end"})

    def _step_once(self):
        s = self._s
        finished = s.step()
        if s.beam_width > 1:
            self._step_beams()
        for slot in list(self._slot_stream):
            stream, member = self._slot_stream[slot]
            prev = self._prev_pos[slot]
            if slot in finished:
                toks = self._final_tokens(finished[slot], prev)
                del self._slot_stream[slot]
                del self._prev_pos[slot]
                stream.live.pop(slot, None)
                rid = s._owner.pop(slot, None)  # streamed, not banked
                if rid is not None:
                    s._trace_ids.pop(rid, None)
                if len(toks) and not stream.cancelled.is_set():
                    ev = {"ok": True, "event": "tokens",
                          "member": member,
                          "tokens": [int(t) for t in toks]}
                    if stream.rid is not None:
                        # (rid, seq): seq is the ABSOLUTE trg position
                        # of the chunk's first token — the client's
                        # splice key (trg[0] is bos, so the
                        # first generated chunk of a prefixless
                        # request carries seq=1)
                        ev["id"] = int(stream.rid)
                        ev["seq"] = int(prev + 1)
                    stream.q.put(ev)
                if not stream.live and not stream.done:
                    stream.done = True
                    if not stream.cancelled.is_set():
                        end_ev = {"ok": True, "event": "end"}
                        if stream.rid is not None:
                            end_ev["id"] = int(stream.rid)
                        stream.q.put(end_ev)
            else:
                st = s._live.get(slot)
                if st is None:
                    continue
                new = st["pos"]
                if new > prev and not stream.cancelled.is_set():
                    ev = {"ok": True, "event": "tokens",
                          "member": member,
                          "tokens": [int(t)
                                     for t in st["trg"][prev + 1:new + 1]]}
                    if stream.rid is not None:
                        ev["id"] = int(stream.rid)
                        ev["seq"] = int(prev + 1)
                    stream.q.put(ev)
                self._prev_pos[slot] = new
        # finishes no stream owns: bank exactly like pump(), so
        # take_result can claim them
        for slot, trg in finished.items():
            if slot in self._prev_pos:
                continue
            rid = s._owner.pop(slot, None)
            if rid is not None:
                s._results[rid] = trg
                s._trace_bank(rid)

    def _safe_cancel(self, slot):
        """Session cancel that can never kill the worker thread: the
        session absorbs repoint failures as recorded leaks; anything
        that still escapes (an invariant break) is logged loudly — a
        dead decode worker wedges EVERY stream, which is strictly
        worse than one slot in a degraded state."""
        try:
            self._s.cancel(slot)
        except Exception:  # noqa: BLE001 - logged, worker survives
            import logging

            logging.getLogger("paddle_tpu_torch.serving").exception(
                "cancel of slot %s failed during stream teardown",
                slot)

    def _teardown(self, stream):
        """Disconnect/cancel reclamation: live slots are cancelled
        (slot + page references returned — ``pool_conserved`` holds
        after this), a queued request leaves the backlog."""
        s = self._s
        stream.done = True
        if stream.beam_lane is not None:
            self._beam_stream.pop(stream.beam_lane, None)
            stream.beam_lane = None
        for slot in list(stream.live):
            self._slot_stream.pop(slot, None)
            self._prev_pos.pop(slot, None)
            # on a beam session the first cancel releases the whole lane;
            # the siblings' cancels return False
            self._safe_cancel(slot)
        stream.live.clear()
        if stream.rid is not None:
            s.drop_pending(stream.rid)
            self._rid_stream.pop(stream.rid, None)
            stream.rid = None

    def _abort_all(self):
        closed = ServerClosedError("frontend closed before completion")
        for stream in self._tracked_streams():
            self._teardown(stream)
            stream.q.put(error_to_wire(closed))
        for stream in list(self._rid_stream.values()):
            self._teardown(stream)
            stream.q.put(error_to_wire(closed))


class ServingFrontend(object):
    """Bind the serving stack to a host/port.

    Parameters
    ----------
    server : serving.server.BatchingServer, optional
        Serves the unary ``predict`` endpoint. The frontend does not
        own it — closing the frontend leaves it (and the session)
        running for in-process use.
    session : serving.generation.SlotDecodeSession, optional
        Serves the streaming ``generate`` endpoint (a dedicated worker
        thread takes ownership of its dispatch loop — don't drive the
        session from other threads while the frontend is up).
    host, port : bind address (port 0 = ephemeral; see ``address``).
    max_stream_backlog : int
        Bound on queued (not yet admitted) solo generate requests;
        beyond it admissions reject with ``QueueFullError``.
    stream_poll_s : float
        Cadence at which an idle stream handler polls its connection
        for an in-band cancel / EOF.
    install_signal_handlers : bool
        SIGTERM/SIGINT stop the transport and CHAIN to the previously
        installed handler (with none, the process dies by the signal).
        Install a ``DecodeSnapshotManager``'s handlers first: then a
        preempted frontend banks its session (live slots and backlog) at
        the next quiesce point and dies by the signal.
    snapshot_manager : serving.snapshot.DecodeSnapshotManager, optional
        Arms the ``snapshot``/``restore``/``attach`` wire endpoints (the
        migration protocol). Both snapshot and restore run on the decode
        worker between dispatches; ``restore`` refuses a session that is
        not quiesced with the typed retriable ``MigrationBusyError``.
    ssl_context, auth_token :
        Passed through to ``serve_json_lines`` — TLS and bearer auth on
        the frontend's wire (default: both off, wire unchanged).
    """

    def __init__(self, server=None, session=None, host="127.0.0.1",
                 port=0, max_stream_backlog=64, stream_poll_s=0.05,
                 install_signal_handlers=False, snapshot_manager=None,
                 ssl_context=None, auth_token=None):
        if server is None and session is None:
            raise ValueError(
                "ServingFrontend needs a BatchingServer (predict), a "
                "SlotDecodeSession (generate), or both")
        self._batching = server
        self._session = session
        self._snap_mgr = snapshot_manager
        self._decode = (_DecodeWorker(session,
                                      max_backlog=max_stream_backlog)
                        if session is not None else None)
        self._poll = float(stream_poll_s)
        self._mu = lock_witness.make_lock("serving.frontend.mu")
        self._closed = False
        self._counts = {}
        self._active_streams = 0
        self._conns = 0
        self._io_seen = [0, 0]
        self._prev_handlers = {}
        self._json_server, self.address = serve_json_lines(
            self._dispatch, host=host, port=port, pass_conn=True,
            on_open=self._on_open, on_close=self._on_close,
            ssl_context=ssl_context, auth_token=auth_token)
        if install_signal_handlers:
            self._install_signal_handlers()

    @property
    def port(self):
        return self.address[1]

    # -- connection hooks ----------------------------------------------------

    def _on_open(self, conn):
        with self._mu:
            self._conns += 1
            _fe_active_conns.set(self._conns)

    def _on_close(self, conn):
        # THE disconnect-reclamation hook: whatever streams this
        # connection still owns are torn down on the decode worker —
        # slot freed, page refcounts back to conservation
        for stream in list(conn.state.get("streams", ())):
            if self._decode is not None:
                self._decode.cancel(stream)
        with self._mu:
            self._conns -= 1
            _fe_active_conns.set(self._conns)
        self._sync_io()

    def _sync_io(self):
        srv = self._json_server
        if srv is None:
            return
        with srv._conn_mu:
            sent, received = srv.bytes_sent, srv.bytes_received
        with self._mu:
            ds = sent - self._io_seen[0]
            dr = received - self._io_seen[1]
            self._io_seen = [sent, received]
        if ds > 0:
            _fe_bytes_sent.inc(ds)
        if dr > 0:
            _fe_bytes_received.inc(dr)

    def _observe(self, endpoint, outcome, t0, exemplar=None):
        dt = time.monotonic() - t0
        with self._mu:
            key = (endpoint, outcome)
            self._counts[key] = self._counts.get(key, 0) + 1
        _fe_request_seconds.observe(dt, exemplar=exemplar,
                                    endpoint=endpoint, outcome=outcome)
        if endpoint == "generate":
            _fe_streams_total.inc(outcome=outcome)

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, req, conn):
        method = req.get("method")
        if method == "predict":
            return self._predict(req)
        if method == "generate":
            return self._generate(req, conn)
        if method == "cancel":
            # out-of-band cancel with no stream in flight on this
            # connection: nothing to tear down, answer idempotently
            return {"ok": True, "event": "cancelled", "idle": True}
        if method == "metrics":
            self._sync_io()
            return {"ok": True, "text": _REGISTRY.to_prometheus()}
        if method == "health":
            return {"ok": True, "health": self._health()}
        if method == "stats":
            return {"ok": True, "stats": self.stats()}
        if method == "take_result":
            return self._take_result(req)
        if method == "attach":
            return self._attach(req, conn)
        if method == "snapshot":
            return self._snapshot(req)
        if method == "restore":
            return self._restore(req)
        if method == "trace":
            # completed-trace lookup by id: ring-resident records only
            # (in-flight ids surface through blackbox dumps instead)
            return {"ok": True,
                    "trace": _tracing.get(str(req.get("id", "")))}
        return error_to_wire(
            ServingError("unknown method %r" % (method,)))

    def _predict(self, req):
        t0 = time.monotonic()
        tr = None
        if _tracing.ENABLED:
            # continue the client-minted trace (or mint a frontend one
            # for traceless callers): covers wire arrival -> batching
            # queue -> dispatch -> response
            tenv = req.get("trace") or {}
            tr = _tracing.start(tenv.get("id"), endpoint="predict",
                                t_client_send=tenv.get("t_send"))
        try:
            if self._batching is None:
                raise ServingError(
                    "this frontend serves no unary predictor")
            if self._closed:
                raise ServerClosedError("frontend is closed")
            wire_in = req.get("inputs")
            if isinstance(wire_in, dict):
                inputs = {k: decode_array(v)
                          for k, v in wire_in.items()}
            else:
                inputs = [decode_array(v) for v in wire_in]
            deadline_s = req.get("deadline_s")
            outs = self._batching.submit(
                inputs, deadline_s=deadline_s,
                trace_id=(tr.id if tr is not None else None)).result()
            resp = {"ok": True,
                    "outputs": [encode_array(np.asarray(o))
                                for o in outs]}
            if tr is not None:
                resp["trace_id"] = tr.id
        except Exception as exc:  # noqa: BLE001 - typed to the wire
            if tr is not None:
                _tracing.finish(tr, outcome=_outcome(exc))
            self._observe("predict", _outcome(exc), t0,
                          exemplar=(tr.id if tr is not None else None))
            return error_to_wire(exc)
        if tr is not None:
            _tracing.finish(tr, outcome="ok")
        self._observe("predict", "ok", t0,
                      exemplar=(tr.id if tr is not None else None))
        return resp

    def _generate(self, req, conn):
        """Streaming dispatch: a GENERATOR the substrate drains line by
        line, through ``_consume``; a failed write surfaces as
        ``GeneratorExit`` — every exit path funnels the stream into the
        worker's teardown."""
        t0 = time.monotonic()
        outcome = "error"
        stream = None
        tr = None
        if _tracing.ENABLED:
            # continue the client-minted trace (or mint one for
            # traceless callers). The root "request" span opened here
            # closes at finish — it covers the whole server-side
            # window, so span coverage vs client wall is the wire RTT
            # plus parse, not an instrumentation lottery
            tenv = req.get("trace") or {}
            tr = _tracing.start(tenv.get("id"), endpoint="generate",
                                t_client_send=tenv.get("t_send"))
        try:
            if self._decode is None:
                self._observe("generate", "error", t0)
                yield error_to_wire(ServingError(
                    "this frontend serves no decode session"))
                return
            if self._closed:
                # observed here: the finally only covers requests that
                # got a stream — and a drain-watching operator needs
                # exactly these post-close rejects in the per-outcome
                # split
                outcome = "closed"
                self._observe("generate", "closed", t0)
                yield error_to_wire(
                    ServerClosedError("frontend is closed"))
                return
            spec = {
                "src": decode_array(req["src"]),
                "src_len": (None if req.get("src_len") is None
                            else int(req["src_len"])),
                "n": int(req.get("n", 1)),
                "prefix": req.get("prefix_tokens"),
                "beam": bool(req.get("beam", False)),
                "len_penalty": (None if req.get("len_penalty") is None
                                else float(req["len_penalty"])),
            }
            if spec["beam"] and spec["n"] != 1:
                self._observe("generate", "error", t0)
                yield error_to_wire(ServingError(
                    "beam=true uses the session's beam_width; it does "
                    "not compose with n > 1 fork groups"))
                return
            if spec["len_penalty"] is not None and not spec["beam"]:
                self._observe("generate", "error", t0)
                yield error_to_wire(ServingError(
                    "len_penalty rescores a beam n-best; it needs "
                    "beam=true"))
                return
            spec["trace_id"] = tr.id if tr is not None else None
            stream = _Stream(spec)
            conn.state.setdefault("streams", set()).add(stream)
            with self._mu:
                self._active_streams += 1
            self._decode.submit(stream)
            outcome = yield from self._consume(stream, conn, tr=tr,
                                               t_ttft=t0)
        except GeneratorExit:
            # the substrate closed us: the client's socket died mid-
            # write — tear the generation down, return the capacity
            outcome = "disconnect"
            if stream is not None:
                self._decode.cancel(stream)
            raise
        finally:
            if stream is not None:
                streams = conn.state.get("streams")
                if streams is not None:
                    streams.discard(stream)
                with self._mu:
                    self._active_streams -= 1
                self._observe("generate", outcome, t0,
                              exemplar=(tr.id if tr is not None
                                        else None))
            if tr is not None:
                # every exit path lands here — cancel, disconnect and
                # error traces close their spans too (finish force-
                # closes stragglers), so the ring never holds a trace
                # with dangling open spans
                _tracing.finish(tr, outcome=outcome)

    def _consume(self, stream, conn, tr=None, t_ttft=None):
        """Relay a submitted stream's decode-worker messages to the wire
        until a terminal event; returns the outcome. The connection is
        polled for an in-band cancel or EOF when the stream idles and,
        on a busy stream, once a poll interval (the JAX package's
        handler polls only an idle stream, so a cancel there waits for a
        pause). ``t_ttft`` (a fresh generation's start) observes the
        time to its first token; a re-attach passes None."""
        first_token = t_ttft is None
        last_poll = time.monotonic()
        while True:
            try:
                msg = stream.q.get(timeout=self._poll)
            except queue.Empty:
                msg = None
            if msg is None or time.monotonic() - last_poll >= self._poll:
                last_poll = time.monotonic()
                verdict = self._poll_conn(conn)
                if verdict == "cancel":
                    self._decode.cancel(stream)
                    yield {"ok": True, "event": "cancelled"}
                    return "cancelled"
                if verdict == "eof":
                    self._decode.cancel(stream)
                    return "disconnect"
            if msg is None:
                continue
            if not msg.get("ok", False):
                yield msg
                return _outcome(error_from_wire(msg))
            if msg.get("event") in ("tokens", "beam") and not first_token:
                first_token = True
                if tr is not None:
                    tr.mark("first_token")
                _fe_ttft.observe(
                    time.monotonic() - t_ttft,
                    exemplar=(tr.id if tr is not None else None))
            if tr is not None and msg.get("event") in ("tokens", "beam"):
                # the span brackets the substrate's write+flush of
                # this chunk: t1 lands when the generator resumes
                sp = tr.begin("wire.flush",
                              tokens=len(msg.get("tokens", ())))
                yield msg
                tr.end(sp)
            else:
                yield msg
            if msg.get("event") == "end":
                return "ok"

    def _poll_conn(self, conn):
        """'cancel' when the client sent an in-band cancel line, 'eof'
        when it disconnected, None otherwise. Safe mid-stream: the
        protocol sends nothing else while a stream is in flight, so
        raw-socket readability means cancel or EOF."""
        try:
            readable, _, _ = select.select([conn.sock], [], [], 0)
        except (OSError, ValueError):
            return "eof"
        if not readable:
            return None
        try:
            peek = conn.sock.recv(4096, socket.MSG_PEEK)
        except OSError:
            return "eof"
        if not peek:
            return "eof"
        if b"\n" not in peek:
            # a partial line (fragmented cancel, or a stalled client
            # trickling bytes): readline would BLOCK the handler
            # thread with no timeout — keep streaming and poll again
            return None
        try:
            line = conn.rfile.readline()
        except OSError:
            return "eof"
        if not line:
            return "eof"
        try:
            msg = json.loads(line)
        except ValueError:
            return "eof"
        if msg.get("method") == "cancel":
            return "cancel"
        return None  # pipelined mid-stream request: protocol misuse,
        #              ignored (the line is consumed)

    def _take_result(self, req):
        t0 = time.monotonic()
        try:
            if self._session is None:
                raise ServingError(
                    "this frontend serves no decode session")
            rid = int(req.get("id", -1))
            # the trace id must be read BEFORE the claim: take_result
            # retires the session's rid->trace binding with the row
            tid = self._session._trace_ids.get(rid)
            tokens = self._session.take_result(rid)
            resp = {"ok": True,
                    "tokens": (None if tokens is None
                               else encode_array(np.asarray(tokens)))}
            if tokens is not None and tid:
                resp["trace_id"] = tid
            if tokens is None:
                # the id may name a banked beam n-best (the claim id of
                # the beam's 'admitted' event): a beam whose stream died
                # finishes into the beam bank, claimable here
                beam = self._session.take_beam_result(rid)
                if beam is not None:
                    resp = {"ok": True,
                            "tokens": encode_array(
                                np.asarray(beam["tokens"])),
                            "scores": encode_array(
                                np.asarray(beam["scores"]))}
        except Exception as exc:  # noqa: BLE001 - typed to the wire
            self._observe("take_result", _outcome(exc), t0)
            return error_to_wire(exc)
        self._observe("take_result", "ok", t0)
        return resp

    # -- migration endpoints -------------------------------------------------

    def _attach(self, req, conn):
        """Streaming re-attach to an existing solo request by rid — the
        router's failover/drain splice endpoint. The first event is
        ``resumed`` replaying the request's tokens from absolute
        position 1; after that the stream behaves exactly like
        ``generate`` (the same consume loop, cancel/EOF polling and
        teardown discipline)."""
        t0 = time.monotonic()
        outcome = "error"
        stream = None
        try:
            if self._decode is None:
                self._observe("attach", "error", t0)
                yield error_to_wire(ServingError(
                    "this frontend serves no decode session"))
                return
            if self._closed:
                outcome = "closed"
                self._observe("attach", "closed", t0)
                yield error_to_wire(
                    ServerClosedError("frontend is closed"))
                return
            spec = {"attach": int(req["id"]), "n": 1, "prefix": None,
                    "beam": False, "trace_id": None}
            stream = _Stream(spec)
            conn.state.setdefault("streams", set()).add(stream)
            with self._mu:
                self._active_streams += 1
            self._decode.submit(stream)
            outcome = yield from self._consume(stream, conn)
        except GeneratorExit:
            outcome = "disconnect"
            if stream is not None:
                self._decode.cancel(stream)
            raise
        finally:
            if stream is not None:
                streams = conn.state.get("streams")
                if streams is not None:
                    streams.discard(stream)
                with self._mu:
                    self._active_streams -= 1
                self._observe("attach", outcome, t0)

    def _snapshot(self, req):
        """Quiesced synchronous snapshot with the payload returned ON
        THE WIRE (base64 per file): the router's planned-drain path
        ships it to the target frontend's ``restore``. Executes on the
        decode worker between dispatches — never mid-dispatch."""
        t0 = time.monotonic()
        try:
            if self._snap_mgr is None or self._decode is None:
                raise ServingError(
                    "this frontend has no snapshot manager")
            path = self._decode.call(self._snap_mgr.save)
            files = {}
            for name in sorted(os.listdir(path)):
                with open(os.path.join(path, name), "rb") as f:
                    files[name] = base64.b64encode(
                        f.read()).decode("ascii")
            resp = {"ok": True, "dir": os.path.basename(path),
                    "files": files}
        except Exception as exc:  # noqa: BLE001 - typed to the wire
            self._observe("snapshot", _outcome(exc), t0)
            return error_to_wire(exc)
        self._observe("snapshot", "ok", t0)
        return resp

    def _restore(self, req):
        """Install a SHIPPED snapshot payload into this frontend's
        session — the migration landing. Refuses unless the session is
        fully quiesced (no live slots, no backlog, no tracked streams):
        a restore is a whole-session replace, and landing one on live
        work would destroy it AND break the (seed, slot, position)
        sampling keys migrated streams rely on for bit-exactness. The
        typed ``MigrationBusyError`` is transient BY TYPE, so the
        router's classified retry simply re-asks after the target
        drains."""
        t0 = time.monotonic()
        try:
            mgr = self._snap_mgr
            if mgr is None or self._decode is None:
                raise ServingError(
                    "this frontend has no snapshot manager")
            dirname = os.path.basename(str(req.get("dir", "")))
            if not dirname.startswith("checkpoint_"):
                raise ServingError(
                    "restore needs a checkpoint_<serial> dir name")
            serial = int(dirname.rsplit("_", 1)[-1])
            files = req.get("files") or {}

            def _install():
                w = self._decode
                s = self._session
                if (w._slot_stream or w._beam_stream or w._rid_stream
                        or s.active_slots or s.pending_requests):
                    raise MigrationBusyError(
                        "restore target is not quiesced (live slots, "
                        "backlog or tracked streams present) — drain "
                        "first, then re-ask")
                # join the in-flight async snapshot writer first: this
                # frontend's own periodic save may still be writing a
                # checkpoint whose step-derived serial COLLIDES with
                # the shipped one (two members working the same load
                # reach the same step counts), and installing into the
                # directory it is writing tears both
                mgr.wait()
                step_dir = os.path.join(mgr.checkpoint_dir, dirname)
                if os.path.isdir(step_dir):
                    shutil.rmtree(step_dir)
                os.makedirs(step_dir)
                for name, b64 in files.items():
                    fname = os.path.basename(str(name))
                    with open(os.path.join(step_dir, fname), "wb") as f:
                        f.write(base64.b64decode(b64))
                manifest = mgr.restore(serial=serial)
                if manifest is None:
                    raise ServingError(
                        "shipped snapshot %s failed verification"
                        % dirname)
                return {"ok": True, "serial": int(serial),
                        "live": sorted(int(r)
                                       for r in s._owner.values()),
                        "pending": [int(r)
                                    for r in s.pending_requests],
                        "banked": sorted(int(r) for r in s._results)}

            resp = self._decode.call(_install, timeout=120.0)
        except Exception as exc:  # noqa: BLE001 - typed to the wire
            self._observe("restore", _outcome(exc), t0)
            return error_to_wire(exc)
        self._observe("restore", "ok", t0)
        return resp

    def _health(self):
        out = {}
        if self._batching is not None:
            monitor = self._batching._monitor
            out["server"] = (monitor.state if monitor is not None
                             else "healthy")
        if self._session is not None:
            out["decode"] = self._session.health
        return out

    # -- introspection -------------------------------------------------------

    def stats(self):
        self._sync_io()
        with self._mu:
            by_endpoint = {}
            for (endpoint, outcome), n in sorted(self._counts.items()):
                by_endpoint.setdefault(endpoint, {})[outcome] = n
            out = {
                "requests": by_endpoint,
                "active_connections": self._conns,
                "active_streams": self._active_streams,
                "bytes_sent": self._io_seen[0],
                "bytes_received": self._io_seen[1],
                "closed": self._closed,
            }
        if self._session is not None:
            # the decode-plane view: pool conservation after every
            # teardown and the prefix-cache hit rate. Reads of the
            # session from this (handler) thread are racy-by-design
            # snapshots: the numbers are advisory.
            s = self._session
            out["decode"] = {
                "active_slots": len(s.active_slots),
                "pending": len(s.pending_requests),
                "free_slots": int(s.free_slots),
                "results_banked": len(s._results),
                "pool_conserved": bool(s.pool_conserved),
                "health": s.health,
                "prefix": s.prefix_cache_stats(),
            }
        return out

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain=True, timeout=60.0):
        """Stop serving. ``drain=True`` finishes queued + in-flight
        generations (and lets their tails reach the sockets) before
        severing connections; ``drain=False`` cancels live streams and
        fails queued work with ``ServerClosedError``. Does NOT close
        the BatchingServer or the decode session — the frontend is a
        transport layer; its backends outlive it."""
        with self._mu:
            if self._closed and self._json_server is None:
                return
            self._closed = True
        if self._decode is not None:
            self._decode.stop(drain=drain, timeout=timeout)
        if drain:
            # let handler threads flush terminal events before the
            # connections are severed
            deadline = time.monotonic() + min(5.0, timeout)
            while time.monotonic() < deadline:
                with self._mu:
                    if not self._active_streams:
                        break
                time.sleep(0.01)
        self._sync_io()
        srv, self._json_server = self._json_server, None
        close_json_server(srv)
        self._uninstall_signal_handlers()

    # -- preemption plumbing -------------------------------------------------

    def _install_signal_handlers(self):
        if threading.current_thread() is not threading.main_thread():
            return
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._signal_handler)
            except (ValueError, OSError):
                pass

    def _uninstall_signal_handlers(self):
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError, TypeError):
                pass
        self._prev_handlers = {}

    def _signal_handler(self, signum, frame):
        """Stop the transport, then CHAIN to the previously installed
        handler, or die by the signal when there was none."""
        # NO lock from signal context: the handler may have interrupted
        # main-thread code HOLDING self._mu (stats()/close()), and a
        # non-reentrant acquire here would deadlock the process. A bare
        # attribute store is GIL-atomic.
        self._closed = True
        srv = self._json_server
        if srv is not None:
            # shutdown + listener close only: severing live connections
            # takes the connection mutex, which is not safe from signal
            # context; established clients see EOF when the process
            # dies
            try:
                srv.shutdown()
                srv.server_close()
            except OSError:
                pass
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
        else:
            # no chained handler: restore the default disposition and
            # die by the signal (the TrainSession discipline)
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()
        return False
