"""ServingClient: the wire side of the network serving plane.

Counterpart of ``paddle_tpu/serving/client.py`` (a copy; the wire bytes
and error classes are the JAX package's, so either package's client
drives either package's frontend). ``frontend.ServingFrontend`` puts the serving stack behind a socket;
this is the client that talks to it, built on the same JSON-lines
substrate every control-plane service in the repo shares
(``distributed.master.JsonLineClient``) and mirroring ``FleetClient``'s
posture: one persistent connection, reconnect-and-retry across a
frontend restart, classified retry with backoff for transient failures.

Contract points:

* **Typed errors round-trip.** A frontend reject serializes as a wire
  error carrying its exception TYPE (and, for ``DegradedError``, the
  ``retry_after_s``/``state`` payload); this client re-raises the SAME
  exception classes the in-process server would — ``QueueFullError``,
  ``DeadlineExceededError``, ``DegradedError`` (still
  ``retry.TransientError``, so classified retry loops back off —
  honoring the server's retry-after hint — and re-ask), ``NoFreeSlot/
  Page/GroupError``... Code written against ``BatchingServer`` /
  ``SlotDecodeSession`` keeps its except clauses over the wire.
* **Bit-exact arrays.** Feeds and fetches travel as base64-encoded raw
  buffers with dtype+shape (:func:`encode_array`), so a remote
  ``predict`` is byte-for-byte the in-process result — including NaN
  payloads JSON floats would mangle.
* **Streaming decode.** :meth:`ServingClient.generate` yields token
  chunks AS THE FRONTEND FLUSHES THEM (one event per decode dispatch),
  not at end-of-stream; abandoning the generator sends an in-band
  cancel so the frontend tears the generation down and returns its
  slot/pages. A connection severed BEFORE the stream began (no event
  consumed yet) is retried (the frontend's disconnect reclamation
  makes re-admission safe); severed any later, it surfaces a typed
  :class:`StreamBrokenError` — never a silent re-decode that could
  splice two divergent streams, and never a hang (socket timeout +
  the watchdog armed around every blocking read).

The beam grammar (``generate(beam=True)``, :meth:`generate_beam`) and
``resume=True`` are kept for the wire, but the port's frontend refuses
beam requests (ROADMAP.md A7) and answers ``attach`` with a typed error
(A8's second half); a JAX package frontend serves both.
"""

import base64
import time

import numpy as np

from paddle_tpu_torch.distributed.master import (
    AuthError,
    JsonLineClient,
    _parse_addr,
)
from paddle_tpu_torch.observability import tracing as _tracing
from paddle_tpu_torch.observability import watchdog as _watchdog
from paddle_tpu_torch.resilience.retry import TransientError
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
    WaitTimeoutError,
)

__all__ = [
    "ServingClient", "StreamBrokenError", "RedirectError",
    "MigrationBusyError", "AuthError",
    "encode_array", "decode_array", "error_to_wire", "error_from_wire",
]


class StreamBrokenError(ServingError):
    """The connection died after the stream began. The
    frontend's disconnect hook has torn the generation down (slot and
    pages reclaimed); re-issue the request — the client will NOT retry
    it silently, because a fresh generation under a stochastic sampler
    is a different stream and splicing the two would corrupt the
    caller's sequence. (The ONE sanctioned exception is the (rid, seq)
    resume splice: when the server side migrated the live session —
    identical (seed, slot, position) sampling keys, so the re-driven
    tokens are bit-identical — ``generate(..., resume=True)`` re-attaches
    and splices by absolute sequence position instead of raising.)"""


class RedirectError(ServingError):
    """The service answering is not the one that should: the typed
    redirect carries the address to re-ask (a drained frontend pointing
    at the router, a router replica pointing at the leader). The client
    follows it once per request — a redirect loop surfaces the second
    redirect as the error it is."""

    def __init__(self, message="", addr=None):
        super(RedirectError, self).__init__(message)
        self.addr = addr


class MigrationBusyError(ServingError, TransientError):
    """A migration target refused a restore/admission because it is
    still draining its own in-flight work (restores land only on a
    quiesced session). Transient BY TYPE: the classified retry shell
    backs off and re-asks — by then the target has drained."""


def encode_array(arr):
    """Wire form of one ndarray: raw buffer base64 + dtype + shape —
    bit-exact (JSON floats round-trip, but raw bytes don't even have
    to argue about NaN payloads) and cheap to decode."""
    arr = np.asarray(arr)
    # shape before ascontiguousarray: it promotes 0-d to 1-d
    shape = list(arr.shape)
    raw = np.ascontiguousarray(arr).tobytes()
    return {"dtype": str(arr.dtype), "shape": shape,
            "b64": base64.b64encode(raw).decode("ascii")}


def decode_array(obj):
    """Inverse of :func:`encode_array`; returns a WRITABLE host array
    (frombuffer views are read-only, and callers slice/assign)."""
    flat = np.frombuffer(base64.b64decode(obj["b64"]),
                         dtype=np.dtype(str(obj["dtype"])))
    return flat.reshape([int(d) for d in obj["shape"]]).copy()


#: wire ``etype`` -> exception class; the client re-raises these VERBATIM
#: so except clauses written against the in-process server keep working
_WIRE_ERRORS = {
    cls.__name__: cls for cls in (
        ServingError, QueueFullError, DeadlineExceededError,
        ServerClosedError, WaitTimeoutError, NoFreeSlotError,
        NoFreePageError, NoFreeGroupError, StreamBrokenError,
        MigrationBusyError, AuthError,
    )
}


def error_to_wire(exc):
    """Serialize a serving exception as a typed wire error message."""
    wire = {"ok": False, "error": str(exc), "etype": type(exc).__name__}
    if isinstance(exc, DegradedError):
        wire["retry_after_s"] = exc.retry_after_s
        wire["state"] = exc.state
    if isinstance(exc, RedirectError):
        wire["addr"] = exc.addr
    return wire


def error_from_wire(msg):
    """Rebuild the typed exception a wire error message carries;
    unknown types degrade to :class:`ServingError` with the type name
    preserved in the text."""
    etype = msg.get("etype")
    text = msg.get("error", "frontend error")
    if etype == "DegradedError":
        return DegradedError(
            text, state=msg.get("state", "brownout"),
            retry_after_s=float(msg.get("retry_after_s", 0.05)))
    if etype == "RedirectError":
        return RedirectError(text, addr=msg.get("addr"))
    cls = _WIRE_ERRORS.get(etype)
    if cls is not None:
        return cls(text)
    return ServingError("%s: %s" % (etype, text) if etype else text)


class ServingClient(JsonLineClient):
    """Client for one :class:`serving.frontend.ServingFrontend`.

    ``addr``: ``(host, port)`` or ``"host:port"``. ``timeout_s`` bounds
    every blocking socket read (a dead frontend surfaces as a transient
    ``socket.timeout``, never a wedge). Retries follow the resilience
    policy (``FLAGS_dispatch_retries`` budget; 0 = surface the first
    typed failure — the mode the overload tests assert typed
    ``DegradedError`` under).
    """

    origin = "ServingClient._call"

    #: trace id of the most recent traced request this client minted
    #: (``FLAGS_request_tracing`` on); resolve it against the frontend
    #: with :meth:`trace` after the response/stream completes
    last_trace_id = None

    # -- transport shell -----------------------------------------------------

    def _trace_context(self, req):
        """Mint the request-scoped trace envelope
        (observability/tracing.py): ``{"id", "t_send"}`` riding the
        JSON line, so the frontend can continue the trace and account
        the wire+queue time against the CLIENT-observed clock. Only
        request-shaped methods trace; with tracing off this returns
        None and the wire bytes are identical to untracing builds."""
        if not _tracing.ENABLED:
            return None
        if req.get("method") not in ("predict", "generate"):
            return None
        self.last_trace_id = _tracing.mint_id()
        return {"id": self.last_trace_id, "t_send": time.time()}

    def _recv_line(self):
        # every blocking read wears the watchdog (on top of the socket
        # timeout): a frontend that stops answering produces thread
        # stacks + a black-box dump, not a silently stuck client
        token = _watchdog.arm("net.recv") if _watchdog.ENABLED else None
        try:
            return super(ServingClient, self)._recv_line()
        except ValueError as exc:
            # a torn frame (frontend killed mid-write leaves a partial
            # JSON line): surface as the CONNECTION failure it is —
            # transient for the classified-retry shell, StreamBroken
            # for an in-flight stream — never a raw decode error
            self.close()
            raise ConnectionError(
                "ServingClient: torn frame from the frontend "
                "(killed mid-write?): %s" % (exc,))
        finally:
            if token is not None:
                _watchdog.disarm(token)

    def _request(self, **req):
        """One RPC (reconnect-retry-once inherited); wire errors come
        back as their original typed exceptions. A typed
        :class:`RedirectError` is followed ONCE: the client re-targets
        the carried address (a drained frontend pointing at the router)
        and re-asks; a second redirect surfaces as the error."""
        resp = self._call(**req)
        if not resp.get("ok", False):
            err = error_from_wire(resp)
            if isinstance(err, RedirectError) and err.addr:
                self._follow(err.addr)
                resp = self._call(**req)
                if not resp.get("ok", False):
                    raise error_from_wire(resp)
                return resp
            raise err
        return resp

    def _follow(self, addr):
        """Re-target this client at ``addr`` (redirect/failover): the
        address joins the rotation and becomes current."""
        self.close()
        parsed = _parse_addr(addr)
        if parsed not in self._addrs:
            self._addrs.append(parsed)
        self._addr_i = self._addrs.index(parsed)

    def _retrying(self, fn, origin):
        """The classified-retry shell (``resilience.retry``): transient
        failures — connection drops across a frontend restart, injected
        net faults, and ``DegradedError`` (retriable BY TYPE) — back
        off and re-ask; a shed frontend's ``retry_after_s`` hint is
        honored before the classified backoff re-asks."""
        from paddle_tpu_torch.resilience import retry as _retry

        def attempt():
            try:
                return fn()
            except DegradedError as exc:
                if exc.retry_after_s > 0 and _retry.retries_enabled():
                    time.sleep(exc.retry_after_s)
                raise

        return _retry.call(attempt, origin=origin)

    # -- unary ---------------------------------------------------------------

    def predict(self, inputs, deadline_s=None):
        """Remote ``BatchingServer`` round trip: ``inputs`` is a dict
        (feed name -> array) or a list in feed order; returns the fetch
        list as numpy arrays, bit-identical to the in-process server's.
        ``deadline_s`` rides the wire and maps to the server's typed
        admission errors (``DeadlineExceededError`` et al.)."""
        if isinstance(inputs, dict):
            wire_in = {str(k): encode_array(np.asarray(v))
                       for k, v in inputs.items()}
        else:
            wire_in = [encode_array(np.asarray(v)) for v in inputs]

        def once():
            resp = self._request(
                method="predict", inputs=wire_in,
                deadline_s=(None if deadline_s is None
                            else float(deadline_s)))
            return [decode_array(o) for o in resp["outputs"]]

        return self._retrying(once, origin="ServingClient.predict")

    def run(self, inputs, deadline_s=None):
        """``BatchingServer.run``-shaped alias of :meth:`predict`, so
        the deterministic load generator (``serving/loadgen.py``)
        drives an in-process server and a wire client through ONE code
        path."""
        return self.predict(inputs, deadline_s=deadline_s)

    # -- streaming decode ----------------------------------------------------

    def generate(self, src, src_len=None, n=1, prefix_tokens=None,
                 beam=False, len_penalty=None, resume=False):
        """Stream one generation (``n > 1``: a best-of-N fork group via
        the session's ``admit_group``; ``prefix_tokens``: forced prefix
        riding the prefix cache). Returns a GENERATOR of event dicts,
        in wire order:

        * ``{"event": "queued", "id": rid}`` — the request entered the
          session's persistent backlog (EVERY solo request does, even
          with free capacity — admission usually follows in the same
          scheduler pass; the id survives a frontend preemption, see
          ``take_result``)
        * ``{"event": "admitted", "members", "prefix", "pos",
          "max_length", "eos"}``
        * ``{"event": "tokens", "member", "tokens"}`` — the NEW int64
          tokens one decode dispatch appended for one member
        * ``{"event": "end"}`` / ``{"event": "cancelled"}`` — terminal

        ``beam=True`` (a session built with ``beam_width=K``) streams
        the BEAM grammar instead: ``admitted`` carries ``beam``/
        ``beam_width``/``id`` (the banked-result claim id), then one
        ``{"event": "beam", "parents", "tokens", "scores", "done"}``
        survivor chunk per decode dispatch (the parent permutation the
        zero-copy reorder executed, with each survivor's selected token
        and accumulated score), and a final ``{"event": "beam_end",
        "tokens" [K x T], "scores" [K]}`` n-best before ``end``.
        ``len_penalty`` (beam only) asks the frontend to rescore that
        final n-best with the GNMT length penalty: ``beam_end`` comes
        back reordered score-descending under the PENALIZED scores and
        gains ``order`` (the permutation of raw hypothesis indices) +
        the echoed ``len_penalty``.

        Closing the generator before the terminal event sends an
        in-band cancel (the frontend tears the generation down and
        reclaims its slot/pages). Admission rejects raise typed errors
        at CALL time; a connection severed before the first event is
        retried under the classified policy, any later it raises
        :class:`StreamBrokenError`.

        ``resume=True`` (solo streams only): a sever after the stream
        began does NOT raise — the client reconnects (rotating through
        its configured addresses) and re-attaches by request id, then
        SPLICES by the (rid, seq) the token chunks carry: events whose
        absolute sequence positions were already delivered are trimmed,
        so the caller sees no duplicated and no dropped tokens. This is
        only sound against a server side that migrated/restored the
        SAME generation (identical (seed, slot, position) sampling
        keys — the router tier's contract); when re-attachment fails
        the usual :class:`StreamBrokenError` surfaces."""
        req = {"method": "generate",
               "src": encode_array(
                   np.asarray(src, dtype="int64")),
               "n": int(n)}
        if beam:
            req["beam"] = True
        if len_penalty is not None:
            req["len_penalty"] = float(len_penalty)
        if src_len is not None:
            req["src_len"] = int(np.ravel(src_len)[0])
        if prefix_tokens is not None:
            req["prefix_tokens"] = [int(t) for t in prefix_tokens]
        # generate streams outside _call's request/response shell, so
        # the trace envelope attaches here; a retried open re-sends the
        # SAME id — one logical request, one trace
        ctx = self._trace_context(req)
        if ctx is not None:
            req["trace"] = ctx

        def opened():
            # the open is retry-safe: until the first message lands, a
            # severed attempt's admission (if it happened at all) is
            # reclaimed by the frontend's disconnect hook
            self._send_line(req)
            first = self._recv_line()
            if not first.get("ok", False):
                raise error_from_wire(first)
            return first

        first = self._retrying(opened, origin="ServingClient.generate")
        # the address the stream was BORN on: a bare (per-frontend)
        # rid re-attached through a router needs it to name the
        # namespace the rid was minted in (router handles are
        # composite "wid:rid" strings and self-describe)
        born_on = "%s:%d" % self._addr
        return self._stream_events(first, resume=bool(resume),
                                   origin=born_on)

    def _reattach(self, rid, origin=None):
        """Resume plumbing: reconnect (rotating addresses) and re-open
        the stream for ``rid`` via the frontend/router ``attach``
        endpoint. ``origin`` (the address the stream was born on)
        rides along so a router can resolve a bare rid to the ONE
        member that minted it. Returns the first event of the
        re-driven stream."""

        def opened():
            self.close()  # force a fresh connect (rotates on failure)
            req = {"method": "attach", "id": rid}
            if origin:
                req["origin"] = origin
            self._send_line(req)
            first = self._recv_line()
            if not first.get("ok", False):
                raise error_from_wire(first)
            return first

        return self._retrying(opened, origin="ServingClient.attach")

    def _stream_events(self, first, resume=False, origin=None):
        finished = False
        rid = None        # solo request id (the resume handle)
        next_seq = None   # next absolute trg position not yet delivered
        admitted = False
        try:
            msg = first
            while True:
                if not msg.get("ok", False):
                    raise error_from_wire(msg)
                ev = dict(msg)
                ev.pop("ok", None)
                kind = ev.get("event")
                if kind == "queued" and ev.get("id") is not None:
                    # opaque resume handle: an int from a frontend, a
                    # composite "wid:rid" string from a router —
                    # passed back VERBATIM on attach/take_result
                    rid = ev["id"]
                if kind == "admitted":
                    if admitted:
                        # a re-driven backlog re-admission: the caller
                        # already saw its admission — swallow
                        msg = self._recv_line()
                        continue
                    admitted = True
                    if ev.get("beam") is None:
                        next_seq = int(ev["pos"]) + 1
                if kind in ("tokens", "resumed") and (
                        rid is not None
                        and ev.get("seq") is not None
                        and (next_seq is not None or kind == "resumed")):
                    # splice by absolute position: trim what was
                    # already delivered (a resumed stream replays from
                    # its snapshot), refuse gaps (lost tokens)
                    seq = int(ev["seq"])
                    if next_seq is None:
                        # resumed before any admission was seen (the
                        # request was restored as LIVE elsewhere): the
                        # replay itself is the basis — deliver it all
                        next_seq = seq
                    toks = [int(t) for t in ev.get("tokens") or ()]
                    if seq > next_seq:
                        raise StreamBrokenError(
                            "stream resumed with a token gap (expected "
                            "position %d, got %d)" % (next_seq, seq))
                    keep = toks[next_seq - seq:]
                    if kind == "resumed" or not keep:
                        if keep:
                            next_seq += len(keep)
                            yield {"event": "tokens",
                                   "member": int(ev.get("member", 0)),
                                   "tokens": np.asarray(keep,
                                                        dtype="int64")}
                        msg = self._recv_line()
                        continue
                    next_seq += len(keep)
                    ev["tokens"] = keep
                if kind == "tokens":
                    ev["tokens"] = np.asarray(
                        [int(t) for t in ev["tokens"]], dtype="int64")
                if kind in ("end", "cancelled"):
                    finished = True
                yield ev
                if finished:
                    return
                try:
                    msg = self._recv_line()
                except (ConnectionError, EOFError, OSError) as exc:
                    if resume and rid is not None:
                        # the router/frontend contract: the same
                        # generation was migrated and re-driven —
                        # re-attach and splice instead of raising
                        try:
                            msg = self._reattach(rid, origin=origin)
                        except Exception as exc2:  # noqa: BLE001
                            finished = True
                            raise StreamBrokenError(
                                "stream severed and re-attach failed "
                                "(%s after %s)" % (exc2, exc))
                        continue
                    finished = True  # the connection is gone: no cancel
                    # the retry unit is the OPEN (before any event was
                    # consumed); once the stream began, every sever is
                    # the same typed break — the caller has already
                    # consumed events a silent re-admission could not
                    # replay consistently
                    raise StreamBrokenError(
                        "connection severed after the stream began "
                        "(%s); the frontend reclaims the generation — "
                        "re-issue the request" % (exc,))
        finally:
            if not finished:
                # the consumer abandoned the stream: cancel in-band so
                # the frontend frees the slot/pages NOW, keeping the
                # connection reusable; failing that, drop the
                # connection (the frontend's close hook reclaims)
                self._cancel_stream()

    def _cancel_stream(self):
        if self._sock is None:
            # the connection is already gone (caller close()d it, or a
            # read error dropped it): there is nothing to cancel on —
            # the frontend's close callback reclaims the stream, and
            # reconnecting here would only leak a fresh socket to send
            # a cancel no stream can match
            return
        # the frontend answers every cancel line EXACTLY once: either
        # the in-flight stream's handler consumes it (terminal
        # ``cancelled`` event) or — when the stream ended first — the
        # substrate answers it as an idle cancel ack (also event
        # ``cancelled``). Draining until that event resynchronizes the
        # connection whatever the race resolved to; stream events
        # produced before the cancel landed are skipped on the floor.
        try:
            self._send_line({"method": "cancel"})
            deadline = time.monotonic() + self._timeout_s
            while time.monotonic() < deadline:
                # ONLY the cancelled event ends the drain: a terminal
                # stream ERROR line racing the cancel still leaves the
                # frontend's cancel ack in flight — stopping early
                # would leave it buffered and desynchronize the next
                # RPC on this connection
                if self._recv_line().get("event") == "cancelled":
                    return
        except Exception:  # noqa: BLE001 - fall through to the hard drop
            pass
        self.close()

    def generate_full(self, src, src_len=None, n=1, prefix_tokens=None,
                      on_event=None, resume=False):
        """Convenience: consume the whole stream and return the
        ``[n, max_length]`` int64 token matrix in member order —
        bos-led, eos-padded, bit-identical to the in-process
        ``SlotDecodeSession.generate`` / ``generate_best_of`` rows
        (reassembled from the incremental chunks, so the streaming
        framing itself is covered by every parity assertion).
        ``on_event`` (optional) sees every raw stream event before it
        is folded in — the hook the smoke/bench use to time the first
        token without re-implementing the reassembly."""
        rows = fill = None
        for ev in self.generate(src, src_len=src_len, n=n,
                                prefix_tokens=prefix_tokens,
                                resume=resume):
            if on_event is not None:
                on_event(ev)
            kind = ev.get("event")
            if kind == "admitted":
                members = int(ev["members"])
                length = int(ev["max_length"])
                prefix = [int(t) for t in ev["prefix"]]
                rows = np.full((members, length), int(ev["eos"]),
                               dtype="int64")
                rows[:, :len(prefix)] = prefix
                fill = [len(prefix)] * members
            elif kind == "tokens":
                m = int(ev.get("member", 0))
                toks = ev["tokens"]
                rows[m, fill[m]:fill[m] + len(toks)] = toks
                fill[m] += len(toks)
        if rows is None:
            raise ServingError("stream ended without an admission")
        return rows

    def generate_beam(self, src, src_len=None, prefix_tokens=None,
                      on_event=None, len_penalty=None):
        """Consume one whole beam stream and return ``(tokens [K, T]
        int64, scores [K] float32)`` in score-descending hypothesis
        order — bit-identical to the in-process
        ``SlotDecodeSession.generate_beam`` (including a requested
        ``len_penalty``: the frontend rescores the final n-best with
        the GNMT length penalty and returns PENALIZED scores). The
        incremental ``beam`` survivor chunks are REPLAYED client-side
        (each survivor adopts its parent's row and appends its token —
        the same reorder the server executed as table rebinds) and
        cross-checked against the final ``beam_end`` n-best (through
        the server's ``order`` permutation when it rescored), so a
        framing bug in the chunk stream can never pass silently.
        ``on_event`` sees every raw event."""
        rows = fill = prev_done = None
        final = None
        order = None
        for ev in self.generate(src, src_len=src_len,
                                prefix_tokens=prefix_tokens, beam=True,
                                len_penalty=len_penalty):
            if on_event is not None:
                on_event(ev)
            kind = ev.get("event")
            if kind == "admitted":
                K = int(ev["beam_width"])
                length = int(ev["max_length"])
                prefix = [int(t) for t in ev["prefix"]]
                rows = np.full((K, length), int(ev["eos"]),
                               dtype="int64")
                rows[:, :len(prefix)] = prefix
                fill = [len(prefix) - 1] * K
                prev_done = [False] * K
            elif kind == "beam":
                parents = [int(p) for p in ev["parents"]]
                toks = [int(t) for t in ev["tokens"]]
                nrows = np.empty_like(rows)
                nfill, ndone = [], []
                for k, p in enumerate(parents):
                    nrows[k] = rows[p]
                    if prev_done[p]:
                        nfill.append(fill[p])
                        ndone.append(True)
                    else:
                        pos = min(fill[p] + 1, rows.shape[1] - 1)
                        nrows[k, pos] = toks[k]
                        nfill.append(pos)
                        ndone.append(bool(ev["done"][k]))
                rows, fill, prev_done = nrows, nfill, ndone
            elif kind == "beam_end":
                final = (np.asarray(ev["tokens"], dtype="int64"),
                         np.asarray(ev["scores"], dtype="float32"))
                if ev.get("order") is not None:
                    order = [int(i) for i in ev["order"]]
        if final is None:
            raise ServingError("beam stream ended without a beam_end")
        if rows is not None:
            # a rescored beam_end is the RAW n-best permuted by
            # ``order``; realign the replay before the framing check
            replay = rows[order] if order is not None else rows
            if not np.array_equal(replay, final[0]):
                raise ServingError(
                    "beam survivor chunks replay to a different "
                    "n-best than the server's beam_end — torn stream "
                    "framing")
        return final

    def take_result(self, request_id):
        """Claim a banked result by request id (requests a
        preempted-and-restored frontend finished headless land in the
        session's result bank): a solo id yields its ``[T]`` token
        row; a BEAM claim id (from the beam ``admitted`` event) yields
        ``(tokens [K, T], scores [K])`` — the n-best of a beam whose
        stream died before ``beam_end``. None if unknown/unfinished.
        The id is passed VERBATIM: a frontend's ids are ints, a
        router's are composite ``"wid:rid"`` strings (the router
        resolves them to the minting member)."""
        rid = (request_id if isinstance(request_id, str)
               else int(request_id))

        def once():
            resp = self._request(method="take_result", id=rid)
            tokens = resp.get("tokens")
            if tokens is None:
                return None
            if resp.get("scores") is not None:
                return (decode_array(tokens),
                        decode_array(resp["scores"]))
            return decode_array(tokens)

        return self._retrying(once, origin="ServingClient.take_result")

    # -- observability -------------------------------------------------------

    def trace(self, trace_id=None):
        """Fetch one COMPLETED trace record from the frontend's
        bounded ring (default: this client's most recent minted id —
        ``last_trace_id``). Returns the record dict (spans + derived
        stats, the same shape ``<metrics_path>.traces.jsonl`` carries)
        or None when the id is unknown/aged out/still in flight."""
        tid = trace_id if trace_id is not None else self.last_trace_id
        if tid is None:
            return None

        def once():
            return self._request(method="trace",
                                 id=str(tid)).get("trace")

        return self._retrying(once, origin="ServingClient.trace")

    def metrics(self):
        """The frontend process's Prometheus scrape text — the remote
        twin of ``REGISTRY.to_prometheus()`` (what the CI net stage
        greps its 0-fresh-compiles gate from)."""
        return self._request(method="metrics")["text"]

    def health(self):
        """Degradation state per component, e.g. ``{"server":
        "healthy", "decode": "brownout"}`` (``HealthMonitor`` states)."""
        return self._request(method="health")["health"]

    def stats(self):
        """Frontend counter snapshot (requests by endpoint/outcome,
        active connections, stream/byte counters)."""
        return self._request(method="stats")["stats"]
