"""Elastic data-dispatch master and the JSON-lines wire substrate.

Counterpart of ``paddle_tpu/distributed/master.py`` (a copy; go/master
parity: leased tasks, timeout requeue, failure discard, pass management,
crash-recoverable snapshots). The serving plane runs on its transport:
``serve_json_lines`` (a threading TCP endpoint speaking newline-delimited
JSON, with streaming responses, per-connection callbacks, ``pass_conn``,
optional TLS and bearer auth, the ``net.accept`` / ``net.send`` chaos
sites), ``close_json_server`` and ``JsonLineClient``. The wire bytes are
the JAX package's, so a client of either package talks to a server of
the other.
"""

import json
import os
import socket
import socketserver
import threading
import time

from paddle_tpu_torch.observability import lock_witness

__all__ = [
    "Task", "MasterService", "MasterClient", "task_reader",
    "serve_json_lines", "close_json_server", "JsonConn",
    "JsonLineClient", "ThrottledSnapshot", "AuthError",
]


class AuthError(ValueError):
    """Bad or missing bearer token on an authenticated JSON-lines
    endpoint. A ``ValueError`` subclass on purpose: the resilience
    classifier treats ValueError as permanent, so no retry shell in the
    repo will ever spin on a credential failure — the caller fixes its
    token or stays out."""


# ---------------------------------------------------------------------------
# shared transport + snapshot substrate (also used by elastic/coordinator.py)
# ---------------------------------------------------------------------------


class JsonConn(object):
    """Per-connection context handed to connection-aware dispatchers
    (``serve_json_lines(..., pass_conn=True)``) and to the
    ``on_open``/``on_close`` callbacks. ``state`` is a scratch dict the
    service owns (the serving frontend keys its live streams there so a
    disconnect can tear them down); ``sock``/``rfile`` let a STREAMING
    dispatcher poll the connection for an in-band cancel line or EOF
    while it is producing messages (the client sends nothing else
    mid-stream, so peeking the raw socket is race-free)."""

    __slots__ = ("id", "sock", "rfile", "state")

    def __init__(self, conn_id, sock, rfile):
        self.id = conn_id
        self.sock = sock
        self.rfile = rfile
        self.state = {}


def serve_json_lines(dispatch, host="127.0.0.1", port=0, pass_conn=False,
                     on_open=None, on_close=None, ssl_context=None,
                     auth_token=None):
    """Start a threading TCP endpoint speaking newline-delimited JSON:
    every request line is parsed and handed to ``dispatch(dict) -> dict``
    (or ``dispatch(dict, conn)`` with ``pass_conn=True``); exceptions
    become ``{"ok": False, "error": str(exc)}``. Returns
    ``(server, (host, port))`` — the caller owns shutdown/server_close.
    This is the one wire protocol every control-plane service in the
    repo shares (master task queue, fleet coordinator, serving
    frontend): Python workers need no RPC deps, and a line is a
    complete framed message.

    Streaming responses: when ``dispatch`` returns an ITERATOR (any
    non-dict iterable — a generator, typically) instead of a dict, each
    yielded dict is written as its own line and flushed immediately, so
    a client can consume a response incrementally (the serving
    frontend's token streams). The END of a stream is the dispatcher's
    protocol to mark in-band (a terminal message); an exception raised
    mid-iteration becomes a terminal ``{"ok": False, "error": ...}``
    line, and the iterator is always ``close()``d — abandoning a stream
    because the client disconnected runs the dispatcher's cleanup
    (``finally`` blocks / ``GeneratorExit``), which is how per-stream
    resources get reclaimed.

    ``on_open(conn)`` / ``on_close(conn)`` fire when a connection is
    established / torn down (either side closing), with the same
    :class:`JsonConn` the dispatcher saw — the close callback is the
    disconnect-reclamation hook. Both default to None and the default
    ``pass_conn=False`` keeps the exact one-request/one-response
    contract the master task queue and fleet coordinator were built on.

    Chaos sites (armed only via ``FLAGS_chaos_spec``, zero cost
    otherwise): ``net.accept`` severs a just-accepted connection before
    any request is read; ``net.send`` fails a response write, severing
    the connection mid-(stream) — both exercise client reconnect /
    typed-error paths, never a wedge.

    Transport security (both default off, wire bytes unchanged):
    ``ssl_context`` (an ``ssl.SSLContext`` with a server cert loaded)
    wraps every accepted connection in TLS before the first line is
    read; ``auth_token`` requires every request line to carry a
    matching ``"auth"`` bearer field — a bad or missing token answers
    one typed :class:`AuthError` line and severs the connection, and
    the ``auth`` field is always stripped before dispatch so services
    never see (or log) credentials."""

    class Handler(socketserver.StreamRequestHandler):
        def setup(self):
            # streaming responses are many SMALL line writes in quick
            # succession; Nagle+delayed-ACK batches them into ~20ms-late
            # tails the wire SLOs (ttft, inter-token, trace coverage)
            # would wrongly charge to the server — flush every line now
            try:
                self.request.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass  # non-TCP transports (tests) don't carry the opt
            socketserver.StreamRequestHandler.setup(self)
            with self.server._conn_mu:
                self.server._live_conns.add(self.connection)
                self.server._next_conn_id += 1
                cid = self.server._next_conn_id
            # ThreadingMixIn owns this thread's construction, so the
            # role name lands here instead of a Thread(name=...) kwarg
            threading.current_thread().name = (
                "paddle-tpu-jsonl-conn-%d" % cid)
            self.ctx = JsonConn(cid, self.connection, self.rfile)
            self._opened = False
            if on_open is not None:
                try:
                    on_open(self.ctx)
                    self._opened = True
                except Exception:  # noqa: BLE001 - service hook, not wire
                    import logging

                    logging.getLogger("paddle_tpu_torch.distributed").exception(
                        "serve_json_lines on_open callback failed")
            else:
                self._opened = True

        def finish(self):
            with self.server._conn_mu:
                self.server._live_conns.discard(self.connection)
            if on_close is not None and self._opened:
                try:
                    on_close(self.ctx)
                except Exception:  # noqa: BLE001 - service hook, not wire
                    import logging

                    logging.getLogger("paddle_tpu_torch.distributed").exception(
                        "serve_json_lines on_close callback failed")
            socketserver.StreamRequestHandler.finish(self)

        def _send(self, resp):
            payload = (json.dumps(resp) + "\n").encode("utf-8")
            if self._chaos.ENABLED:
                self._chaos.fault("net.send")
            self.wfile.write(payload)
            self.wfile.flush()
            with self.server._conn_mu:
                self.server.bytes_sent += len(payload)

        def handle(self):
            # bound once per connection, not per message: _send sits on
            # the per-line streaming hot path
            from paddle_tpu_torch.resilience import chaos as _chaos

            self._chaos = _chaos
            if _chaos.ENABLED:
                try:
                    _chaos.fault("net.accept")
                except Exception:  # noqa: BLE001 - injected accept fault
                    return  # sever: the client sees EOF and reconnects
            try:
                for line in self.rfile:
                    with self.server._conn_mu:
                        self.server.bytes_received += len(line)
                    try:
                        req = json.loads(line)
                        if (isinstance(req, dict)
                                and req.pop("auth", None) != auth_token
                                and auth_token is not None):
                            # one typed refusal, then sever: an
                            # unauthenticated peer gets no second
                            # request on this connection
                            self._send({
                                "ok": False, "etype": "AuthError",
                                "error": "bad or missing auth token"})
                            return
                        resp = (dispatch(req, self.ctx) if pass_conn
                                else dispatch(req))
                    except Exception as e:  # noqa: BLE001
                        resp = {"ok": False, "error": str(e)}
                    if isinstance(resp, dict):
                        self._send(resp)
                        continue
                    # streaming: one line per yielded message, flushed
                    # as produced; a mid-stream dispatcher exception is
                    # delivered as a terminal error line
                    it = iter(resp)
                    try:
                        while True:
                            try:
                                msg = next(it)
                            except StopIteration:
                                break
                            except Exception as e:  # noqa: BLE001
                                self._send({"ok": False, "error": str(e)})
                                break
                            self._send(msg)
                    finally:
                        close = getattr(it, "close", None)
                        if close is not None:
                            close()
            except OSError:
                # severed connection (client gone, close_json_server,
                # or an injected net.send fault): the dispatcher's
                # stream cleanup already ran via the finally above
                return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

        def get_request(self):
            # TLS wrap at accept time, before the handler thread reads
            # a byte; a failed handshake is an OSError the accept loop
            # already absorbs (the peer just sees a severed socket)
            sock, addr = socketserver.ThreadingTCPServer.get_request(
                self)
            if ssl_context is not None:
                sock = ssl_context.wrap_socket(sock, server_side=True)
            return sock, addr

    server = Server((host, port), Handler)
    server._conn_mu = lock_witness.make_lock("distributed.jsonl.conn")
    server._live_conns = set()
    server._next_conn_id = 0
    server.bytes_sent = 0
    server.bytes_received = 0
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="paddle-tpu-jsonl-accept-%d"
                          % server.server_address[1]).start()
    return server, server.server_address


def close_json_server(server):
    """Full shutdown of a serve_json_lines endpoint: stop accepting,
    close the listener AND sever every established client connection —
    ``server_close`` alone leaves accepted sockets alive, so a
    'restarted' service would keep answering from the dead instance's
    threads and clients would never exercise their reconnect path."""
    if server is None:
        return
    server.shutdown()
    server.server_close()
    with server._conn_mu:
        conns = list(server._live_conns)
        server._live_conns.clear()
    for conn in conns:
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass


def _parse_addr(one):
    """One address spec -> (host, port). Accepts 'host:port' or a
    (host, port) pair."""
    if isinstance(one, str):
        host, _, port = one.rpartition(":")
        return (host or "127.0.0.1", int(port))
    return (one[0], int(one[1]))


class JsonLineClient(object):
    """Shared client shell for the JSON-lines protocol: one persistent
    socket, reconnect-and-retry-once across a service restart (the
    resilience backoff+accounting), per-request chaos site hook. The
    retried call is safe because every service speaking this protocol
    follows the snapshot/recover pattern: a restarted service answers
    with consistent state and unknown-id requests return a typed error
    instead of corrupting.

    ``addr`` may be a single 'host:port' / (host, port), a
    comma-separated 'h:p,h:p' string, or a list of either — with more
    than one address the client fails over: a connect that fails (or a
    send on a severed socket) rotates to the next address, so the
    existing reconnect-retry shells transparently reach a survivor
    (e.g. a router replica) without new retry machinery.

    ``ssl_context`` (client-mode ``ssl.SSLContext``) wraps the socket
    in TLS; ``auth_token`` stamps every request line with the bearer
    ``"auth"`` field an authenticated endpoint demands — a mismatch
    surfaces as the typed, never-retried :class:`AuthError`."""

    #: metrics/blackbox origin for retry accounting; subclasses override
    origin = "JsonLineClient._call"

    def __init__(self, addr, timeout_s=10.0, ssl_context=None,
                 auth_token=None):
        if isinstance(addr, str):
            self._addrs = [_parse_addr(a.strip())
                           for a in addr.split(",") if a.strip()]
        elif (isinstance(addr, (list, tuple)) and len(addr) == 2
                and isinstance(addr[0], str)
                and not isinstance(addr[1], (str, list, tuple))):
            # a bare (host, port) pair, the historical form
            self._addrs = [_parse_addr(addr)]
        else:
            self._addrs = [_parse_addr(a) for a in addr]
        if not self._addrs:
            raise ValueError("JsonLineClient needs at least one address")
        self._addr_i = 0
        self._timeout_s = timeout_s
        self._ssl_context = ssl_context
        self._auth_token = auth_token
        self._sock = None
        self._rfile = None

    @property
    def _addr(self):
        """The address currently targeted (rotates on failover)."""
        return self._addrs[self._addr_i]

    def _chaos_site(self, req):
        """Chaos site to arm for this request (None = uninstrumented)."""
        return None

    def _trace_context(self, req):
        """Trace envelope for this request (None = untraced — the
        default, so the wire bytes of an untracing client are identical
        to pre-tracing builds). ServingClient overrides this to mint a
        request-scoped trace id + send timestamp when
        FLAGS_request_tracing is on (observability/tracing.py); any
        JSON-lines service can adopt the same envelope field."""
        return None

    def _connect(self):
        if self._sock is not None:
            return
        last = None
        for _ in range(len(self._addrs)):
            try:
                sock = socket.create_connection(
                    self._addr, timeout=self._timeout_s)
            except OSError as exc:
                # failover: rotate to the next configured address and
                # let the connect loop (or the caller's retry shell)
                # reach a survivor
                last = exc
                self._addr_i = (self._addr_i + 1) % len(self._addrs)
                continue
            try:  # small-line protocol: never let Nagle sit on a frame
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            if self._ssl_context is not None:
                sock = self._ssl_context.wrap_socket(
                    sock, server_hostname=self._addr[0])
            self._sock = sock
            self._rfile = sock.makefile("rb")
            return
        raise last

    def _send_line(self, req):
        """Connect (if needed) and write one framed request; a send
        failure closes the socket and rotates the target address so the
        next attempt reconnects (to the next replica, if any)."""
        self._connect()
        if self._auth_token is not None and isinstance(req, dict):
            req = dict(req, auth=self._auth_token)
        try:
            self._sock.sendall((json.dumps(req) + "\n").encode("utf-8"))
        except OSError:
            self.close()
            self._addr_i = (self._addr_i + 1) % len(self._addrs)
            raise

    def _recv_line(self):
        """Read one framed response; EOF (the service closed or was
        severed) and socket errors close the socket and raise — both
        are classified transient, so retry shells reconnect."""
        try:
            line = self._rfile.readline()
        except OSError:
            self.close()
            self._addr_i = (self._addr_i + 1) % len(self._addrs)
            raise
        if not line:
            self.close()
            self._addr_i = (self._addr_i + 1) % len(self._addrs)
            raise ConnectionError(
                "%s: service closed connection" % type(self).__name__)
        return json.loads(line)

    def _call(self, **req):
        """One RPC, surviving a service restart: on ConnectionError /
        EOFError / a raw socket error the client reconnects and retries
        ONCE (with the resilience backoff+accounting) before surfacing
        the failure."""
        from paddle_tpu_torch.resilience import retry as _retry

        ctx = self._trace_context(req)
        if ctx is not None:
            req = dict(req, trace=ctx)

        def once():
            from paddle_tpu_torch.resilience import chaos as _chaos

            if _chaos.ENABLED:
                site = self._chaos_site(req)
                if site:
                    _chaos.fault(site)
            self._send_line(req)
            resp = self._recv_line()
            if (isinstance(resp, dict)
                    and resp.get("etype") == "AuthError"):
                self.close()
                raise AuthError(resp.get("error", "auth rejected"))
            return resp

        return _retry.call(once, origin=self.origin, retries=1)

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._rfile = None


class ThrottledSnapshot(object):
    """Crash-recovery snapshots with the disk write OFF the service
    lock. ``capture(state)`` — called *while holding* the owner's lock —
    only stamps the serialized state into a sequence-numbered pending
    slot (plus the original write throttle: per-mutation churn coalesces
    to one capture per ``interval_s``; ``force=True`` for structural
    transitions). ``flush()`` — called with the owner's lock *released*
    — lands the newest capture atomically (tmp file + rename).

    Two guarantees the old write-under-the-lock scheme lacked:

    * an RPC (a heartbeat, a get_task) never waits behind a slow
      ``json.dump``+disk write happening under the service mutex — the
      serialization and IO run on whichever thread calls flush, lock
      free;
    * commits are sequence-ordered: a slow stale writer racing a newer
      one loses (its tmp file is discarded), so the *final* capture —
      e.g. the forced one in ``close()`` — can never be clobbered by an
      older in-flight write persisting a task as ``todo`` that is
      actually leased or done.
    """

    def __init__(self, path, interval_s=0.5):
        self.path = path
        self.interval_s = float(interval_s)
        self._mu = lock_witness.make_lock(
            "distributed.snapshot.throttle")  # pending/seq bookkeeping only
        self._pending = None         # (seq, state): newest unflushed capture
        self._seq = 0
        self._written_seq = 0
        self._last_capture = 0.0
        self.dirty = False           # a throttled-away capture is owed

    def capture(self, state, force=False):
        """``state`` may be the state dict itself or a zero-arg callable
        producing it — pass the callable from per-mutation hot paths, so
        a throttled-away capture costs a clock read, not an O(n) state
        serialization under the owner's lock."""
        if not self.path:
            return
        with self._mu:
            now = time.time()
            if (not force
                    and now - self._last_capture < self.interval_s):
                self.dirty = True
                return
            self._last_capture = now
            self.dirty = False
            self._seq += 1
            self._pending = (self._seq,
                             state() if callable(state) else state)

    def flush(self):
        """Write the newest pending capture; a no-op when none. Never
        call while holding the owner's service lock (defeats the point).
        """
        if not self.path:
            return
        with self._mu:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        seq, state = pending
        tmp = "%s.tmp-%d-%d" % (self.path, os.getpid(), seq)
        with open(tmp, "w") as f:
            json.dump(state, f)
        stale = None
        with self._mu:
            # the rename commits under the bookkeeping lock (it is an
            # atomic metadata op, unlike the dump above): seq order is
            # decided and acted on indivisibly, so a paused stale writer
            # can never replace a newer snapshot after losing the check
            if seq > self._written_seq:
                self._written_seq = seq
                os.replace(tmp, self.path)
            else:
                stale = tmp
        if stale:
            try:
                os.unlink(stale)
            except OSError:
                pass

    def load(self):
        """Parsed snapshot state, or None. A MISSING file is a normal
        cold start (silent); an existing-but-unreadable one is a loud
        event — it is quarantined (``.corrupt-<n>``, kept for autopsy,
        the checkpoint-layer discipline) and logged, because a service
        silently coming up empty is indistinguishable from data loss."""
        if not self.path or not os.path.exists(self.path):
            return None
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError) as exc:
            n = 0
            dst = "%s.corrupt-%d" % (self.path, n)
            while os.path.exists(dst):
                n += 1
                dst = "%s.corrupt-%d" % (self.path, n)
            try:
                os.replace(self.path, dst)
            except OSError:
                dst = None
            import logging

            logging.getLogger("paddle_tpu_torch.distributed").warning(
                "snapshot %s exists but is unreadable (%s); quarantined "
                "to %s — the service recovers NOTHING and starts empty",
                self.path, exc, dst)
            return None


class Task(object):
    __slots__ = ("task_id", "chunks", "epoch", "num_failures")

    def __init__(self, task_id, chunks, epoch=0, num_failures=0):
        self.task_id = task_id
        self.chunks = list(chunks)
        self.epoch = epoch
        self.num_failures = num_failures

    def to_json(self):
        return {
            "task_id": self.task_id,
            "chunks": self.chunks,
            "epoch": self.epoch,
            "num_failures": self.num_failures,
        }

    @staticmethod
    def from_json(d):
        return Task(d["task_id"], d["chunks"], d["epoch"], d["num_failures"])


class _Errors(object):
    PASS_BEFORE = "pass_before"
    PASS_AFTER = "pass_after"
    NO_MORE_AVAILABLE = "no_more_available"
    ALL_FAILED = "all_task_failed"


class MasterService(object):
    """In-process task-queue service; optionally served over TCP."""

    def __init__(self, chunks_per_task=1, timeout_s=5.0, failure_max=3,
                 snapshot_path=None, snapshot_interval_s=0.5):
        """snapshot_interval_s: write-throttle window for per-lease
        snapshot churn (see _snapshot); structural transitions always
        force a write. Crash-recovery tests raise it to pin exactly
        which state a simulated kill -9 loses."""
        self._chunks_per_task = max(1, int(chunks_per_task))
        self._timeout_s = timeout_s
        self._failure_max = failure_max
        self._snapshot_path = snapshot_path
        self._mu = lock_witness.make_rlock("distributed.master")
        self._todo = []  # [Task]
        self._pending = {}  # task_id -> (Task, lease_deadline)
        self._done = []
        self._failed = []
        self._cur_pass = 0
        self._all_chunks = []
        self._server = None
        self._watcher = None
        self._closed = threading.Event()
        self._snap = ThrottledSnapshot(snapshot_path,
                                       interval_s=snapshot_interval_s)
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()

    # -- dataset / partition (service.go:106,280) ---------------------------

    def set_dataset(self, chunks):
        """chunks: list of opaque JSON-serializable chunk descriptors (file
        paths, (file, offset) pairs...). Partitioned chunks_per_task each."""
        with self._mu:
            self._all_chunks = list(chunks)
            if not self._todo and not self._pending and not self._done:
                self._todo = self._partition(self._all_chunks)
                self._snapshot(force=True)
        self._snap.flush()

    def _partition(self, chunks):
        tasks = []
        for i in range(0, len(chunks), self._chunks_per_task):
            tasks.append(Task(len(tasks), chunks[i:i + self._chunks_per_task]))
        return tasks

    # -- task protocol ------------------------------------------------------

    def get_task(self, pass_id):
        """Lease the next task. Returns (task, None) or (None, error_code)."""
        with self._mu:
            if pass_id < self._cur_pass:
                return None, _Errors.PASS_BEFORE
            if pass_id > self._cur_pass:
                return None, _Errors.PASS_AFTER
            if not self._todo:
                if not self._done and not self._pending:
                    return None, _Errors.ALL_FAILED
                return None, _Errors.NO_MORE_AVAILABLE
            t = self._todo.pop(0)
            t.epoch += 1
            self._pending[t.task_id] = (t, time.time() + self._timeout_s)
            self._snapshot()
            self._ensure_watcher()
            leased = Task(t.task_id, t.chunks, t.epoch, t.num_failures)
        self._snap.flush()
        return leased, None

    def task_finished(self, task_id):
        with self._mu:
            ent = self._pending.pop(task_id, None)
            if ent is not None:
                self._done.append(ent[0])
                rolled = False
                if not self._todo and not self._pending:
                    self._next_pass()
                    rolled = True
                self._snapshot(force=rolled)
        self._snap.flush()
        return ent is not None

    def task_failed(self, task_id, epoch=None):
        """Report failure (worker crash detected, bad data...). Requeues the
        task until failure_max, then discards it (service.go:455)."""
        with self._mu:
            ok = self._task_failed_locked(task_id, epoch)
        self._snap.flush()
        return ok

    def _task_failed_locked(self, task_id, epoch):
        ent = self._pending.get(task_id)
        if ent is None:
            return False
        t, _ = ent
        if epoch is not None and epoch != t.epoch:
            return False  # stale report from a previous lease
        del self._pending[task_id]
        t.num_failures += 1
        if t.num_failures >= self._failure_max:
            self._failed.append(t)
        else:
            self._todo.append(t)
        if not self._todo and not self._pending and self._done:
            self._next_pass()
        self._snapshot()
        return True

    def _next_pass(self):
        self._cur_pass += 1
        todo = self._done + self._failed
        for t in todo:
            t.num_failures = 0
        self._todo = sorted(todo, key=lambda t: t.task_id)
        self._done = []
        self._failed = []

    # -- lease timeout watcher (service.go checkTimeoutFunc) ----------------

    def _ensure_watcher(self):
        if self._watcher is None or not self._watcher.is_alive():
            self._watcher = threading.Thread(
                target=self._watch_loop, daemon=True,
                name="paddle-tpu-master-lease-watch")
            self._watcher.start()

    def _watch_loop(self):
        while not self._closed.is_set():
            now = time.time()
            with self._mu:
                expired = [
                    (tid, t.epoch) for tid, (t, dl) in self._pending.items()
                    if dl <= now
                ]
            # fail the leases via the PUBLIC method, outside our own lock
            # hold: it re-validates (pending membership + epoch) under the
            # lock and flushes the snapshot off-lock
            for tid, epoch in expired:
                self.task_failed(tid, epoch)
            with self._mu:
                if not self._pending:
                    # exit decision and watcher-slot release are ONE
                    # atomic step: a lease taken after this point sees
                    # the slot empty and _ensure_watcher spawns a fresh
                    # watcher instead of trusting this dying thread
                    if self._watcher is threading.current_thread():
                        self._watcher = None
                    return
            self._closed.wait(min(self._timeout_s / 4.0, 0.25))

    # -- introspection / persistence ----------------------------------------

    def status(self):
        with self._mu:
            return {
                "todo": len(self._todo),
                "pending": len(self._pending),
                "done": len(self._done),
                "failed": len(self._failed),
                "cur_pass": self._cur_pass,
            }

    def _snapshot(self, force=False):
        """Capture-only persistence (call with ``_mu`` held): the state
        dict is stamped into the ThrottledSnapshot's pending slot —
        per-lease churn coalesced to one capture per interval, structural
        transitions (dataset set, pass rollover, close) forced — and the
        actual ``json.dump`` + disk write happens in ``_snap.flush()``
        AFTER the caller releases ``_mu``, so concurrent RPCs never queue
        behind the serialization work. Bounded staleness is the
        rebuild's trade vs the reference's every-mutation etcd write
        (service.go:207) — on recovery a slightly-stale snapshot only
        re-dispatches already-done tasks."""
        self._snap.capture(lambda: {
            "todo": [t.to_json() for t in self._todo],
            "pending": [t.to_json() for t, _ in self._pending.values()],
            "done": [t.to_json() for t in self._done],
            "failed": [t.to_json() for t in self._failed],
            "cur_pass": self._cur_pass,
            "chunks": self._all_chunks,
        }, force=force)

    def _recover(self):
        """service.go:166 — a restarted master resumes from the snapshot;
        tasks that were pending at crash time go back to todo."""
        state = self._snap.load()
        if state is None:
            return
        self._todo = [Task.from_json(d) for d in state["todo"]]
        self._todo += [Task.from_json(d) for d in state["pending"]]
        self._done = [Task.from_json(d) for d in state["done"]]
        self._failed = [Task.from_json(d) for d in state["failed"]]
        self._cur_pass = state["cur_pass"]
        self._all_chunks = state["chunks"]

    # -- TCP front-end (JSON lines) -----------------------------------------

    def serve(self, host="127.0.0.1", port=0):
        """Start the TCP endpoint; returns (host, port)."""
        self._server, addr = serve_json_lines(self._dispatch, host, port)
        return addr

    def _dispatch(self, req):
        method = req.get("method")
        if method == "get_task":
            task, err = self.get_task(req.get("pass_id", 0))
            if err:
                return {"ok": False, "error": err}
            return {"ok": True, "task": task.to_json()}
        if method == "task_finished":
            return {"ok": self.task_finished(req["task_id"])}
        if method == "task_failed":
            return {"ok": self.task_failed(req["task_id"],
                                           req.get("epoch"))}
        if method == "set_dataset":
            self.set_dataset(req["chunks"])
            return {"ok": True}
        if method == "status":
            return {"ok": True, "status": self.status()}
        return {"ok": False, "error": "unknown method %r" % method}

    def close(self):
        with self._mu:
            if self._snap.dirty:
                self._snapshot(force=True)
        # the final flush is sequence-ordered: even if an older capture's
        # write is still in flight on another thread, this newest state
        # wins — close() can never leave a leased/done task persisted in
        # a stale 'todo' position
        self._snap.flush()
        self._closed.set()
        close_json_server(self._server)
        self._server = None


class MasterClient(JsonLineClient):
    """Worker-side client (go/master/client.go role): fetch/finish/fail
    tasks over the JSON-lines TCP protocol, with pass tracking.

    Every ``_call`` survives a master restart (reconnect-and-retry-once,
    inherited from :class:`JsonLineClient`): the master's snapshot/
    recover path means a restarted master answers the retried call with
    consistent task state, and every method here is either idempotent
    (get_task leases a fresh epoch, status/set_dataset) or safely
    re-reportable (task_finished / task_failed on an unknown lease
    returns ok=False, it doesn't corrupt)."""

    origin = "MasterClient._call"

    def __init__(self, addr, timeout_s=10.0):
        super(MasterClient, self).__init__(addr, timeout_s=timeout_s)
        self.pass_id = 0
        # set when the master reports our pass is over (PASS_BEFORE with
        # sync_pass=False); task_reader uses it as the end-of-epoch signal
        self.pass_ended = False

    def _chaos_site(self, req):
        return "master.call"

    def get_task(self, sync_pass=True):
        """Returns a Task or None. With sync_pass (default), a client
        lagging behind the master's pass fast-forwards and keeps fetching;
        with sync_pass=False it instead sets ``pass_ended`` and returns
        None, so callers get a clean end-of-epoch boundary."""
        resp = self._call(method="get_task", pass_id=self.pass_id)
        if resp.get("ok"):
            return Task.from_json(resp["task"])
        err = resp.get("error")
        if err == _Errors.PASS_BEFORE:
            if sync_pass:
                self.pass_id += 1
                return self.get_task(sync_pass)
            self.pass_ended = True
        elif err == _Errors.ALL_FAILED:
            self.pass_ended = True
        return None

    def next_pass(self):
        """Acknowledge end of epoch: advance to the master's next pass."""
        self.pass_id += 1
        self.pass_ended = False

    def task_finished(self, task_id):
        return self._call(method="task_finished", task_id=task_id).get("ok")

    def task_failed(self, task_id, epoch=None):
        return self._call(
            method="task_failed", task_id=task_id, epoch=epoch).get("ok")

    def status(self):
        return self._call(method="status").get("status")

    def set_dataset(self, chunks):
        return self._call(method="set_dataset", chunks=chunks).get("ok")


def task_reader(client, load_chunk, poll_s=0.1, max_polls=600):
    """Fluid-style reader over master-dispatched tasks (client.go's
    paddle.reader.creator.cloud_reader role).

    ``load_chunk(chunk)`` yields samples for one chunk descriptor. Each
    ``reader()`` iteration is ONE pass: it leases tasks until the master
    rolls to the next pass (or every task failed), reporting
    task_finished per completed task and task_failed on a chunk
    exception. Call ``reader()`` again for the next epoch.
    """

    def reader():
        polls = 0
        while True:
            task = client.get_task(sync_pass=False)
            if task is None:
                if client.pass_ended:
                    client.next_pass()  # epoch boundary
                    return
                polls += 1
                if polls >= max_polls:
                    return
                # tasks may still be leased elsewhere; wait for requeue
                time.sleep(poll_s)
                continue
            polls = 0
            try:
                for chunk in task.chunks:
                    for sample in load_chunk(chunk):
                        yield sample
            except Exception:  # noqa: BLE001 - report and move on
                client.task_failed(task.task_id, task.epoch)
                continue
            client.task_finished(task.task_id)

    return reader
