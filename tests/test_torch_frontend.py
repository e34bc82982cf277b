"""The port's network front end: the socket serving plane
(``serving/frontend.py`` + ``serving/client.py``) and the JSON-lines
substrate under it (``distributed/master.py``).

Mirrors tests/test_frontend.py except its SIGTERM / snapshot and
fleet-coordinator tests (snapshots and the coordinator are A8's second
half): the substrate (dict dispatch, streaming,
connection callbacks), the wire codec (bit-exact arrays, typed errors),
unary ``predict`` (parity, deadlines, shed), streaming ``generate``
(per-dispatch chunks, best-of-N and prefix reuse over the wire, a
backlog over more streams than slots, beam streams and their GNMT
rescoring), disconnect and in-band cancel
reclamation (``pool_conserved`` afterwards), the ``net.*`` chaos sites,
the ops endpoints and the typed refusals of what the port does not
serve yet. Decode is greedy, so every wire stream must EQUAL the same
request through an in-process session (an oracle) on the same weights:
a 2-layer, d_model 64 Transformer trained a few Adam steps on a copy
task, so that different sources decode differently.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags
from paddle_tpu_torch.distributed.master import (
    JsonLineClient,
    MasterClient,
    MasterService,
    close_json_server,
    serve_json_lines,
)
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.resilience import chaos
from paddle_tpu_torch.serving import loadgen
from paddle_tpu_torch.serving.client import (
    ServingClient,
    StreamBrokenError,
    decode_array,
    encode_array,
    error_from_wire,
    error_to_wire,
)
from paddle_tpu_torch.serving.degradation import DegradedError
from paddle_tpu_torch.serving.frontend import ServingFrontend
from paddle_tpu_torch.serving.generation import (
    NoFreePageError,
    NoFreeSlotError,
    SlotDecodeSession,
)
from paddle_tpu_torch.serving.server import (
    BatchingServer,
    DeadlineExceededError,
    QueueFullError,
    ServerClosedError,
    ServingError,
)
from paddle_tpu_torch.testing import fresh_state

VOCAB, SEQ, D, S = 24, 8, 64, 4
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=2,
           n_head=2, d_inner=64)


@pytest.fixture(autouse=True)
def _clean_chaos_and_flags():
    with fresh_state():
        yield
    chaos.disable()
    flags.set_flag("dispatch_retries", 0)
    flags.set_flag("chaos_spec", "")


# ---------------------------------------------------------------------------
# substrate: serve_json_lines
# ---------------------------------------------------------------------------

def test_substrate_dict_dispatch_unchanged():
    """The one-request/one-response contract: MasterService serves its
    whole task protocol through the substrate."""
    svc = MasterService(chunks_per_task=1, timeout_s=5.0)
    addr = svc.serve()
    try:
        client = MasterClient(addr)
        client.set_dataset(["a", "b"])
        t1 = client.get_task()
        assert t1 is not None and t1.chunks in (["a"], ["b"])
        assert client.task_finished(t1.task_id)
        st = client.status()
        assert st["done"] == 1 and st["todo"] == 1
        client.close()
    finally:
        svc.close()


def test_substrate_streaming_callbacks_and_byte_accounting():
    opened, closed = [], []

    def dispatch(req, conn):
        assert conn.id >= 1
        if req["m"] == "one":
            conn.state["seen"] = True
            return {"ok": True, "x": req["x"]}

        def gen():
            for i in range(3):
                yield {"ok": True, "i": i}
            yield {"ok": True, "event": "end"}

        return gen()

    srv, addr = serve_json_lines(
        dispatch, pass_conn=True,
        on_open=lambda c: opened.append(c.id),
        on_close=lambda c: closed.append((c.id, c.state.get("seen"))))
    try:
        cl = JsonLineClient(addr)
        assert cl._call(m="one", x=7) == {"ok": True, "x": 7}
        cl._send_line({"m": "stream"})
        msgs = [cl._recv_line() for _ in range(4)]
        assert [m.get("i") for m in msgs[:3]] == [0, 1, 2]
        assert msgs[3]["event"] == "end"
        cl.close()
        deadline = time.monotonic() + 5.0
        while not closed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert opened == [1] and closed == [(1, True)]
        with srv._conn_mu:
            assert srv.bytes_sent > 0 and srv.bytes_received > 0
    finally:
        close_json_server(srv)


def test_substrate_stream_exception_becomes_terminal_error_line():
    cleaned = []

    def dispatch(req):
        def gen():
            try:
                yield {"ok": True, "i": 0}
                raise RuntimeError("mid-stream boom")
            finally:
                cleaned.append(True)

        return gen()

    srv, addr = serve_json_lines(dispatch)
    try:
        cl = JsonLineClient(addr)
        cl._send_line({})
        assert cl._recv_line() == {"ok": True, "i": 0}
        err = cl._recv_line()
        assert err["ok"] is False and "mid-stream boom" in err["error"]
        cl.close()
        assert cleaned == [True]
    finally:
        close_json_server(srv)


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------

def test_array_codec_bit_exact():
    nan_payload = np.array([1.0, np.float32(np.nan), -np.inf, 3e-41],
                           dtype="float32").reshape(2, 2)
    for arr in (nan_payload,
                np.arange(12, dtype="int64").reshape(3, 4),
                np.asarray(2.5, dtype="float64")):
        back = decode_array(encode_array(arr))
        assert back.dtype == arr.dtype and back.shape == arr.shape
        assert np.array_equal(arr.tobytes(), back.tobytes())
        back[...] = 0  # decoded arrays must be writable


def test_typed_errors_round_trip_the_wire():
    for exc in (QueueFullError("q"), DeadlineExceededError("d"),
                ServerClosedError("c"), NoFreeSlotError("s"),
                NoFreePageError("p"), StreamBrokenError("b")):
        back = error_from_wire(error_to_wire(exc))
        assert type(back) is type(exc) and str(exc) in str(back)
    deg = error_from_wire(error_to_wire(
        DegradedError("shed", state="shed", retry_after_s=0.25)))
    assert isinstance(deg, DegradedError)
    assert deg.state == "shed" and deg.retry_after_s == 0.25
    from paddle_tpu_torch.resilience.retry import is_transient

    assert is_transient(deg), "wire DegradedError lost retriability"
    unknown = error_from_wire({"ok": False, "etype": "Weird",
                               "error": "x"})
    assert isinstance(unknown, ServingError) and "Weird" in str(unknown)


# ---------------------------------------------------------------------------
# fixtures: demo predictor (unary) + trained decoder (streaming)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_predictor(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("fe_demo") / "model")
    with fresh_state():
        loadgen.build_demo_model(model_dir, train_steps=5)
    return create_paddle_predictor(NativeConfig(model_dir=model_dir,
                                                use_tpu=False))


@pytest.fixture(scope="module")
def trained():
    """A 2-layer, d_model 64 Transformer trained 30 Adam steps on a copy
    task (different sources decode differently)."""
    with fresh_state():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 41
        with fluid.unique_name.guard({}), \
                fluid.program_guard(main, startup):
            loss, _, _ = transformer.build(
                dropout=0.0, label_smooth_eps=0.0, max_length=SEQ,
                d_model=D, **CFG)
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(22)
        for _ in range(30):
            src = rng.randint(3, VOCAB, (16, SEQ)).astype("int64")
            trg = np.full_like(src, 1)
            trg[:, 1:] = src[:, :-1]
            exe.run(main, feed={
                "src_word": src, "src_len": np.full((16, 1), SEQ, "int64"),
                "trg_word": trg, "trg_len": np.full((16, 1), SEQ, "int64"),
                "label": src}, fetch_list=[loss], scope=scope)
    src = np.random.RandomState(7).randint(3, VOCAB, (8, SEQ)).astype(
        "int64")
    return {"exe": exe, "scope": scope, "src": src}


def _paged(trained, **kw):
    args = dict(num_slots=S, max_length=SEQ, d_model=D, paged=True,
                page_size=4, steps=2, num_groups=2, prefix_cache_pages=8,
                scope=trained["scope"].new_scope())
    args.update(CFG)
    args.update(kw)
    return SlotDecodeSession(trained["exe"], **args)


def _drained(sess, timeout=60.0):
    """Wait until every teardown landed on the decode worker: every slot
    free, no queued request, the pool at conservation."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if (not sess.active_slots and not sess.pending_requests
                and sess.free_slots == sess._S
                and sess.pool_conserved):
            return True
        time.sleep(0.02)
    return False


def test_trained_sources_decode_differently(trained):
    rows = _paged(trained).generate(trained["src"][:4], [SEQ] * 4)
    assert len({tuple(r) for r in rows}) == 4


# ---------------------------------------------------------------------------
# unary predict over the wire
# ---------------------------------------------------------------------------

def test_predict_bit_exact_parity(demo_predictor):
    """One request at a time through one worker: the wire result equals
    ``run_reference`` bit for bit (the same padded batch, the same
    predictor)."""
    server = BatchingServer(demo_predictor, max_batch=8, workers=1,
                            batch_linger_s=0.002)
    with server, ServingFrontend(server=server) as fe:
        cl = ServingClient(fe.address)
        for req in loadgen.demo_requests(6, seed=5):
            got = cl.predict(req)
            want = server.run_reference(req)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
        req = loadgen.demo_requests(1, seed=9)[0]
        got = cl.predict([req["x"]])  # list form, feed order
        want = server.run_reference(req)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        cl.close()


def test_predict_deadline_maps_to_typed_error(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8, workers=1,
                            batch_linger_s=0.2)
    with server, ServingFrontend(server=server) as fe:
        cl = ServingClient(fe.address)
        with pytest.raises(DeadlineExceededError):
            cl.predict({"x": np.zeros((2, 12), dtype="float32")},
                       deadline_s=1e-6)
        cl.close()


def test_predict_queue_full_is_typed(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8, workers=1,
                            max_queue_depth=1, batch_linger_s=5.0)
    with server, ServingFrontend(server=server) as fe:
        held = server.submit({"x": np.zeros((1, 12), "float32")})
        cl = ServingClient(fe.address)
        with pytest.raises(QueueFullError):
            cl.predict({"x": np.zeros((1, 12), dtype="float32")})
        cl.close()
        server.close(drain=True)
        assert held.result(timeout=30)[0].shape == (1, 3)


def test_predict_shed_reaches_client_typed_then_retries_through(
        demo_predictor):
    server = BatchingServer(
        demo_predictor, max_batch=8, workers=1, max_queue_depth=4,
        batch_linger_s=0.05,
        degradation=dict(brownout_at=0.25, shed_at=0.5,
                         recover_at=0.25, retry_after_s=0.05))
    with server, ServingFrontend(server=server) as fe:
        req = {"x": np.zeros((1, 12), dtype="float32")}

        def flood(n):
            rejects, okays = [], []

            def one():
                cl = ServingClient(fe.address)
                try:
                    cl.predict(req)
                    okays.append(1)
                except DegradedError as exc:
                    rejects.append(exc)
                finally:
                    cl.close()

            threads = [threading.Thread(target=one) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            return rejects, okays

        rejects, okays = flood(16)
        assert rejects, "the flood never tripped shed"
        assert okays, "shed refused everything, including the drain"
        assert all(isinstance(e, DegradedError)
                   and e.retry_after_s > 0 for e in rejects)
        # with the classified budget armed, the same flood rides the
        # retry-after hint through the drain
        flags.set_flag("dispatch_retries", 8)
        rejects, okays = flood(16)
        assert not rejects and len(okays) == 16


def test_unknown_method_is_typed(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8, workers=1)
    with server, ServingFrontend(server=server) as fe:
        cl = ServingClient(fe.address)
        with pytest.raises(ServingError, match="unknown method"):
            cl._request(method="nope")
        with pytest.raises(ServingError, match="no decode session"):
            list(cl.generate(np.zeros(SEQ, dtype="int64")))
        cl.close()


# ---------------------------------------------------------------------------
# streaming generate
# ---------------------------------------------------------------------------

def test_generate_streams_incrementally_and_matches_oracle(trained):
    src = trained["src"]
    sess, oracle = _paged(trained), _paged(trained)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        events = list(cl.generate(src[0], src_len=SEQ))
        kinds = [e["event"] for e in events]
        assert kinds[0] == "queued" and kinds[-1] == "end"
        token_events = [e for e in events if e["event"] == "tokens"]
        # SEQ=8, steps=2: the stream arrives in per-dispatch chunks
        assert len(token_events) >= 2
        assert all(len(e["tokens"]) <= 2 for e in token_events)
        assert [e["seq"] for e in token_events] == list(
            range(1, 1 + 2 * len(token_events), 2))
        wire = cl.generate_full(src[1], src_len=5)
        cl.close()
    want0 = oracle.generate(src[0][None, :], [SEQ])
    want1 = oracle.generate(src[1][None, :], [5])
    row0 = np.full(SEQ, 2, dtype="int64")
    row0[0] = 1
    fill = 1
    for e in token_events:
        row0[fill:fill + len(e["tokens"])] = e["tokens"]
        fill += len(e["tokens"])
    assert np.array_equal(row0, want0[0])
    assert np.array_equal(wire[0], want1[0])


def test_generate_best_of_and_prefix_reuse_over_the_wire(trained):
    src = trained["src"]
    pfx = [int(t) for t in src[0][:5]]
    sess, oracle = _paged(trained), _paged(trained)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        wire = cl.generate_full(src[0], src_len=SEQ, n=2,
                                prefix_tokens=pfx)
        wire2 = cl.generate_full(src[0], src_len=SEQ, n=2,
                                 prefix_tokens=pfx)
        stats = sess.prefix_cache_stats()
        cl.close()
    want = oracle.generate_best_of(src[0], 2, src_len=SEQ,
                                   prefix_tokens=pfx)
    want2 = oracle.generate_best_of(src[0], 2, src_len=SEQ,
                                    prefix_tokens=pfx)
    assert np.array_equal(wire, want)
    assert np.array_equal(wire2, want2)
    assert (wire[:, 1:6] == pfx).all()
    assert stats["lookups"] >= 2 and stats["hits"] >= 1, stats


def test_beam_request_is_refused_typed_not_hung(trained):
    """A beam request to a session built without beam lanes is refused
    with a typed error at once, and the connection serves on."""
    sess = _paged(trained)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        t0 = time.monotonic()
        with pytest.raises(ServingError, match="beam session"):
            cl.generate_beam(trained["src"][0], src_len=SEQ)
        assert time.monotonic() - t0 < 10.0
        # the connection and the worker serve on
        out = cl.generate_full(trained["src"][0], src_len=SEQ)
        assert out.shape == (1, SEQ)
        cl.close()
    assert _drained(sess)


def _beam_session(trained):
    args = dict(num_slots=S, max_length=SEQ, d_model=D, paged=True,
                page_size=4, beam_width=2,
                scope=trained["scope"].new_scope())
    args.update(CFG)
    return SlotDecodeSession(trained["exe"], **args)


def test_generate_beam_over_the_wire_matches_in_process(trained):
    """The beam grammar (``admitted`` with the beam's metadata, one
    ``beam`` survivor chunk a dispatch, a final ``beam_end`` n-best)
    reassembles equal to the in-process ``generate_beam``; ``n > 1`` with
    ``beam`` is a typed reject; a severed beam stream frees its whole
    lane; a beam that finishes with no stream banks its n-best, which
    the wire ``take_result`` claims."""
    src = trained["src"]
    sess = _beam_session(trained)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        events = []
        got_t, got_s = cl.generate_beam(src[0], src_len=SEQ,
                                        on_event=events.append)
        kinds = [e["event"] for e in events]
        assert kinds[0] == "admitted" and kinds[-2:] == ["beam_end", "end"]
        adm = events[0]
        assert adm["beam_width"] == 2 and len(adm["slots"]) == 2
        beam_events = [e for e in events if e["event"] == "beam"]
        assert len(beam_events) >= 3
        assert all(len(e["parents"]) == 2 and len(e["tokens"]) == 2
                   for e in beam_events)
        with pytest.raises(ServingError):
            list(cl.generate(src[0], src_len=SEQ, n=2, beam=True))
        gen = cl.generate(src[1], src_len=SEQ, beam=True)
        assert next(gen)["event"] == "admitted"
        cl.close()  # severed socket: the close hook cancels the beam
    assert _drained(sess)
    assert sess.free_beams == S // 2 and sess.pool_conserved
    want_t, want_s = sess.generate_beam(src[0], SEQ)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_s, want_s)
    lane = sess.admit_beam(src[1], SEQ)
    rid = sess.register_beam_owner(lane)
    while lane in sess.active_beams:
        sess.step()
    with ServingFrontend(session=sess) as fe2:
        cl2 = ServingClient(fe2.address)
        bt, bs = cl2.take_result(rid)
        cl2.close()
    assert sess.take_beam_result(rid) is None  # claimed over the wire
    np.testing.assert_array_equal(bt, sess.generate_beam(src[1], SEQ)[0])
    assert bs.shape == (2,)


def test_beam_len_penalty_rescoring_wire_matches_in_process(trained):
    """``len_penalty`` on a beam request rescores the final n-best
    (``beam_end`` carries the penalized order); the wire result equals
    the in-process ``generate_beam(len_penalty=...)``, which is
    ``gnmt_rescore_nbest`` over the raw n-best; ``len_penalty`` without
    ``beam`` is a typed reject."""
    src = trained["src"]
    sess = _beam_session(trained)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        events = []
        got_t, got_s = cl.generate_beam(src[0], src_len=SEQ,
                                        len_penalty=2.0,
                                        on_event=events.append)
        end = [e for e in events if e["event"] == "beam_end"][0]
        assert end["len_penalty"] == 2.0
        assert sorted(end["order"]) == [0, 1]
        with pytest.raises(ServingError, match="beam=true"):
            list(cl.generate(src[0], src_len=SEQ, len_penalty=0.6))
        cl.close()
    assert _drained(sess)
    want_t, want_s = sess.generate_beam(src[0], SEQ, len_penalty=2.0)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_s, want_s)
    raw_t, raw_s = sess.generate_beam(src[0], SEQ)
    order, re_t, re_s = transformer.gnmt_rescore_nbest(raw_t, raw_s,
                                                       sess._eos, 2.0)
    np.testing.assert_array_equal(re_t, want_t)
    np.testing.assert_array_equal(re_s, want_s)
    assert sorted(int(i) for i in order) == [0, 1]


def test_generate_backlog_exceeding_slots_completes_concurrently(
        trained):
    """6 concurrent wire streams over a 4-slot pool: the overflow rides
    the session's queue; every stream completes and equals the greedy
    oracle (greedy decode is slot-independent, so the nondeterministic
    admission order cannot change the tokens)."""
    src = trained["src"]
    sess = _paged(trained, prefix_cache_pages=0)
    oracle = _paged(trained, prefix_cache_pages=0)
    results = {}
    errors = []
    with ServingFrontend(session=sess) as fe:

        def one(i):
            cl = ServingClient(fe.address)
            try:
                results[i] = cl.generate_full(src[i], src_len=SEQ)
            except Exception as exc:  # noqa: BLE001 - collected
                errors.append(exc)
            finally:
                cl.close()

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert _drained(sess)
    assert not errors, errors[:3]
    want = oracle.generate(src[:6], [SEQ] * 6)
    for i in range(6):
        assert np.array_equal(results[i][0], want[i]), "row %d" % i


def test_client_disconnect_mid_stream_reclaims_pool(trained):
    src = trained["src"]
    sess = _paged(trained)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        cl.generate_full(src[0], src_len=SEQ)
        gen = cl.generate(src[2], src_len=SEQ)
        next(gen)
        # hard kill: close the socket without a cancel line — only the
        # substrate's close callback can reclaim
        cl.close()
        assert _drained(sess), (
            "disconnect did not reclaim: live=%r pending=%r "
            "conserved=%r" % (sess.active_slots, sess.pending_requests,
                              sess.pool_conserved))
        assert sess.free_slots == S
        assert sess.free_pages == sess._P - 1 - sess.cached_pages
        cl2 = ServingClient(fe.address)
        out = cl2.generate_full(src[2], src_len=SEQ)
        assert out.shape == (1, SEQ)
        cl2.close()


def test_inband_cancel_reclaims_and_connection_stays_usable(trained):
    src = trained["src"]
    sess, oracle = _paged(trained), _paged(trained)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        gen = cl.generate(src[3], src_len=SEQ)
        next(gen)
        gen.close()  # sends the in-band cancel, drains the ack
        assert _drained(sess)
        assert sess.pool_conserved and sess.free_slots == S
        wire = cl.generate_full(src[4], src_len=SEQ)  # same connection
        cl.close()
    slot = oracle.admit(src[3], SEQ)
    oracle.cancel(slot)
    want = oracle.generate(src[4][None, :], [SEQ])
    assert np.array_equal(wire[0], want[0])


def test_session_cancel_is_conservation_clean(trained):
    src = trained["src"]
    sess = _paged(trained)
    slots = sess.admit_group(src[0], n=2, src_len=SEQ,
                             prefix_tokens=[int(t) for t in src[0][:4]])
    assert sess.cancel(slots[0]) is True
    assert sess.cancel(slots[0]) is False  # idempotent
    assert sess.pool_conserved
    sess.step()  # the surviving member decodes on
    if slots[1] in sess.active_slots:
        assert sess.cancel(slots[1]) is True
    assert sess.pool_conserved and sess.free_slots == S
    assert sess.free_pages == sess._P - 1 - sess.cached_pages


def test_close_drain_false_fails_streams_typed_and_reclaims(trained):
    src = trained["src"]
    sess = _paged(trained)
    fe = ServingFrontend(session=sess)
    cl = ServingClient(fe.address)
    gen = cl.generate(src[5], src_len=SEQ)
    next(gen)
    got = []

    def drain():
        try:
            for _ in gen:
                pass
        except Exception as exc:  # noqa: BLE001 - asserted below
            got.append(exc)

    t = threading.Thread(target=drain)
    t.start()
    fe.close(drain=False)
    t.join(timeout=30)
    assert not t.is_alive(), "stream consumer hung across close"
    if got:  # either the typed close error or the severed connection
        assert isinstance(got[0], (ServerClosedError, StreamBrokenError,
                                   ConnectionError, OSError)), got[0]
    assert _drained(sess)
    cl.close()


def test_bad_request_is_typed_and_worker_survives(trained):
    """A forced prefix on a DENSE session is refused with a typed wire
    error from the admission path; the decode worker lives on."""
    src = trained["src"]
    sess = SlotDecodeSession(
        trained["exe"], num_slots=S, max_length=SEQ, d_model=D,
        paged=False, scope=trained["scope"].new_scope(), **CFG)
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        with pytest.raises(ServingError):
            cl.generate_full(src[0], src_len=SEQ, prefix_tokens=[3, 4])
        out = cl.generate_full(src[0], src_len=SEQ)
        assert out.shape == (1, SEQ)
        cl.close()


def test_snapshot_endpoints_are_typed_refusals(trained):
    sess = _paged(trained)
    with pytest.raises(ValueError, match="snapshot"):
        ServingFrontend(session=sess, snapshot_manager=object())
    with ServingFrontend(session=sess) as fe:
        cl = ServingClient(fe.address)
        for method in ("snapshot", "restore", "attach"):
            with pytest.raises(ServingError,
                               match="no snapshot manager"):
                cl._request(method=method, id=0)
        cl.close()


# ---------------------------------------------------------------------------
# ops endpoints
# ---------------------------------------------------------------------------

def test_metrics_health_stats_endpoints(demo_predictor, trained):
    server = BatchingServer(demo_predictor, max_batch=8, workers=1)
    sess = _paged(trained)
    with server, ServingFrontend(server=server, session=sess) as fe:
        cl = ServingClient(fe.address)
        cl.predict({"x": np.zeros((2, 12), dtype="float32")})
        cl.generate_full(trained["src"][6], src_len=SEQ)
        text = cl.metrics()
        assert "paddle_tpu_frontend_request_seconds" in text
        assert "paddle_tpu_frontend_active_connections" in text
        assert "paddle_tpu_frontend_bytes_sent_total" in text
        assert "paddle_tpu_frontend_ttft_seconds" in text
        health = cl.health()
        assert health == {"server": "healthy", "decode": "healthy"}
        stats = cl.stats()
        assert stats["requests"]["predict"]["ok"] >= 1
        assert stats["requests"]["generate"]["ok"] >= 1
        assert stats["active_connections"] >= 1
        assert stats["bytes_sent"] > 0 and stats["bytes_received"] > 0
        assert stats["decode"]["pool_conserved"] is True
        assert cl.take_result(10 ** 9) is None
        cl.close()


def test_request_traces_over_the_wire(trained):
    """With tracing on, the client mints an id, the frontend and the
    session continue it, and the finished trace holds the queue,
    prefill and decode spans and the tokens streamed."""
    sess = _paged(trained)
    tracing.enable(True)
    try:
        with ServingFrontend(session=sess) as fe:
            cl = ServingClient(fe.address)
            out = cl.generate_full(trained["src"][1], src_len=SEQ)
            rec = None
            deadline = time.monotonic() + 10.0
            while rec is None and time.monotonic() < deadline:
                rec = cl.trace()
                time.sleep(0.01)
            cl.close()
    finally:
        tracing.enable(False)
    assert rec is not None and rec["outcome"] == "ok"
    names = {sp["name"] for sp in rec["spans"]}
    assert {"queue", "prefill", "decode.step"} <= names, names
    generated = int(np.sum(out[0, 1:] != 2)) + 1  # through the eos
    assert rec["stats"]["tokens"] == min(generated, SEQ - 1)


# ---------------------------------------------------------------------------
# chaos: net.accept / net.send + classified retry — never a hang
# ---------------------------------------------------------------------------

def test_net_accept_fault_is_survived_by_reconnect(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8, workers=1)
    with server, ServingFrontend(server=server) as fe:
        flags.set_flag("chaos_spec", "seed=3;io@site=net.accept,n=1")
        chaos.configure()
        cl = ServingClient(fe.address)
        out = cl.predict({"x": np.zeros((2, 12), dtype="float32")})
        assert len(out) == 1
        assert chaos.fires("net.accept") == 1, "the fault never fired"
        cl.close()


def test_net_send_fault_unary_is_retried(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8, workers=1)
    with server, ServingFrontend(server=server) as fe:
        flags.set_flag("chaos_spec", "seed=3;io@site=net.send,n=1")
        chaos.configure()
        cl = ServingClient(fe.address)
        out = cl.predict({"x": np.zeros((2, 12), dtype="float32")})
        assert len(out) == 1
        assert chaos.fires("net.send") == 1
        cl.close()


def test_net_send_fault_mid_stream_is_typed_never_a_hang(trained):
    src = trained["src"]
    sess = _paged(trained)
    with ServingFrontend(session=sess) as fe:
        # skip the queued/admitted/first-token sends, then sever: the
        # client has consumed tokens, so the break surfaces typed
        flags.set_flag("chaos_spec",
                       "seed=3;io@site=net.send,skip=3,n=1")
        chaos.configure()
        cl = ServingClient(fe.address)
        t0 = time.monotonic()
        with pytest.raises(StreamBrokenError):
            cl.generate_full(src[7], src_len=SEQ)
        assert time.monotonic() - t0 < 30.0, "broken stream hung"
        assert chaos.fires("net.send") == 1
        chaos.disable()
        assert _drained(sess)
        assert sess.pool_conserved
        cl.close()


def test_client_reads_are_watchdog_armed(demo_predictor, monkeypatch):
    from paddle_tpu_torch.serving import client as client_mod

    armed = []
    monkeypatch.setattr(client_mod._watchdog, "ENABLED", True)
    real_arm = client_mod._watchdog.arm

    def spy_arm(tag="work", scale=1):
        armed.append(tag)
        return real_arm(tag, scale)

    monkeypatch.setattr(client_mod._watchdog, "arm", spy_arm)
    server = BatchingServer(demo_predictor, max_batch=8, workers=1)
    with server, ServingFrontend(server=server) as fe:
        cl = ServingClient(fe.address)
        cl.predict({"x": np.zeros((2, 12), dtype="float32")})
        cl.close()
    assert "net.recv" in armed


def test_client_survives_frontend_restart(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8, workers=1)
    req = {"x": np.zeros((2, 12), dtype="float32")}
    with server:
        fe = ServingFrontend(server=server)
        host, port = fe.address
        cl = ServingClient(fe.address)
        want = cl.predict(req)
        fe.close()
        # restart on the SAME port: the client's reconnect-retry-once
        # rides through the severed connection
        fe2 = ServingFrontend(server=server, host=host, port=port)
        got = cl.predict(req)
        assert np.array_equal(got[0], want[0])
        cl.close()
        fe2.close()
