"""The port's serving host plane in process: ``BatchingServer`` over a
saved model, graceful degradation, classified retry and the serving
chaos sites.

Mirrors tests/test_serving.py's BatchingServer tests and the
health-monitor, brownout / shed and admit-chaos tests of
tests/test_serving_resilience.py, on the port's ``Predictor`` (the demo
MLP of ``serving/loadgen.py``) and a 2-layer, d_model 64 Transformer
trained a few Adam steps on a copy task (greedy decode: the port serves
no sampler yet).

Tolerances: a request that rides a padded batch with others is held to
its ``run_reference`` (the same request alone, padded to its own rung)
within 1e-6 relative. The CPU's matrix products may round the last bit
differently at another batch size; the JAX package's XLA CPU GEMM
misses its own "bit-identical" claim by one ulp, 1.49e-8 absolute
(1.5e-7 relative). Where the port computes the same thing (a request
alone at its rung, a request whose size is its rung through
``run_reference`` and ``Predictor.run``) the results are equal.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags
from paddle_tpu_torch.executor import FetchTimeoutError
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.resilience import chaos, retry
from paddle_tpu_torch.serving import (
    BatchingServer,
    DeadlineExceededError,
    QueueFullError,
    ServerClosedError,
    ServingError,
    loadgen,
)
from paddle_tpu_torch.serving.degradation import (
    BROWNOUT,
    HEALTHY,
    SHED,
    DegradedError,
    HealthMonitor,
)
from paddle_tpu_torch.serving.generation import SlotDecodeSession
from paddle_tpu_torch.serving.kv_pool import PagePool
from paddle_tpu_torch.testing import fresh_state

BATCH_RTOL = 1e-6
VOCAB, SEQ, D, S = 24, 8, 64, 4
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=2,
           n_head=2, d_inner=64)


@pytest.fixture(autouse=True)
def _clean_chaos_and_flags():
    with fresh_state():
        yield
    chaos.disable()
    flags.set_flag("dispatch_retries", 0)


@pytest.fixture(scope="module")
def demo_predictor(tmp_path_factory):
    # one train + save serves every server test: servers clone it and
    # never write the weights after load
    path = str(tmp_path_factory.mktemp("serving") / "model")
    with fresh_state():
        loadgen.build_demo_model(path)
    return create_paddle_predictor(NativeConfig(model_dir=path,
                                                use_tpu=False))


def train_copy_transformer(steps=30, seed=41):
    """A 2-layer, d_model 64 Transformer trained ``steps`` Adam steps on
    a copy task, so that different sources decode differently. Returns
    (executor, scope holding the parameters)."""
    with fresh_state():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
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
        for _ in range(steps):
            src = rng.randint(3, VOCAB, (16, SEQ)).astype("int64")
            trg = np.full_like(src, 1)
            trg[:, 1:] = src[:, :-1]
            exe.run(main, feed={
                "src_word": src, "src_len": np.full((16, 1), SEQ, "int64"),
                "trg_word": trg, "trg_len": np.full((16, 1), SEQ, "int64"),
                "label": src}, fetch_list=[loss], scope=scope)
    return exe, scope


@pytest.fixture(scope="module")
def trained():
    exe, scope = train_copy_transformer()
    rng = np.random.RandomState(7)
    src = rng.randint(3, VOCAB, (8, SEQ)).astype("int64")
    src_len = np.asarray([SEQ, 3, SEQ - 1, 5, SEQ, 4, SEQ - 2, SEQ],
                         "int64")
    return {"exe": exe, "scope": scope, "src": src, "src_len": src_len}


def _paged(trained, **kw):
    # every session gets its own child of the trained scope: the
    # parameters resolve through the parent, the decode state is its own
    args = dict(num_slots=S, max_length=SEQ, d_model=D, paged=True,
                page_size=4, steps=2, num_groups=2, prefix_cache_pages=8,
                scope=trained["scope"].new_scope())
    args.update(CFG)
    args.update(kw)
    return SlotDecodeSession(trained["exe"], **args)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=BATCH_RTOL, atol=0)


# -- bucketed batching -------------------------------------------------------

def test_batched_results_match_reference_across_mixed_buckets(
        demo_predictor):
    """Twin of test_batched_results_bit_identical_across_mixed_buckets:
    requests of every odd size, submitted at once so they coalesce into
    padded bucket batches, come back equal to ``run_reference`` within
    1e-6 relative, padding sliced off; a request whose size is its rung
    is ALSO its raw ``Predictor.run``, exactly."""
    server = BatchingServer(demo_predictor, max_batch=8, workers=2,
                            batch_linger_s=0.01)
    try:
        requests = loadgen.demo_requests(24)
        futures = [server.submit(r) for r in requests]
        got = [f.result(timeout=30) for f in futures]
        rungs = set(server.stats()["batch_buckets"])
        assert rungs == {2, 4, 8}
        for req, outs in zip(requests, got):
            want = server.run_reference(req)
            assert len(outs) == len(want)
            _close(outs, want)
            assert outs[0].shape[0] == req["x"].shape[0]  # pad sliced off
            if req["x"].shape[0] in rungs:
                for r, w in zip(want, demo_predictor.run(req)):
                    np.testing.assert_array_equal(r, w)
        assert server.stats()["batches"] < len(requests)  # coalesced
    finally:
        server.close()


def test_request_alone_at_its_rung_is_exact(demo_predictor):
    """One request at a time: the batch IS the request padded to its
    rung, the computation ``run_reference`` does, so the rows are
    equal."""
    server = BatchingServer(demo_predictor, max_batch=8, workers=1,
                            batch_linger_s=0.0)
    try:
        for req in loadgen.demo_requests(8, seed=3):
            got = server.run(req)
            for g, w in zip(got, server.run_reference(req)):
                np.testing.assert_array_equal(g, w)
    finally:
        server.close()


def test_mixed_sizes_resolve_to_ladder(demo_predictor):
    """After warmup over the ladder, a mixed-size load dispatches only
    ladder shapes."""
    server = BatchingServer(demo_predictor, max_batch=8, workers=1)
    before = {r: _batches(r) for r in (1, 2, 3, 4, 5, 6, 7, 8)}
    try:
        assert server.warmup() == [2, 4, 8]
        wall, ok, errors = loadgen.replay(
            server, loadgen.demo_requests(32), concurrency=4)
        assert ok == 32 and not errors
        st = server.stats()
        assert st["batches"] >= 1
        assert st["latency_ms"]["p99_ms"] is not None
        used = {r for r in before if _batches(r) > before[r]}
        assert used and used <= {2, 4, 8}
        assert sum(_batches(r) - before[r] for r in before) \
            == st["batches"]
    finally:
        server.close()


def _batches(rung):
    return REGISTRY.counter(
        "paddle_tpu_serving_batches_total",
        "batches dispatched, by bucket (padded batch rows)",
        labels=("bucket",)).value(bucket=str(rung))


def test_clone_multitenant_under_load(demo_predictor):
    """4 worker threads = 4 Predictor clones sharing the weights."""
    server = BatchingServer(demo_predictor, max_batch=8, workers=4,
                            batch_linger_s=0.001)
    try:
        server.warmup()
        wall, ok, errors = loadgen.replay(
            server, loadgen.demo_requests(48), concurrency=8)
        assert ok == 48 and not errors
    finally:
        server.close()


# -- admission control -------------------------------------------------------

def test_queue_full_rejects_with_typed_error(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8,
                            max_queue_depth=2, batch_linger_s=5.0)
    try:
        f1 = server.submit({"x": np.zeros((1, 12), "float32")})
        f2 = server.submit({"x": np.zeros((1, 12), "float32")})
        with pytest.raises(QueueFullError):
            server.submit({"x": np.zeros((1, 12), "float32")})
        server.close(drain=True)  # drain skips the linger
        assert len(f1.result(timeout=30)[0]) == 1
        assert f2.done()
    finally:
        server.close()


def test_deadline_lapses_in_queue(demo_predictor):
    """A deadlined request stuck behind a slow batch is expired from the
    queue, never dispatched."""

    class SlowRun(object):
        def __init__(self, real):
            self._real = real
            self.feed_names = real.feed_names
            self.feed_shapes = real.feed_shapes

        def clone(self):
            return self

        def run(self, inputs):
            return self._real.run(inputs)

        def run_async(self, inputs):
            time.sleep(0.3)  # the worker is wedged on this batch
            return self._real.run_async(inputs)

    server = BatchingServer(SlowRun(demo_predictor), max_batch=8,
                            batch_linger_s=0.0, workers=1)
    try:
        first = server.submit({"x": np.zeros((1, 12), "float32")})
        fut = server.submit({"x": np.zeros((1, 12), "float32")},
                            deadline_s=0.05)
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=30)
        assert len(first.result(timeout=30)[0]) == 1
    finally:
        server.close(drain=False)


def test_deadline_lapses_in_flight(demo_predictor):
    """Twin of the reference's test of the same name: a dispatched batch
    that outlives its latest deadline is rejected through
    ``FetchHandle.result(timeout=...)``; the patient request in the same
    batch is served late (within 1e-6 relative of ``run_reference``:
    it rode a 4-row batch, the oracle a 2-row one) and the server stays
    live."""

    class SlowHandle(object):
        def __init__(self, inner):
            self._inner = inner

        def result(self, timeout=None):
            if timeout is not None:
                time.sleep(timeout)  # the card never ready in time
                raise FetchTimeoutError(timeout, ["out"])
            return self._inner.result()

    class SlowPredictor(object):
        def __init__(self, real):
            self._real = real
            self.feed_names = real.feed_names
            self.feed_shapes = real.feed_shapes

        def clone(self):
            return self

        def run(self, inputs):
            return self._real.run(inputs)

        def run_async(self, inputs):
            return SlowHandle(self._real.run_async(inputs))

    server = BatchingServer(SlowPredictor(demo_predictor), max_batch=8,
                            batch_linger_s=0.2)
    try:
        patient = np.ones((1, 12), "float32")
        fut_patient = server.submit({"x": patient})
        fut_deadline = server.submit({"x": np.zeros((2, 12), "float32")},
                                     deadline_s=0.05)
        with pytest.raises(DeadlineExceededError):
            fut_deadline.result(timeout=30)
        out = fut_patient.result(timeout=30)
        _close(out, server.run_reference({"x": patient}))
        out = server.run({"x": np.ones((1, 12), "float32")})
        assert out[0].shape == (1, 3)
    finally:
        server.close()


def test_submit_validation_and_close_semantics(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=4)
    with pytest.raises(ServingError):
        server.submit({"x": np.zeros((5, 12), "float32")})  # > max_batch
    with pytest.raises(ServingError):
        server.submit({"wrong": np.zeros((1, 12), "float32")})
    with pytest.raises(ServingError):
        server.submit({"x": np.zeros((1, 7), "float32")})  # bad dim
    out = server.run([np.zeros((2, 12), "float32")])  # positional form
    assert out[0].shape == (2, 3)
    server.close()
    with pytest.raises(ServerClosedError):
        server.submit({"x": np.zeros((1, 12), "float32")})


def test_pad_buckets_group_dynamic_lengths():
    class StubPredictor(object):
        feed_names = ["x"]
        feed_shapes = {"x": (-1, -1)}

        def clone(self):
            return self

    server = BatchingServer(StubPredictor(), max_batch=4,
                            pad_buckets={"x": ((1,), (8, 16))})
    try:
        a, _ = server._normalize({"x": np.ones((1, 5), "float32")})
        b, _ = server._normalize({"x": np.ones((1, 8), "float32")})
        a = server._pad_request(a)
        b = server._pad_request(b)
        assert a["x"].shape == b["x"].shape == (1, 8)
        assert a["x"][0, 5:].sum() == 0  # padded with pad_value
        with pytest.raises(ServingError):
            server._pad_request({"x": np.ones((1, 17), "float32")})
    finally:
        server.close()


def test_deadline_inside_linger_dispatches_early(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8,
                            batch_linger_s=2.0)
    try:
        out = server.submit({"x": np.zeros((1, 12), "float32")},
                            deadline_s=0.5).result(timeout=30)
        assert out[0].shape == (1, 3)  # served, not deadline-rejected
    finally:
        server.close()


def test_warmup_covers_every_pad_rung():
    class ShapeRecorder(object):
        feed_names = ["x"]
        feed_shapes = {"x": (-1, -1)}
        feed_dtypes = {"x": "float32"}

        def __init__(self):
            self.shapes = []

        def clone(self):
            return self

        def run(self, inputs):
            self.shapes.append(inputs["x"].shape)
            return [np.zeros((inputs["x"].shape[0], 2), "float32")]

    rec = ShapeRecorder()
    server = BatchingServer(rec, max_batch=4,
                            pad_buckets={"x": ((1,), (4, 8))})
    try:
        server.warmup()
        assert set(rec.shapes) == {(b, d) for b in (2, 4) for d in (4, 8)}
    finally:
        server.close()


def test_batch_reduced_fetch_is_a_typed_error():
    class PooledPredictor(object):
        feed_names = ["x"]
        feed_shapes = {"x": (-1, 12)}

        def clone(self):
            return self

        def run(self, inputs):
            return [inputs["x"].sum(axis=0, keepdims=True)]  # [1, 12]

        def run_async(self, inputs):
            outs = self.run(inputs)

            class H(object):
                def result(self, timeout=None):
                    return outs

            return H()

    server = BatchingServer(PooledPredictor(), max_batch=4)
    try:
        with pytest.raises(ServingError, match="leading dim"):
            server.run({"x": np.ones((2, 12), "float32")})
        with pytest.raises(ServingError, match="leading dim"):
            server.run_reference({"x": np.ones((2, 12), "float32")})
    finally:
        server.close()


def test_server_metrics_exported(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=4)
    try:
        server.run({"x": np.zeros((3, 12), "float32")})
        with pytest.raises(DeadlineExceededError):
            server.submit({"x": np.zeros((1, 12), "float32")},
                          deadline_s=0.0).result(timeout=30)
        text = REGISTRY.to_prometheus()
        assert 'paddle_tpu_serving_requests_total{outcome="ok"}' in text
        assert "paddle_tpu_serving_request_seconds_bucket" in text
        assert "paddle_tpu_serving_batch_occupancy_count" in text
        assert "paddle_tpu_serving_queue_depth" in text
        assert 'paddle_tpu_serving_requests_total{outcome="deadline"}' \
            in text
    finally:
        server.close()


def test_serving_capture_record(demo_predictor):
    server = BatchingServer(demo_predictor, max_batch=8, workers=2)
    try:
        lat = []
        wall, ok, errors = loadgen.replay(
            server, loadgen.demo_requests(16), concurrency=4,
            latencies=lat)
        rec = loadgen.serving_capture(server, ok, wall)
        assert ok == 16 and not errors and len(lat) == 16
        assert rec["requests_ok"] == 16 and rec["value"] > 0
        assert set(rec["batch_buckets"]) == {2, 4, 8}
        wire = loadgen.wire_capture(ok, wall, lat, ttft_s=[0.1, 0.3, 0.2])
        assert wire["ttft_ms"] == 200.0
        assert wire["latency_ms_p50"] <= wire["latency_ms_p99"]
    finally:
        server.close()


# -- degradation -------------------------------------------------------------

def test_health_monitor_hysteresis_and_metrics():
    mon = HealthMonitor("unit", brownout_at=0.5, shed_at=0.9,
                        recover_at=0.3)
    assert mon.observe(0.2) == HEALTHY
    assert mon.observe(0.6) == BROWNOUT
    assert mon.observe(0.4) == BROWNOUT  # hysteresis band: hold
    assert mon.observe(0.95) == SHED
    assert mon.observe(0.6) == SHED      # brownout band can't relax shed
    assert mon.observe(0.1) == BROWNOUT  # one level per crossing
    assert mon.observe(0.1) == HEALTHY
    assert mon.transitions == 4
    err = mon.reject("unit test")
    assert isinstance(err, DegradedError)
    assert err.retry_after_s > 0
    assert retry.is_transient(err), "DegradedError must classify retriable"
    text = REGISTRY.to_prometheus()
    assert 'paddle_tpu_serving_health{component="unit"} 0' in text
    assert "paddle_tpu_serving_health_transitions_total" in text


def test_decode_brownout_evicts_cache_refuses_forks_then_recovers(
        trained):
    src, src_len = trained["src"], trained["src_len"]
    sess = _paged(trained, num_groups=S,
                  degradation=dict(brownout_at=0.5, shed_at=0.95,
                                   recover_at=0.3))
    pfx = [int(x) for x in src[0][:5]]
    sess.admit(src[0], int(src_len[0]), prefix_tokens=pfx)
    assert sess.cached_pages > 0 and sess.health == HEALTHY
    sess.admit(src[1], int(src_len[1]))
    sess.admit(src[2], int(src_len[2]))
    assert sess.health == BROWNOUT
    assert sess.cached_pages == 0  # brownout evicted the prefix cache
    with pytest.raises(DegradedError) as exc_info:
        sess.admit_group(src[3], n=2, src_len=int(src_len[3]))
    assert exc_info.value.state == BROWNOUT
    assert exc_info.value.retry_after_s > 0
    sess.admit(src[3], int(src_len[3]))  # solo admission still served
    with pytest.raises(DegradedError) as exc_info:
        sess.admit(src[4], int(src_len[4]))
    assert exc_info.value.state == SHED
    for _ in range(30):  # drain: each step observes the falling load
        if not sess.active_slots:
            break
        sess.step()
    sess.admit(src[4], int(src_len[4]))
    for _ in range(30):
        if not sess.active_slots:
            break
        sess.step()
    assert sess.health == HEALTHY
    assert sess.pool_conserved


def test_generate_survives_degradation_by_deferring(trained):
    """admit_pending treats a DegradedError like a pool reject: defer to
    the queue front and drain; greedy streams equal an undegraded
    session's."""
    src, src_len = trained["src"], trained["src_len"]
    sess = _paged(trained, degradation=dict(brownout_at=0.5, shed_at=0.75,
                                            recover_at=0.5))
    clean = _paged(trained)
    got = sess.generate(src, src_len)
    want = clean.generate(src, src_len)
    np.testing.assert_array_equal(got, want)
    assert sess.free_slots == S and sess.pages_in_use == sess.cached_pages


def test_server_shed_types_rejects_and_recovers(demo_predictor):
    server = BatchingServer(
        demo_predictor, max_batch=8, workers=1, max_queue_depth=8,
        batch_linger_s=0.05,
        degradation=dict(brownout_at=0.5, shed_at=0.75, recover_at=0.25,
                         retry_after_s=0.1))
    reqs = loadgen.demo_requests(16)
    futures, rejects = [], []
    with server:
        for req in reqs:
            try:
                futures.append(server.submit(req))
            except DegradedError as exc:
                assert exc.state == SHED
                assert exc.retry_after_s == 0.1
                rejects.append(exc)
        assert rejects, "the flood never tripped shed"
        for fut in futures:
            fut.result(timeout=30.0)
        for req in reqs:  # resubmit the rejected volume: serving again
            server.run(req)
        stats = server.stats()
    assert stats["health"] == HEALTHY
    assert stats["degraded"] == len(rejects)
    text = REGISTRY.to_prometheus()
    assert 'paddle_tpu_serving_health{component="server"} 0' in text


# -- chaos + retry on serving paths ------------------------------------------

def _retries(origin):
    return REGISTRY.counter(
        "paddle_tpu_retries_total", "transient-failure retries by origin",
        ["origin"]).value(origin=origin)


def test_admit_chaos_fault_rolls_back_and_retries_exact(trained):
    src, src_len = trained["src"], trained["src_len"]
    pfx = [int(x) for x in src[0][:5]]
    clean = _paged(trained)
    want = clean.generate_best_of(src[0], 2, src_len=int(src_len[0]),
                                  prefix_tokens=pfx)
    before = _retries("serve.admit")
    chaos.configure("seed=3;io@site=serve.admit,n=1")
    flags.set_flag("dispatch_retries", 2)
    sess = _paged(trained)
    got = sess.generate_best_of(src[0], 2, src_len=int(src_len[0]),
                                prefix_tokens=pfx)
    assert chaos.fires("serve.admit") == 1, "the fault never fired"
    np.testing.assert_array_equal(got, want)
    assert _retries("serve.admit") == before + 1
    assert sess._leaked_pages == 0  # rollback left the books clean


def test_admit_chaos_fault_without_retries_is_clean_rollback(trained):
    src, src_len = trained["src"], trained["src_len"]
    sess = _paged(trained)
    free_pages = sess.free_pages
    chaos.configure("io@site=serve.admit,n=1")
    with pytest.raises(IOError):
        sess.admit_group(src[0], n=2, src_len=int(src_len[0]))
    chaos.disable()
    assert sess.free_slots == S and sess.free_groups == 2
    assert sess.free_pages == free_pages and sess._reserved_pages == 0
    slots = sess.admit_group(src[0], n=2, src_len=int(src_len[0]))
    assert slots == [0, 1], "rollback changed the slot order"


def test_step_dispatch_is_a_chaos_site(trained):
    """``serve.dispatch`` fires entering step(); the session's books are
    untouched and the next step serves on."""
    src = trained["src"]
    sess = _paged(trained)
    sess.admit(src[0], SEQ)
    chaos.configure("io@site=serve.dispatch,n=1")
    with pytest.raises(IOError):
        sess.step()
    chaos.disable()
    assert not sess.in_dispatch and sess.active_slots == [0]
    while sess.active_slots:
        sess.step()
    assert sess.pool_conserved


def test_pool_acquire_is_a_chaos_site():
    pool = PagePool(4)
    chaos.configure("io@site=pool.acquire,n=1")
    with pytest.raises(IOError):
        pool.acquire()
    chaos.disable()
    assert pool.free_count == 3  # the faulted acquire allocated nothing
    assert pool.acquire() in (1, 2, 3)


def test_retry_classification_and_budget():
    import torch

    assert retry.is_transient(ConnectionError("reset"))
    assert retry.is_transient(chaos.ChaosIOError("x"))
    assert not retry.is_transient(ValueError("user"))
    assert not retry.is_transient(torch.cuda.OutOfMemoryError("oom"))
    assert not retry.is_transient(RuntimeError(
        "NaN/Inf detected in variable 'x' after program run "
        "(FLAGS_check_nan_inf)"))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("flake %d" % len(calls))
        return "ok"

    flags.set_flag("retry_backoff_s", 0.0)
    try:
        with pytest.raises(ConnectionError):
            retry.call(flaky, origin="unit", retries=1)
        calls.clear()
        assert retry.call(flaky, origin="unit", retries=2) == "ok"
        assert len(calls) == 3
    finally:
        flags.set_flag("retry_backoff_s", 0.05)


def test_concurrent_submitters_get_their_own_rows(demo_predictor):
    """Eight threads submit distinct requests at once: each gets back
    its own rows (within 1e-6 relative of its oracle), never another
    request's."""
    server = BatchingServer(demo_predictor, max_batch=8, workers=2,
                            batch_linger_s=0.005)
    reqs = loadgen.demo_requests(32, seed=11)
    got, errors = {}, []

    def one(i):
        try:
            got[i] = server.run(reqs[i])
        except Exception as exc:  # noqa: BLE001 - collected
            errors.append(exc)

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:3]
        for i, req in enumerate(reqs):
            _close(got[i], server.run_reference(req))
    finally:
        server.close()


# -- observability the serving plane writes into -----------------------------

def test_executor_feeds_the_step_window_the_watchdog_reads(demo_predictor):
    """With telemetry on, each ``Executor`` dispatch lands in the
    step-time window; the watchdog's automatic timeout is a multiple of
    its p95 (floored), and ``run_async`` counts without entering the
    percentiles."""
    from paddle_tpu_torch.observability import telemetry, watchdog

    telemetry.reset()
    telemetry.enable(True)
    try:
        req = {"x": np.zeros((2, 12), "float32")}
        for _ in range(5):
            demo_predictor.run(req)
        demo_predictor.run_async(req).result()
        st = telemetry.step_stats()
        auto = watchdog.effective_timeout()
    finally:
        telemetry.enable(False)
        telemetry.reset()
    assert st["count"] == 6
    assert 0 < st["p50_ms"] <= st["p95_ms"] <= st["p99_ms"]
    assert auto == max(st["p95_ms"] / 1e3 * watchdog._AUTO_MULT,
                       watchdog._AUTO_MIN)
    assert watchdog.effective_timeout() == watchdog._AUTO_DEFAULT
    with pytest.raises(NotImplementedError, match="A9"):
        telemetry.peak_flops()


def test_watchdog_declares_a_stalled_dispatch_and_dumps(demo_predictor,
                                                        tmp_path):
    """A batch dispatch that never completes: the watchdog, armed around
    the server's dispatch, declares the hang and the black box dumps the
    thread stacks and its events."""
    import json

    from paddle_tpu_torch.observability import blackbox, watchdog

    release = threading.Event()

    class StuckPredictor(object):
        feed_names = demo_predictor.feed_names
        feed_shapes = demo_predictor.feed_shapes

        def clone(self):
            return self

        def run_async(self, inputs):
            release.wait(10)
            return demo_predictor.run_async(inputs)

    hangs = []
    dump = str(tmp_path / "blackbox.json")
    blackbox.enable(dump, handlers=False)
    watchdog.start(timeout=0.2, on_hang=hangs.append, abort=False)
    server = BatchingServer(StuckPredictor(), max_batch=4,
                            batch_linger_s=0.0)
    try:
        fut = server.submit({"x": np.zeros((1, 12), "float32")})
        deadline = time.monotonic() + 10
        while not hangs and time.monotonic() < deadline:
            time.sleep(0.02)
        release.set()
        assert fut.result(timeout=30)[0].shape == (1, 3)
    finally:
        release.set()
        server.close()
        watchdog.stop()
        blackbox.disable()
    assert hangs and hangs[0]["stalled"][0]["tag"] == "serve.dispatch"
    with open(dump) as f:
        snap = json.load(f)
    assert snap["reason"] == "watchdog_hang"
    assert any("serve.dispatch" in json.dumps(e) for e in snap["events"])
    assert snap["recompiles"] == [] and "flags" in snap
