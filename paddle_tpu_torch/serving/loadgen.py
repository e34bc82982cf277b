"""Deterministic serving load generator.

Counterpart of ``paddle_tpu/serving/loadgen.py`` (a copy over the port's
layers and executor): the tiny softmax MLP the serving tests serve
(``build_demo_model``: the same program, seeds and data stream as the
JAX package's), a mixed-batch-size request stream (``demo_requests``),
the closed-loop replay that drives an in-process ``BatchingServer`` or
``ServingClient`` connections through one code path (``replay``), and
the records of a run (``serving_capture``, ``wire_capture``).
"""

import threading
import time

import numpy as np

__all__ = ["build_demo_model", "demo_requests", "replay",
           "serving_capture", "wire_capture",
           "DEMO_FEATURES", "DEMO_CLASSES"]

DEMO_FEATURES = 12
DEMO_CLASSES = 3
# request batch-size mix: deliberately NOT the bucket rungs — the point
# is that odd user sizes resolve to the finite ladder
DEMO_BATCH_MIX = (1, 2, 3, 5, 7, 8, 4, 6)


def build_demo_model(dirname, seed=3, train_steps=30):
    """Train (SGD) + save the tiny softmax MLP the serving tests serve.
    Deterministic per seed (fixed program seeds, fresh name counters, a
    seeded data stream)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.core.scope import Scope

    with unique_name.guard({}):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = seed
        startup.random_seed = seed
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[DEMO_FEATURES],
                                  dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid.layers.fc(input=x, size=24, act="relu")
            pred = fluid.layers.fc(input=h, size=DEMO_CLASSES,
                                   act="softmax")
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=pred, label=y))
            fluid.optimizer.SGD(0.1).minimize(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = Scope()
        rng = np.random.RandomState(seed)
        base = rng.randn(DEMO_CLASSES, DEMO_FEATURES).astype("float32")
        with fluid.scope_guard(scope):
            exe.run(startup)
            for _ in range(train_steps):
                lbl = rng.randint(0, DEMO_CLASSES, 32)
                xb = base[lbl] + 0.2 * rng.randn(
                    32, DEMO_FEATURES).astype("float32")
                exe.run(main, feed={"x": xb, "y": lbl.reshape(-1, 1)},
                        fetch_list=[loss])
            fluid.io.save_inference_model(dirname, ["x"], [pred], exe,
                                          main_program=main)
    return dirname


def demo_requests(n, seed=17):
    """``n`` deterministic requests with a mixed batch-size stream —
    every size in DEMO_BATCH_MIX appears, none above the default
    ladder top."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        rows = DEMO_BATCH_MIX[i % len(DEMO_BATCH_MIX)]
        out.append({"x": rng.randn(rows, DEMO_FEATURES).astype("float32")})
    return out


def replay(server, requests, concurrency=4, deadline_s=None,
           latencies=None):
    """Closed-loop replay: ``concurrency`` client threads round-robin
    the request list, each running its request synchronously (what a
    fleet of synchronous callers looks like, and what makes the
    dispatcher's coalescing window matter). Returns
    ``(wall_seconds, ok_count, error_list)``.

    SOCKET mode — the deterministic wire load generator: pass a zero-arg CALLABLE for ``server`` and each
    client thread builds (and closes) its OWN target from it, e.g.
    ``lambda: ServingClient(frontend.address)`` — one connection per
    synchronous caller, the closed-loop shape a real fleet presents.
    Both ``BatchingServer`` and ``ServingClient`` expose the shared
    ``run(inputs, deadline_s=...)`` entry this drives, so the same
    replay exercises the in-process server or the wire.

    ``latencies``: optional list; per-request wall seconds (successful
    requests only) are appended — client-side numbers for the wire SLO
    gates (``latency_ms_p99`` over real sockets)."""
    errors = []
    ok = [0] * concurrency
    per_req = [[] for _ in range(concurrency)]

    def client(cid):
        try:
            # factory failures (refused connection, restarted frontend)
            # must land in the error list, not die with the thread
            target = server() if callable(server) else server
        except Exception as exc:  # noqa: BLE001 - collected
            errors.append(exc)
            return
        try:
            for req in requests[cid::concurrency]:
                try:
                    t0 = time.perf_counter()
                    target.run(req, deadline_s=deadline_s)
                    per_req[cid].append(time.perf_counter() - t0)
                    ok[cid] += 1
                except Exception as exc:  # noqa: BLE001 - collected
                    errors.append(exc)
        finally:
            if callable(server):
                target.close()

    threads = [threading.Thread(target=client, args=(i,),
                                name="paddle-tpu-loadgen-%d" % i)
               for i in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if latencies is not None:
        for chunk in per_req:
            latencies.extend(chunk)
    return wall, sum(ok), errors


def serving_capture(server, n_ok, wall_s):
    """The record of a serving run: requests/sec plus the SLO numbers
    (latency_ms_p50/p99, batch_occupancy)."""
    st = server.stats()
    lat = st["latency_ms"]

    def r(v, nd=3):
        return round(v, nd) if v is not None else None

    return {
        "metric": "serving_throughput",
        "value": round(n_ok / wall_s, 2) if wall_s else None,
        "unit": "requests/sec",
        "vs_baseline": None,
        "latency_ms_p50": r(lat["p50_ms"]),
        "latency_ms_p99": r(lat["p99_ms"]),
        "batch_occupancy": r(st["mean_occupancy"], 4),
        "batches": st["batches"],
        "batch_buckets": st["batch_buckets"],
        "requests_ok": n_ok,
        "requests_rejected": st["queue_full"] + st["deadline"],
    }


def wire_capture(n_ok, wall_s, latencies, ttft_s=None, traces=None):
    """The record of a NETWORK front-end run: wire-level requests/sec
    plus CLIENT-side latency percentiles (the replay's ``latencies``
    out-param — what the user actually waited, socket included) and the
    stream time-to-first-token (``ttft_s``: one measurement or a list;
    the median lands as ``ttft_ms``).

    ``traces`` (optional): completed trace records
    (``observability.tracing`` ring entries, one per streamed request)
    — their derived stats land as ``ttft_breakdown``: the median split
    of time-to-first-token into queue wait, prefill and the first
    decode dispatch, the attribution a bare ttft_ms can't give."""
    window = sorted(latencies or ())

    def pct(p):
        if not window:
            return None
        idx = min(len(window) - 1, int(round(p * (len(window) - 1))))
        return round(window[idx] * 1000.0, 3)

    if ttft_s is not None and not np.isscalar(ttft_s):
        seq = sorted(float(t) for t in ttft_s)
        ttft_s = seq[len(seq) // 2] if seq else None
    rec = {
        "metric": "frontend_throughput",
        "value": round(n_ok / wall_s, 2) if wall_s else None,
        "unit": "requests/sec",
        "vs_baseline": None,
        "latency_ms_p50": pct(0.50),
        "latency_ms_p99": pct(0.99),
        "ttft_ms": (round(float(ttft_s) * 1000.0, 3)
                    if ttft_s is not None else None),
        "requests_ok": n_ok,
    }
    traces = [t for t in (traces or ()) if t]
    if traces:
        def med(vals):
            seq = sorted(v for v in vals if v is not None)
            return seq[len(seq) // 2] if seq else 0.0

        def first_dispatch_s(rec_t):
            steps = [s for s in rec_t.get("spans", ())
                     if s["name"] == "decode.step"
                     and s["t1"] is not None]
            if not steps:
                return None
            first = min(steps, key=lambda s: s["t0"])
            return first["t1"] - first["t0"]

        stats = [t.get("stats", {}) for t in traces]
        rec["ttft_breakdown"] = {
            "queue_ms": round(med([s.get("queue_s") for s in stats])
                              * 1000.0, 3),
            "prefill_ms": round(med([s.get("prefill_s")
                                     for s in stats]) * 1000.0, 3),
            "first_dispatch_ms": round(
                med([first_dispatch_s(t) for t in traces])
                * 1000.0, 3),
        }
        rec["span_coverage"] = round(
            med([s.get("span_coverage") for s in stats]), 4)
    return rec
