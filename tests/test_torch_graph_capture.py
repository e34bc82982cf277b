"""``Executor.run_multi_step``'s captured path, the parts that need no
card. A stand-in capturer (``exe.graph_capturer``; on a card it is the
CUDA graph one) records the loop body at capture and runs it at each
replay, so the CPU walks the same path as the card: warm-up call, capture
on the second call, replay after; the graph key (a new
``program._version`` is a new key); the eager route of a program with
random ops and its count; the rebind of a scope tensor an eager ``run``
replaced between replays; the launch accounting of a replay
(``kernels/build.py``); and a failed capture naming the op. On the CPU
with no capturer ``run_multi_step`` is the eager loop, held against K
sequential runs and against the JAX package's scan (the cases of
``tests/test_multi_step.py``). Tolerances: 1e-6 relative against the
JAX package (fp32 sums in another order); exact between the port's own
paths (the same ops on the same inputs)."""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags
from paddle_tpu_torch.core import op_registry
from paddle_tpu_torch.kernels import build as kbuild
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params

K = 5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield
    flags.set_flag("cuda_graph", True)


class StandInGraph(object):
    def __init__(self, body):
        self.body = body
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.body()


class StandInCapturer(object):
    """Records the body at capture (nothing runs); replay runs it."""

    def __init__(self):
        self.graphs = []

    def capture(self, body, device):
        self.graphs.append(StandInGraph(body))
        return self.graphs[-1], 0


def _sgd(fluid, seed=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    # fresh names: set_deterministic_params seeds each weight by its name
    with fluid.unique_name.guard({}), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], stop_gradient=False)
        y = fluid.layers.data("y", [1])
        diff = fluid.layers.elementwise_sub(fluid.layers.fc(x, 1), y)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(diff, diff))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(8, 4).astype("float32")
    return {"x": x, "y": x.sum(1, keepdims=True).astype("float32")}


def _torch_setup(capturer=None, seed=3):
    main, startup, loss = _sgd(tfluid, seed)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.graph_capturer = capturer
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope, parameters_only=True)
    return exe, scope, main, loss


def _w(scope, main):
    name = [n for n in main.global_block().vars if n.endswith("w_0")][0]
    return np.asarray(scope.get_value(name)).copy()


def test_multi_step_matches_sequential_runs_and_jax():
    feed = _feed()
    exe, scope, main, loss = _torch_setup()
    seq = [float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])[0]) for _ in range(K)]
    w_seq = _w(scope, main)
    exe, scope, main, loss = _torch_setup()
    params = {p.name: np.asarray(scope.get_value(p.name)).copy()
              for p in main.global_block().all_parameters()}
    (last,) = exe.run_multi_step(main, K, feed=feed, fetch_list=[loss],
                                 scope=scope)
    np.testing.assert_array_equal(_w(scope, main), w_seq)
    assert float(np.ravel(last)[0]) == seq[-1]

    jmain, jstartup, jloss = _sgd(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.core.scope.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        for name, value in params.items():  # the same names
            jscope.set_value(name, value)
        (jlast,) = jexe.run_multi_step(jmain, K, feed=feed,
                                       fetch_list=[jloss])
        jw = _w(jscope, jmain)
    np.testing.assert_allclose(_w(scope, main), jw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.ravel(last), np.ravel(jlast), rtol=1e-6)


def test_multi_step_stacked_fetches_trajectory():
    exe, scope, main, loss = _torch_setup(seed=9)
    (traj,) = exe.run_multi_step(main, 4, feed=_feed(1), fetch_list=[loss],
                                 scope=scope, stack_fetches=True)
    traj = np.asarray(traj).reshape(4)
    assert np.isfinite(traj).all()
    assert (np.diff(traj) < 0).all(), traj
    assert exe.eager_multi_step == 0 and exe.graph_stats()["graphs"] == 0


def test_captured_path_equals_eager_loop():
    """Warm-up (eager), capture + first replay, then replays only: the
    trajectories and the trained weights equal the eager loop's."""
    feed = _feed(2)
    capturer = StandInCapturer()
    exe, scope, main, loss = _torch_setup(capturer)
    got = [np.asarray(exe.run_multi_step(main, 3, feed=feed,
                                         fetch_list=[loss], scope=scope,
                                         stack_fetches=True)[0])
           for _ in range(4)]
    assert len(capturer.graphs) == 1 and capturer.graphs[0].replays == 3
    assert exe.eager_multi_step == 0
    assert exe.graph_stats()["graphs"] == 1
    ref_exe, ref_scope, ref_main, ref_loss = _torch_setup()
    want = [np.asarray(ref_exe.run_multi_step(
        ref_main, 3, feed=feed, fetch_list=[ref_loss], scope=ref_scope,
        stack_fetches=True)[0]) for _ in range(4)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(_w(scope, main), _w(ref_scope, ref_main))
    exe.close()
    assert exe.graph_stats()["graphs"] == 0


def _counter():
    """``acc = acc * 2 + x`` on a persistable; ``assign`` makes a new
    tensor each step, so the captured loop copies it into the bound
    tensor at its end."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", shape=[3], dtype="float32",
                               append_batch_size=False)
        acc = main.global_block().create_var(
            name="acc", shape=[3], dtype="float32", persistable=True)
        out = tfluid.layers.elementwise_add(
            tfluid.layers.scale(acc, scale=2.0), x)
        tfluid.layers.assign(out, output=acc)
    return main, out


def test_rebind_copies_a_replaced_scope_tensor():
    capturer = StandInCapturer()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.graph_capturer = capturer
    scope = tfluid.Scope()
    scope.set_value("acc", np.array([1.0, -2.0, 0.5], "float32"))
    main, out = _counter()
    feed = {"x": np.array([0.25, 1.0, -3.0], "float32")}
    exe.run_multi_step(main, 2, feed=feed, fetch_list=[out], scope=scope)
    exe.run_multi_step(main, 2, feed=feed, fetch_list=[out], scope=scope)
    (entry,) = exe._graphs.values()
    bound = entry.bound["acc"]
    assert scope.get_value("acc") is bound
    # an eager run replaces the scope's tensor (assign makes a new one)
    exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    replaced = scope.get_value("acc")
    assert replaced is not bound
    start = replaced.clone()
    (got,) = exe.run_multi_step(main, 2, feed=feed, fetch_list=[out],
                                scope=scope)
    assert scope.get_value("acc") is bound
    x = torch.from_numpy(feed["x"])
    want = (start * 2 + x) * 2 + x
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(bound.numpy(), want.numpy())
    # a value of another shape cannot be bound: named, not guessed
    scope.set_value("acc", np.zeros(4, "float32"))
    with pytest.raises(RuntimeError, match="'acc'"):
        exe.run_multi_step(main, 2, feed=feed, fetch_list=[out],
                           scope=scope)


def test_new_program_version_is_a_new_key():
    capturer = StandInCapturer()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.graph_capturer = capturer
    scope = tfluid.Scope()
    scope.set_value("acc", np.zeros(3, "float32"))
    main, out = _counter()
    feed = {"x": np.ones(3, "float32")}
    for _ in range(2):
        exe.run_multi_step(main, 2, feed=feed, fetch_list=[out], scope=scope)
    assert len(capturer.graphs) == 1
    main.global_block().create_var(name="unused", shape=[1])
    exe.run_multi_step(main, 2, feed=feed, fetch_list=[out], scope=scope)
    assert len(capturer.graphs) == 1  # the new version's warm-up: eager
    exe.run_multi_step(main, 2, feed=feed, fetch_list=[out], scope=scope)
    assert len(capturer.graphs) == 2 and len(exe._graphs) == 2
    # so are other steps, stacking and feed shapes
    exe.run_multi_step(main, 3, feed=feed, fetch_list=[out], scope=scope)
    exe.run_multi_step(main, 2, feed=feed, fetch_list=[out], scope=scope,
                       stack_fetches=True)
    assert len(exe._graphs) == 4 and exe.eager_multi_step == 0


def test_random_program_runs_eager_and_is_counted():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", shape=[8], dtype="float32",
                               append_batch_size=False)
        y = tfluid.layers.dropout(x, dropout_prob=0.5)
    capturer = StandInCapturer()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.graph_capturer = capturer
    scope = tfluid.Scope()
    outs = [exe.run_multi_step(main, 2, feed={"x": np.ones(8, "float32")},
                               fetch_list=[y], scope=scope)[0]
            for _ in range(3)]
    assert capturer.graphs == [] and exe.eager_multi_step == 3
    # the seeds advance per run, as the eager loop's do
    assert not all(np.array_equal(outs[0], o) for o in outs[1:])


def test_cuda_graph_flag_off_runs_eager_and_counts():
    capturer = StandInCapturer()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.graph_capturer = capturer
    scope = tfluid.Scope()
    scope.set_value("acc", np.zeros(3, "float32"))
    main, out = _counter()
    flags.set_flag("cuda_graph", "0")
    for _ in range(3):
        exe.run_multi_step(main, 2, feed={"x": np.ones(3, "float32")},
                           fetch_list=[out], scope=scope)
    assert capturer.graphs == [] and exe.eager_multi_step == 3
    np.testing.assert_array_equal(np.asarray(scope.get_value("acc")),
                                  np.full(3, 63.0, "float32"))


def test_replay_counts_the_captured_launches():
    """A launch queued while a graph is captured counts at every replay,
    never at capture (a stand-in graph and entry point)."""
    from paddle_tpu_torch.executor import _CapturedLoop

    kernel = kbuild.Kernel("stub", [])
    kernel._fn = lambda *args: 0
    other = kbuild.Kernel("stub2", [])
    other._fn = lambda *args: 0
    with kbuild.recording_launches() as log:
        kernel.launch(key=(1, False))
        kernel.launch(key=(1, False))
        other.launch()
    assert kernel.launches == other.launches == 0
    kernel.launch(key=(4, True))  # outside capture: counted at once
    entry = _CapturedLoop(tfluid.Program(), tfluid.Scope(), False)
    entry.graph = StandInGraph(lambda: None)
    entry.launch_log = log
    for _ in range(3):
        entry.replay()
    assert entry.graph.replays == 3
    assert kernel.launches == 7 and other.launches == 3
    assert kernel.by_key == {(1, False): 6, (4, True): 1}
    assert other.by_key == {}


def test_failed_capture_names_the_op(monkeypatch):
    """A capture that fails (here: an op that would synchronize with the
    host) raises an error naming the program's op; nothing falls back."""
    state = {"capturing": False}

    class FailingCapturer(object):
        def capture(self, body, device):
            state["capturing"] = True
            try:
                body()
            finally:
                state["capturing"] = False

    opdef = op_registry.get_op_def("scale")
    real = opdef.lower

    def lower(ctx, ins, attrs):
        if state["capturing"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return real(ctx, ins, attrs)

    monkeypatch.setattr(opdef, "lower", lower)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.graph_capturer = FailingCapturer()
    scope = tfluid.Scope()
    scope.set_value("acc", np.zeros(3, "float32"))
    main, out = _counter()
    feed = {"x": np.ones(3, "float32")}
    exe.run_multi_step(main, 2, feed=feed, fetch_list=[out], scope=scope)
    with pytest.raises(RuntimeError, match=r"at op 'scale' \(op 0\)"):
        exe.run_multi_step(main, 2, feed=feed, fetch_list=[out],
                           scope=scope)
    assert exe.eager_multi_step == 0
