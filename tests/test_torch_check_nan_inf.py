"""``FLAGS_check_nan_inf`` in the port's Executor, against the JAX
package's.

The JAX package scans every floating new-state value and fetch after a
run and raises ``RuntimeError("NaN/Inf detected in variable %r after
program run (FLAGS_check_nan_inf)")`` naming the first bad one, state
before fetches. The port does the same after ``run``, after
``run_async``'s ``result()`` and after ``run_multi_step``, eager and
through the captured path (here a stand-in capturer that records the
loop body and runs it at each replay). Messages are compared as strings
with the JAX package's (its NaN provenance replay off, so the plain
scanner message passes through). The ``log`` activation, which the
twin of ``tests/test_aux.py``'s test uses, is held against the JAX
package's within 1e-6 relative.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as jflags
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.testing import fresh_state

BAD = np.array([[-1.0, 1.0, 2.0, 3.0]], "float32")
GOOD = np.array([[0.5, 1.0, 2.0, 3.0], [4.0, 1e-3, 7.0, 9.5]], "float32")


@pytest.fixture(autouse=True)
def _flags():
    with fresh_state():
        yield
    tflags.set_flag("check_nan_inf", False)
    jflags.set_flag("check_nan_inf", False)
    jflags.set_flag("nan_provenance", True)


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


def _log_prog(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard({}), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        out = fluid.layers.log(x)  # log of a negative -> NaN
    return main, startup, out


def _counter(fluid):
    """``acc = acc * 2 + x`` on a persistable: a state value that
    overflows to inf while the loop runs."""
    main = fluid.Program()
    with fluid.unique_name.guard({}), \
            fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data("x", shape=[3], dtype="float32",
                              append_batch_size=False)
        acc = main.global_block().create_var(
            name="acc", shape=[3], dtype="float32", persistable=True)
        out = fluid.layers.elementwise_add(
            fluid.layers.scale(acc, scale=2.0), x)
        fluid.layers.assign(out, output=acc)
    return main, out


def _jax_message(call):
    jflags.set_flag("check_nan_inf", True)
    jflags.set_flag("nan_provenance", False)
    with pytest.raises(RuntimeError) as err:
        call()
    return str(err.value)


def test_check_nan_inf_raises():
    """Twin of tests/test_aux.py's test: NaN flows silently without the
    flag; with it ``run`` raises the JAX package's message."""
    main, startup, out = _log_prog(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    (res,) = exe.run(main, feed={"x": BAD}, fetch_list=[out])
    assert np.isnan(res).any()
    tflags.set_flag("check_nan_inf", True)
    with pytest.raises(RuntimeError, match="NaN/Inf") as err:
        exe.run(main, feed={"x": BAD}, fetch_list=[out])

    jmain, jstartup, jout = _log_prog(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup)
    want = _jax_message(lambda: jexe.run(jmain, feed={"x": BAD},
                                         fetch_list=[jout]))
    assert str(err.value) == want
    assert "'log_0.tmp_0'" in want
    # finite values pass the scan
    (ok,) = exe.run(main, feed={"x": GOOD}, fetch_list=[out])
    assert np.isfinite(ok).all()


def test_run_async_raises_at_result():
    main, startup, out = _log_prog(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    tflags.set_flag("check_nan_inf", True)
    handle = exe.run_async(main, feed={"x": BAD}, fetch_list=[out])
    with pytest.raises(RuntimeError) as err:
        handle.result()

    jmain, jstartup, jout = _log_prog(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup)
    want = _jax_message(lambda: jexe.run_async(
        jmain, feed={"x": BAD}, fetch_list=[jout]).result())
    assert str(err.value) == want
    (ok,) = exe.run_async(main, feed={"x": GOOD},
                          fetch_list=[out]).result(timeout=5.0)
    assert np.isfinite(ok).all()


@pytest.mark.parametrize("captured", [False, True])
def test_run_multi_step_names_the_state_first(captured):
    """The loop's state overflows to inf: the scan names the state
    variable (state before fetches, the JAX package's order), eagerly
    and, with a capturer, after the warm-up and after a replay of the
    captured loop (the bound tensors)."""
    feed = {"x": np.array([0.25, 1.0, -3.0], "float32")}
    start = np.array([1.0, 3e38, 0.5], "float32")
    main, out = _counter(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    capturer = StandInCapturer() if captured else None
    exe.graph_capturer = capturer
    scope = tfluid.Scope()
    scope.set_value("acc", start.copy())
    tflags.set_flag("check_nan_inf", True)
    with pytest.raises(RuntimeError) as err:
        exe.run_multi_step(main, 3, feed=feed, fetch_list=[out],
                           scope=scope)
    if captured:
        # the second call captures the loop and replays it
        scope.set_value("acc", start.copy())
        with pytest.raises(RuntimeError) as err2:
            exe.run_multi_step(main, 3, feed=feed, fetch_list=[out],
                               scope=scope)
        assert capturer.graphs[0].replays == 1
        assert str(err2.value) == str(err.value)

    jmain, jout = _counter(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.core.scope.Scope()
    jscope.set_value("acc", start.copy())
    want = _jax_message(lambda: jexe.run_multi_step(
        jmain, 3, feed=feed, fetch_list=[jout], scope=jscope))
    assert str(err.value) == want
    assert "'acc'" in want


def test_log_matches_jax():
    """The ``log`` activation and its gradient, against the JAX
    package's."""
    outs = {}
    for name, fluid in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard({}), \
                fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                                  stop_gradient=False)
            y = fluid.layers.log(x)
            loss = fluid.layers.mean(y)
            fluid.backward.append_backward(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        outs[name] = [np.asarray(v) for v in exe.run(
            main, feed={"x": GOOD}, fetch_list=[y, "x@GRAD"])]
    for j, t in zip(outs["jax"], outs["torch"]):
        np.testing.assert_allclose(t, j, rtol=1e-6)
    np.testing.assert_allclose(outs["torch"][0], np.log(GOOD), rtol=1e-6)
