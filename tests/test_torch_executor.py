"""The port's Executor against the JAX package's: a persistable counter
program stepped with ``run`` and ``run_multi_step`` (stacked and last-step
fetches) gives the same values and leaves the same state in the scope;
feeds are copied, so an op that updates state in place never writes into
the caller's array; and the errors a user meets are raised."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.testing import fresh_state


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _counter(pkg):
    """``acc = acc * 2 + x`` on a persistable, plus a fetched copy."""
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        x = pkg.layers.data("x", shape=[3], dtype="float32",
                            append_batch_size=False)
        acc = main.global_block().create_var(
            name="acc", shape=[3], dtype="float32", persistable=True)
        out = pkg.layers.elementwise_add(
            pkg.layers.scale(acc, scale=2.0), x)
        pkg.layers.assign(out, output=acc)
    return main, out


def _run_both(fn):
    results = []
    for pkg in (jfluid, tfluid):
        exe = pkg.Executor(pkg.CPUPlace())
        scope = (jfluid.executor.Scope() if pkg is jfluid
                 else tfluid.Scope())
        scope.set_value("acc", np.array([1.0, -2.0, 0.5], "float32"))
        main, out = _counter(pkg)
        results.append(fn(exe, scope, main, out))
    return results


def test_run_and_multi_step_match_jax():
    feed = {"x": np.array([0.25, 1.0, -3.0], "float32")}

    def go(exe, scope, main, out):
        first = exe.run(main, feed=feed, fetch_list=[out], scope=scope)[0]
        stacked = exe.run_multi_step(main, 3, feed=feed, fetch_list=[out],
                                     scope=scope, stack_fetches=True)[0]
        last = exe.run_multi_step(main, 2, feed=feed, fetch_list=[out],
                                  scope=scope)[0]
        return (np.asarray(first), np.asarray(stacked), np.asarray(last),
                np.asarray(scope.get_value("acc")))

    (jf, js, jl, ja), (tf, ts, tl, ta) = _run_both(go)
    assert ts.shape == js.shape == (3, 3)
    for got, want in ((tf, jf), (ts, js), (tl, jl), (ta, ja)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_feeds_are_copied_before_in_place_updates():
    """paged_kv_write updates its pools in place; a pool fed from numpy
    must come back changed in the fetch and unchanged in the caller's
    array."""
    rng = np.random.RandomState(0)
    pool = rng.randn(3, 1, 2, 4).astype("float32")
    keep = pool.copy()
    prog = tfluid.Program()
    blk = prog.global_block()
    feed = {"kp": pool, "vp": pool.copy(),
            "kn": rng.randn(1, 1, 1, 4).astype("float32"),
            "vn": rng.randn(1, 1, 1, 4).astype("float32"),
            "t": np.array([[1, 2]], "int64"), "pos": np.array([[3]], "int64")}
    for name, arr in feed.items():
        blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                       is_data=True)
    blk.append_op(type="paged_kv_write",
                  inputs={"KPool": ["kp"], "VPool": ["vp"], "KNew": ["kn"],
                          "VNew": ["vn"], "PageTable": ["t"], "Pos": ["pos"]},
                  outputs={"KOut": ["kp"], "VOut": ["vp"]})
    (got,) = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=["kp"])
    np.testing.assert_array_equal(pool, keep)
    np.testing.assert_array_equal(got[2, :, 1], feed["kn"][0, :, 0])


def test_user_errors_are_raised():
    exe = tfluid.Executor(tfluid.CPUPlace())
    main, out = _counter(tfluid)
    feed = {"x": np.zeros(3, "float32")}
    with pytest.raises(RuntimeError, match="uninitialized variable .acc"):
        exe.run(main, feed=feed, fetch_list=[out])
    tfluid.global_scope().set_value("acc", np.zeros(3, "float32"))
    with pytest.raises(RuntimeError, match="not produced"):
        exe.run(main, feed=feed, fetch_list=["no_such_var"])
    with pytest.raises(ValueError, match="steps >= 1"):
        exe.run_multi_step(main, 0, feed=feed, fetch_list=[out])
