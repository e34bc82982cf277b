"""Sub-blocks and control flow through both packages, on the CPU.

The twins of ``tests/test_while_grad.py`` and of the control-flow cases
of ``tests/test_rnn.py``: each program is built the same way through
``paddle_tpu`` and ``paddle_tpu_torch`` (``StaticRNN``, ``DynamicRNN``,
``While`` bounded and unbounded, ``cond``, ``Switch``, ``IfElse``, the
tensor arrays, ``lod_tensor_to_array`` and back), the JAX run's initial
state is carried into the port (``convert.persistables_from_numpy``) and
the fetches are compared: floats within 1e-5 (rtol and atol), integers
equal. Also: the dropout mask inside a ``StaticRNN`` step (equal draws:
both packages fold the step index into the op's key), programs with
sub-blocks serialize to the same PTPB bytes (names, attrs, var shapes),
an ``array_read`` past the capacity clamps, and ``run_multi_step``
holds a bounded ``While`` in a captured loop and refuses an unbounded
one and a ``cond``, naming the op.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core import program_bin as j_bin
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch import testing as cf
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.core import program_bin as t_bin
from paddle_tpu_torch.ops import subblock_ops
from paddle_tpu_torch.testing import fresh_state

RTOL = ATOL = 1e-5
PKGS = (("jax", jfluid, j_unique_name), ("torch", tfluid, t_unique_name))


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _build(pkg, unique_name, net, seed=5):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard({}), pkg.program_guard(main, startup):
        fetch = net(pkg)
    return main, startup, fetch


def _run_both(net, feeds, steps=1, seed=5):
    """Build ``net(pkg) -> fetch vars`` in both packages; run the
    startup programs, carry the JAX state into the port, run ``steps``
    runs a feed. Returns {package: [[fetches] per run]} and the port
    executor."""
    out, state, t_exe = {}, None, None
    for name, pkg, unique_name in PKGS:
        main, startup, fetch = _build(pkg, unique_name, net, seed)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            # the port's startup runs too: a run's key folds the
            # executor's run counter, as the JAX package's does
            scope = tfluid.Scope()
            exe.run(startup, scope=scope)
            persistables_from_numpy(main, scope, state, "cpu")
            t_exe = exe
        runs = []
        for f in feeds:
            for _ in range(steps):
                runs.append([np.asarray(v) for v in exe.run(
                    main, feed=f, fetch_list=fetch, scope=scope)])
        out[name] = runs
    return out, t_exe


def _assert_same(res):
    for jr, tr in zip(res["jax"], res["torch"]):
        assert len(jr) == len(tr)
        for j, t in zip(jr, tr):
            if np.issubdtype(j.dtype, np.floating):
                np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(t.astype(np.int64),
                                              j.astype(np.int64))


# -- tests/test_while_grad.py twins ------------------------------------------


@pytest.mark.parametrize("max_iters", [0, 8])
def test_while_forward_bounded_and_unbounded(max_iters):
    def net(pkg):
        loss, w, acc, i = cf.while_loss(pkg, max_iters, iters=5, n=2)
        return [loss, acc, i, w]

    xv = np.array([1.5, -2.0], "float32")
    res, _ = _run_both(net, [{"x": xv}])
    _assert_same(res)
    _, acc, i, w = res["torch"][0]
    np.testing.assert_allclose(acc, 5 * xv * w, rtol=1e-6)
    assert int(i[0]) == 5


def test_while_grad_matches_jax_and_analytic():
    def net(pkg):
        loss, w, _, _ = cf.while_loss(pkg, 6)
        return [loss] + pkg.backward.calc_gradient([loss], [w])

    xv = np.array([0.5, -1.0, 2.0, 3.0], np.float32)
    res, exe = _run_both(net, [{"x": xv}])
    _assert_same(res)
    np.testing.assert_allclose(res["torch"][0][1], 3 * xv / 4, rtol=1e-6)
    assert exe.grad_op_reruns == 1   # while_grad reruns the loop


def test_while_grad_matches_numeric():
    main, startup, (loss, g) = _build(tfluid, t_unique_name, lambda pkg: (
        lambda lw: [lw[0]] + pkg.backward.calc_gradient([lw[0]], [lw[1]]))(
            cf.while_loss(pkg, 6)))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    xv = np.array([1.0, 0.25, -0.5, 2.0], np.float32)
    (gw,) = exe.run(main, feed={"x": xv}, fetch_list=[g], scope=scope)
    (w,) = main.global_block().all_parameters()
    base = scope.get_value(w.name).numpy().copy()
    eps, numeric = 1e-3, np.zeros_like(base)
    for j in range(base.size):
        for sign in (1, -1):
            pert = base.copy()
            pert[j] += sign * eps
            scope.set_value(w.name, pert)
            (lv,) = exe.run(main, feed={"x": xv}, fetch_list=[loss],
                            scope=scope)
            numeric[j] += sign * float(np.ravel(lv)[0])
        numeric[j] /= 2 * eps
    np.testing.assert_allclose(gw, numeric, rtol=1e-2, atol=1e-4)


def test_training_through_while_matches_jax():
    n = 4

    def net(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[n], append_batch_size=False)
        t = L.data(name="t", shape=[n], append_batch_size=False)
        w = L.create_parameter([n], "float32", name="w_fit")
        acc = L.fill_constant([n], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 4)
        cond = L.less_than(i, limit)
        loop = L.While(cond, max_iterations=5)
        with loop.block():
            acc2 = L.elementwise_add(acc, L.elementwise_mul(x, w))
            L.assign(acc2, acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, limit, cond=cond)
        diff = L.elementwise_sub(acc, t)
        loss = L.mean(L.elementwise_mul(diff, diff))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return [loss]

    feed = {"x": np.array([1.0, 2.0, -1.0, 0.5], np.float32),
            "t": np.array([2.0, -4.0, 1.0, 3.0], np.float32)}
    res, _ = _run_both(net, [feed], steps=12)
    _assert_same(res)
    losses = [float(r[0].reshape(-1)[0]) for r in res["torch"]]
    assert losses[-1] < losses[0] * 0.2, losses


def test_while_grad_with_tensor_array_carry():
    iters, n = 3, 4

    def net(pkg):
        L = pkg.layers
        x = L.data(name="x", shape=[n], append_batch_size=False)
        w = L.create_parameter([n], "float32", name="w_arr")
        acc = L.fill_constant([n], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", iters)
        trace = L.array_write(acc, i)
        cond = L.less_than(i, limit)
        loop = L.While(cond, max_iterations=8)
        with loop.block():
            acc2 = L.elementwise_add(acc, L.elementwise_mul(x, w))
            L.assign(acc2, acc)
            L.array_write(acc2, i, array=trace)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, limit, cond=cond)
        loss = L.mean(acc)
        (g,) = [g for p, g in pkg.backward.append_backward(loss)
                if p.name.startswith("w_arr")]
        last = L.array_read(trace, L.fill_constant([1], "int64", 2))
        return [g, last, L.array_length(trace)]

    xv = np.arange(1.0, n + 1, dtype="float32")
    res, _ = _run_both(net, [{"x": xv}])
    _assert_same(res)
    np.testing.assert_allclose(res["torch"][0][0], iters * xv / n,
                               rtol=1e-5)
    assert int(res["torch"][0][2][0]) == iters


def test_unbounded_while_refuses_a_gradient():
    main, startup, (loss, g) = _build(tfluid, t_unique_name, lambda pkg: (
        lambda lw: [lw[0]] + pkg.backward.calc_gradient([lw[0]], [lw[1]]))(
            cf.while_loss(pkg, 0)))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    with pytest.raises(RuntimeError, match="max_iterations=0"):
        exe.run(main, feed={"x": np.ones(4, "float32")}, fetch_list=[g])


# -- tests/test_rnn.py twins (control flow) ----------------------------------


def test_static_rnn_matches_jax_and_manual_loop():
    B, T, D = 2, 4, 3
    x = np.random.RandomState(3).randn(B, T, D).astype("float32")

    def net(pkg):
        L = pkg.layers
        inp = L.data("x", shape=[T, D])
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(inp)
            h_prev = rnn.memory(shape=[-1, D], batch_ref=inp, init_value=0.0)
            h = L.elementwise_add(L.tanh(x_t), h_prev)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()
        assert tuple(out.shape) == (-1, T, D)
        return [out, L.fc(input=L.sequence_last_step(out), size=5)]

    res, _ = _run_both(net, [{"x": x}])
    _assert_same(res)
    hp, expect = np.zeros((B, D), "float32"), []
    for t in range(T):
        hp = np.tanh(x[:, t]) + hp
        expect.append(hp)
    np.testing.assert_allclose(res["torch"][0][0], np.stack(expect, 1),
                               atol=1e-5)


def _fc_rnn(pkg, reverse_input=False):
    B, T, D, H = 4, 5, 6, 8
    L = pkg.layers
    inp = L.data("x", shape=[T, D])
    label = L.data("y", shape=[H])
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(inp)
        h_prev = rnn.memory(shape=[-1, H], batch_ref=inp)
        h = L.fc(input=[x_t, h_prev], size=H, act="tanh")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    last = L.sequence_last_step(rnn())
    loss = L.mean(L.square(L.elementwise_sub(last, label)))
    return loss, B, T, D, H


def test_static_rnn_with_fc_trains_like_jax():
    """Gradients through the recurrent op: the step's fc parameters (the
    ``recurrent_grad`` op), three Adam steps; the port's forward tape
    serves the grad op (no rerun)."""
    def net(pkg):
        loss, *_ = _fc_rnn(pkg)
        pkg.optimizer.Adam(learning_rate=0.05).minimize(loss)
        w = [p for p in pkg.default_main_program().global_block()
             .all_parameters()]
        return [loss] + [pkg.default_main_program().global_block().var(
            p.name + "@GRAD") for p in sorted(w, key=lambda p: p.name)]

    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(4, 5, 6).astype("float32"),
            "y": (rng.randn(4, 8) * 0.3).astype("float32")}
    res, exe = _run_both(net, [feed], steps=3)
    _assert_same(res)
    assert exe.grad_op_reruns == 0
    losses = [float(r[0].reshape(-1)[0]) for r in res["torch"]]
    assert losses[-1] < losses[0]


def test_dynamic_rnn_masked_with_gradients():
    B, T, D, H = 3, 5, 4, 6
    rng = np.random.RandomState(8)
    feed = {"x": rng.randn(B, T, D).astype("float32"),
            "len": np.array([[2], [5], [3]], "int64")}

    res, exe = _run_both(cf.dynamic_rnn, [feed])
    _assert_same(res)
    out = res["torch"][0][0]
    assert (out[0, 2:] == 0).all() and (out[2, 3:] == 0).all()
    assert exe.grad_op_reruns == 0


def test_dropout_mask_in_static_rnn_step_matches_jax():
    """The step's dropout draws ``fold_in(fold_in(op key, t), rng id)``
    in both packages: equal outputs mean equal masks, step by step."""
    B, T, D = 4, 3, 16

    res, _ = _run_both(cf.static_rnn_dropout,
                       [{"x": np.ones((B, T, D), "float32")}], steps=2)
    _assert_same(res)
    out = res["torch"][0][0]
    steps = np.diff(np.concatenate([np.ones((B, 1, D)), out], 1), axis=1)
    assert 0 < (steps == 0).mean() < 1   # some masked, some kept
    assert not np.array_equal(steps[:, 0], steps[:, 1])  # per-step masks
    assert not np.array_equal(res["torch"][0][0], res["torch"][1][0])


def test_while_loop_accumulates():
    def net(pkg):
        L = pkg.layers
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 10)
        acc = L.fill_constant([1], "float32", 0.0)
        cond = L.less_than(i, limit)
        w = L.While(cond)
        with w.block():
            acc2 = L.elementwise_add(acc, L.cast(i, "float32"))
            L.assign(acc2, acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, limit, cond=cond)
        return [acc, i]

    subblock_ops.reset_host_reads()
    res, _ = _run_both(net, [{}])
    _assert_same(res)
    assert float(res["torch"][0][0][0]) == sum(range(10))
    assert subblock_ops.HOST_READS["while"] == 11   # 10 iterations + exit


@pytest.mark.parametrize("pred", [True, False])
def test_cond_branches(pred):
    xv = np.random.RandomState(2).randn(2, 4).astype("float32")

    res, _ = _run_both(cf.cond_pair, [{"x": xv, "p": np.array([pred])}])
    _assert_same(res)
    np.testing.assert_allclose(res["torch"][0][0],
                               xv * (2.0 if pred else -1.0), atol=1e-6)


def _mismatched_cond(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4])
    p = L.data("p", shape=[1], dtype="bool", append_batch_size=False)
    return [L.cond(p, lambda: L.scale(x, scale=1.0),
                   lambda: L.reduce_sum(x, dim=1, keep_dim=True))]


def test_cond_branches_must_agree_on_shapes():
    main, startup, (out,) = _build(tfluid, t_unique_name, _mismatched_cond)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(ValueError, match="different shapes"):
        exe.run(main, feed={"x": np.ones((2, 4), "float32"),
                            "p": np.array([True])}, fetch_list=[out])


def test_switch_three_cases_and_default():
    feeds = [{"x": np.array([v], "float32")} for v in (0.5, 1.5, 2.5, 7.0)]
    res, _ = _run_both(cf.switch, feeds)
    _assert_same(res)
    got = [float(r[0][0]) for r in res["torch"]]
    np.testing.assert_allclose(got, [5.0, 150.0, -3.0, -1.0])


def test_switch_needs_a_default():
    with pytest.raises(ValueError, match="default"):
        _build(tfluid, t_unique_name, lambda pkg: _switch_no_default(pkg))


def _switch_no_default(pkg):
    L = pkg.layers
    x = L.data("x", shape=[1], append_batch_size=False)
    out = L.fill_constant([1], "float32", 0.0)
    sw = L.Switch()
    with sw.case(L.less_than(x, out)):
        L.assign(x, out)
    sw._complete()


def test_ifelse_elementwise_merge():
    xv = np.ones((4, 3), "float32")
    cv = np.array([[True], [False], [True], [False]])
    res, _ = _run_both(cf.ifelse, [{"x": xv, "c": cv}])
    _assert_same(res)
    np.testing.assert_allclose(res["torch"][0][0][:, 0], [10, 0, 10, 0])


def test_while_with_seeded_tensor_array():
    """The decode-loop pattern: an array seeded before an unbounded loop
    and grown inside; a read past the capacity clamps to the last row
    (zeros: never written), as XLA's dynamic index does."""
    xv = np.ones((2, 3), "float32")
    res, _ = _run_both(cf.array_loop, [{"x": xv}])
    _assert_same(res)
    last, past, n, _ = res["torch"][0]
    np.testing.assert_allclose(last, 16.0 * xv, atol=1e-5)
    np.testing.assert_array_equal(past, np.zeros_like(xv))
    assert int(n[0]) == 5


def test_tensor_array_write_read_and_fetch():
    def net(pkg):
        L = pkg.layers
        x = L.data("x", shape=[3])
        i0 = L.fill_constant([1], "int64", 0)
        i1 = L.fill_constant([1], "int64", 1)
        arr = L.array_write(x, i0, capacity=4)
        L.array_write(L.scale(x, scale=2.0), i1, array=arr)
        L.array_write(x, L.fill_constant([1], "int64", 9), array=arr)
        return [L.array_read(arr, i1), L.array_length(arr),
                L.array_read(arr, L.fill_constant([1], "int64", -2))]

    xv = np.random.RandomState(6).randn(2, 3).astype("float32")
    res, _ = _run_both(net, [{"x": xv}])
    _assert_same(res)
    r, n, neg = res["torch"][0]
    np.testing.assert_allclose(r, 2 * xv, atol=1e-6)
    assert int(n[0]) == 2   # the write at 9 was dropped
    # -2 counts from the end (row 2, never written), as JAX's index does
    np.testing.assert_array_equal(neg, np.zeros_like(xv))
    main, startup, fetch = _build(tfluid, t_unique_name, net)
    (arr_var,) = [v.name for v in main.global_block().vars.values()
                  if v.type == "lod_tensor_array"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    (got,) = exe.run(main, feed={"x": xv}, fetch_list=[arr_var])
    assert isinstance(got, tfluid.LoDTensorArray) and len(got) == 2
    np.testing.assert_allclose(got[1], 2 * xv, atol=1e-6)
    with pytest.raises(TypeError, match="tensor array"):
        exe.run(main, feed={"x": xv, arr_var: xv}, fetch_list=[fetch[0]])


def test_while_unseeded_carry_raises():
    for pkg, unique_name in ((jfluid, j_unique_name),
                             (tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        with unique_name.guard({}), pkg.program_guard(main, startup):
            L = pkg.layers
            i = L.fill_constant([1], "int64", 0)
            limit = L.fill_constant([1], "int64", 3)
            arr = L.create_array("float32")
            cond = L.less_than(i, limit)
            w = L.While(cond)
            with pytest.raises(ValueError, match="no value before the loop"):
                with w.block():
                    L.array_write(L.cast(i, "float32"), i, array=arr)
                    L.increment(i, value=1, in_place=True)
                    L.less_than(i, limit, cond=cond)


def test_static_rnn_user_error_not_masked():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        inp = tfluid.layers.data("x", shape=[4, 3])
        rnn = tfluid.layers.StaticRNN()
        with pytest.raises(RuntimeError, match="user error"):
            with rnn.step():
                rnn.step_input(inp)
                raise RuntimeError("user error")


def test_lod_tensor_to_array_and_back_with_gradient():
    B, T, D = 2, 4, 3
    xv = np.random.RandomState(9).randn(B, T, D).astype("float32")

    res, _ = _run_both(cf.lod_array, [{"x": xv, "len": np.array(
        [[2], [4]], "int64")}])
    _assert_same(res)
    back, row, n, gx = res["torch"][0]
    np.testing.assert_allclose(back, xv, atol=0)
    np.testing.assert_allclose(row, xv[:, 1], atol=0)
    assert int(n[0]) == T
    np.testing.assert_allclose(gx, 2 * xv, rtol=1e-6)



@pytest.mark.parametrize("case", cf.control_flow_cases(),
                         ids=lambda case: case[0])
def test_control_flow_cases_match_jax(case):
    """Each construct of the card's control-flow sweep (chip_smoke.py
    holds the card's run to the CPU's) equals the JAX package's run."""
    _, build, feeds = case
    res, _ = _run_both(build, feeds)
    _assert_same(res)


# -- names, saved programs, capture ------------------------------------------


def _multi_block(pkg):
    loss, *_ = _fc_rnn(pkg)
    L = pkg.layers
    cf.array_loop(pkg)
    p = L.data("p", shape=[1], dtype="bool")
    L.cond(p, lambda: L.scale(loss, scale=2.0), lambda: loss)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def test_programs_with_sub_blocks_serialize_to_the_same_bytes():
    """Names minted in sub-blocks (rnn_step_in, rnn_mem, rnn_out,
    rnn_final, the step's fc parameters, <carry>__while_init), the
    blocks' parents, the ops' attrs and the vars' shapes are the JAX
    package's: the PTPB files are equal byte for byte, and the port reads
    the JAX file back to the same bytes."""
    progs = {name: _build(pkg, unique_name, _multi_block)[0]
             for name, pkg, unique_name in PKGS}
    jb = j_bin.serialize_program(progs["jax"])
    tb = t_bin.serialize_program(progs["torch"])
    assert progs["torch"].num_blocks == progs["jax"].num_blocks == 5
    assert tb == jb
    back = t_bin.deserialize_program(jb)
    assert t_bin.serialize_program(back) == jb
    assert [b.parent_idx for b in back.blocks] == [-1, 0, 0, 0, 0]


def test_run_multi_step_captures_a_bounded_while():
    """The capture path (a stand-in capturer on the CPU) runs a bounded
    While like the eager loop; an unbounded While and a cond are refused
    by name before anything runs."""
    class Capturer(object):
        """Records the body at capture (nothing runs); replay runs it."""
        captured = 0

        def capture(self, body, device):
            Capturer.captured += 1

            class Graph(object):
                def replay(self):
                    body()
            return Graph(), 0

    def net(pkg, max_iterations):
        loss, w, acc, _ = cf.while_loss(pkg, max_iterations, iters=3, n=2)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return [loss, acc]

    feed = {"x": np.array([0.5, -1.0], "float32")}
    got = {}
    for mode in ("eager", "captured"):
        main, startup, fetch = _build(tfluid, t_unique_name,
                                      lambda pkg: net(pkg, 4))
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        (w,) = main.global_block().all_parameters()
        scope.set_value(w.name, np.array([1.0, 2.0], "float32"))
        if mode == "captured":
            exe.graph_capturer = Capturer()
        outs = []
        for _ in range(3):
            outs.append([np.asarray(v) for v in exe.run_multi_step(
                main, 2, feed=feed, fetch_list=fetch, scope=scope)])
        got[mode] = outs
    assert Capturer.captured == 1
    for a, b in zip(got["eager"], got["captured"]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    for build in (lambda pkg: net(pkg, 0), lambda pkg: [
            pkg.layers.cond(pkg.layers.data("p", shape=[1], dtype="bool"),
                            lambda: pkg.layers.fill_constant(
                                [1], "float32", 1.0),
                            lambda: pkg.layers.fill_constant(
                                [1], "float32", 2.0))]):
        main, startup, fetch = _build(tfluid, t_unique_name, build)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.graph_capturer = Capturer()
        exe.run(startup)
        with pytest.raises(RuntimeError,
                           match="cannot capture.*'(while|cond)'"):
            exe.run_multi_step(main, 2, feed={
                "x": feed["x"], "p": np.array([True])}, fetch_list=fetch)
    t_flags.set_flag("cuda_graph", "0")
    try:
        (out,) = exe.run_multi_step(main, 2, feed={"p": np.array([True])},
                                    fetch_list=fetch)
        assert float(out[0]) == 1.0
    finally:
        t_flags.set_flag("cuda_graph", "1")
