"""The forward tape: a grad op differentiates the graph its forward op
recorded instead of rerunning the forward, on the CPU.

- the small Transformer's train step (``test_torch_train.py``'s
  configuration, Adam): every forward op that has a grad op is lowered
  once per step, no grad op reruns its forward, and 3 steps' losses and
  every parameter gradient are bit-equal to the forced-rerun path's
  (``Executor._grad_tape = False``): both differentiate the same torch
  ops on the same inputs;
- the pairing (``BlockLowerer.grad_pairs``) pairs every grad op of the
  train program with its own forward op;
- dropout's grad uses the forward's own mask, with no rerun and no
  second draw;
- a grad op whose forward input was rebound or modified in place since
  the forward reruns its forward, counted, and gives the JAX package's
  gradient (the rerun reads what the grad op reads, as the JAX package's
  does);
- a captured ``run_multi_step`` train loop (the stand-in capturer of
  ``test_torch_graph_capture.py``) with the tape: no rerun at capture,
  losses equal to the eager loop's and to ``run``'s.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.core import op_registry, prng
from paddle_tpu_torch.core.lowering import BlockLowerer
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params
from test_torch_graph_capture import StandInCapturer
from test_torch_train import _nmt_feed, _small_transformer


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _transformer(tape):
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        loss = _small_transformer(tfluid)
        _, params_grads = tfluid.optimizer.Adam(
            learning_rate=1e-3).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe._grad_tape = tape
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope, parameters_only=True)
    return exe, scope, main, loss, [g.name for _, g in params_grads]


def _steps(exe, scope, main, loss, grads, n=3):
    return [exe.run(main, feed=_nmt_feed(), scope=scope,
                    fetch_list=[loss] + grads) for _ in range(n)]


def test_every_grad_op_pairs_with_its_forward():
    _, _, main, _, _ = _transformer(True)
    ops = main.global_block().ops
    pairs = BlockLowerer(main, 0).grad_pairs()
    grad_ops = [j for j, op in enumerate(ops) if op.type.endswith("_grad")]
    assert len(grad_ops) > 100
    assert sorted(pairs.values()) == grad_ops
    for i, j in pairs.items():
        assert ops[j].type == ops[i].type + "_grad" and i < j


def test_transformer_step_lowers_each_forward_once():
    exe, scope, main, loss, grads = _transformer(True)
    ops = main.global_block().ops
    paired = {ops[i].type for i in BlockLowerer(main, 0).grad_pairs()}
    calls = {}
    saved = {}
    for t in paired:
        opdef = op_registry.get_op_def(t)
        saved[t] = opdef.lower

        def counted(ctx, ins, attrs, t=t, lower=opdef.lower):
            calls[t] = calls.get(t, 0) + 1
            return lower(ctx, ins, attrs)

        opdef.lower = counted
    try:
        exe.run(main, feed=_nmt_feed(), scope=scope, fetch_list=[loss])
    finally:
        for t, lower in saved.items():
            op_registry.get_op_def(t).lower = lower
    want = {}
    for op in ops:
        if op.type in paired:
            want[op.type] = want.get(op.type, 0) + 1
    assert calls == want
    assert exe.grad_op_reruns == 0


def test_tape_equals_the_rerun_path_bit_for_bit():
    exe, scope, main, loss, grads = _transformer(True)
    taped = _steps(exe, scope, main, loss, grads)
    assert exe.grad_op_reruns == 0
    exe_r, scope_r, main_r, loss_r, grads_r = _transformer(False)
    rerun = _steps(exe_r, scope_r, main_r, loss_r, grads_r)
    n_grad_ops = sum(op.type.endswith("_grad")
                     for op in main_r.global_block().ops)
    assert exe_r.grad_op_reruns == 3 * n_grad_ops
    assert grads == grads_r
    for a, b in zip(taped, rerun):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert taped[-1][0][0] < taped[0][0][0]


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_grad_uses_the_forward_mask(impl):
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[64], stop_gradient=False)
        y = tfluid.layers.dropout(x, dropout_prob=0.5,
                                  dropout_implementation=impl)
        (gx,) = tfluid.backward.calc_gradient(
            tfluid.layers.reduce_sum(y), [x])
    mask_name = [op for op in main.global_block().ops
                 if op.type == "dropout"][0].output("Mask")[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    draws = []
    plain_draw = prng.plain_draw

    def counted_draw(*args, **kwargs):
        draws.append(args)
        return plain_draw(*args, **kwargs)

    xs = np.random.RandomState(5).uniform(0.5, 1.5, (6, 64)).astype(
        "float32")
    prng.plain_draw = counted_draw
    try:
        mask, grad = exe.run(main, feed={"x": xs},
                             fetch_list=[mask_name, gx])
    finally:
        prng.plain_draw = plain_draw
    assert len(draws) == 1 and exe.grad_op_reruns == 0
    assert 0 < (mask == 0).mean() < 1
    keep = 2.0 if impl == "upscale_in_train" else 1.0
    np.testing.assert_array_equal(grad, mask * keep)


def _inplace_double(ctx, ins, attrs):
    x = ins["X"][0]
    x.mul_(2.0)
    return x


op_registry.register_op("tape_test_inplace_double", inputs=["X"],
                        outputs=["Out"], lower=_inplace_double, grad=None)


def _rebound_program(pkg, unique_name, rebind):
    """y = tanh(x), then x rewritten (a new tensor under its name, or
    the same tensor doubled in place), then d sum(y) / dx. Returns
    (program, grad var)."""
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[5], stop_gradient=False)
        y = pkg.layers.tanh(x)
        (gx,) = pkg.backward.calc_gradient(pkg.layers.reduce_sum(y), [x])
    blk = main.global_block()
    at = [op.type for op in blk.ops].index("tanh") + 1
    if rebind == "rebound":
        blk.insert_op(at, "scale", inputs={"X": ["x"]},
                      outputs={"Out": ["x"]}, attrs={"scale": 2.0})
    else:
        blk.insert_op(at, "tape_test_inplace_double", inputs={"X": ["x"]},
                      outputs={"Out": ["x"]})
    return main, gx


@pytest.mark.parametrize("rebind", ["rebound", "in_place"])
def test_changed_forward_input_reruns_counted(rebind):
    xs = np.random.RandomState(2).randn(3, 5).astype("float32")
    main, gx = _rebound_program(tfluid, t_unique_name, rebind)
    exe = tfluid.Executor(tfluid.CPUPlace())
    (got,) = exe.run(main, feed={"x": xs}, fetch_list=[gx])
    assert exe.grad_op_reruns == 1
    # the rerun differentiates tanh at the value the grad op reads: 2x
    np.testing.assert_allclose(got, 1 - np.tanh(2 * xs) ** 2, rtol=1e-5,
                               atol=1e-6)
    if rebind == "rebound":
        jmain, jgx = _rebound_program(jfluid, j_unique_name, rebind)
        (want,) = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed={"x": xs}, fetch_list=[jgx])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_captured_train_loop_uses_the_tape():
    exe, scope, main, loss, _ = _transformer(True)
    capturer = StandInCapturer()
    exe.graph_capturer = capturer
    feed = _nmt_feed()
    eager = _transformer(True)
    steps = 2
    got, want = [], []
    for _ in range(3):
        got.append(exe.run_multi_step(main, steps, feed=feed,
                                      fetch_list=[loss], scope=scope,
                                      stack_fetches=True)[0])
        want.append(np.concatenate([eager[0].run(
            eager[2], feed=feed, scope=eager[1], fetch_list=[eager[3]])[0]
            for _ in range(steps)]))
    assert len(capturer.graphs) == 1 and capturer.graphs[0].replays == 2
    assert exe.grad_op_reruns == 0 and exe.eager_multi_step == 0
    np.testing.assert_array_equal(np.concatenate(got).reshape(-1),
                                  np.concatenate(want).reshape(-1))
