"""Control flow and B6 at the encoder-decoder's width on the card.

``run_multi_step`` of a program with a bounded ``While`` (and its
gradient, SGD on the loop's parameter) captured into a CUDA graph equals
the eager loop (``FLAGS_cuda_graph=0``) bit for bit; a program with an
unbounded ``While`` or a ``cond`` is refused capture, naming the op, and
runs under ``FLAGS_cuda_graph=0``. B6 (``lstm_cell``) at D 32 (the book
encoder-decoder's ``dynamic_lstm``: batch 64, 50 steps, peepholes and
masked lengths, and without peepholes at full lengths) within 1e-4 of
its plain version.

Marked ``card``: each test skips where torch sees no CUDA device (this
file imports no JAX). On a card:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_control_flow_card.py -q
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.kernels import KERNELS
from paddle_tpu_torch.kernels import lstm_cell as lc

B6_TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _while_program(max_iterations):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard({}), fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data(name="x", shape=[4], append_batch_size=False)
        w = L.create_parameter([4], "float32", name="w_loop")
        acc = L.fill_constant([4], "float32", 0.0)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, limit)
        loop = L.While(cond, max_iterations=max_iterations)
        with loop.block():
            acc2 = L.elementwise_add(acc, L.tanh(L.elementwise_mul(x, w)))
            L.assign(acc2, acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, limit, cond=cond)
        loss = L.mean(L.square(acc))
        if max_iterations:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, [loss, acc]


@pytest.mark.card
def test_bounded_while_captured_equals_eager():
    _card()
    feed = {"x": np.array([0.5, -1.0, 2.0, 0.25], "float32")}
    got = {}
    for graph in (True, False):
        flags.set_flag("cuda_graph", graph)
        try:
            main, startup, fetch = _while_program(5)
            exe = fluid.Executor()
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            scope.set_value("w_loop", np.array([1.0, 0.5, -0.25, 2.0],
                                               "float32"))
            got[graph] = [[np.asarray(v) for v in exe.run_multi_step(
                main, 4, feed=feed, fetch_list=fetch, scope=scope)]
                for _ in range(3)]
            if graph:
                assert exe.graph_stats()["graphs"] == 1
            else:
                assert exe.eager_multi_step == 3
        finally:
            flags.set_flag("cuda_graph", True)
    for a, b in zip(got[True], got[False]):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def _cond_program():
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard({}), fluid.program_guard(main, startup):
        L = fluid.layers
        p = L.data("p", shape=[1], dtype="bool", append_batch_size=False)
        out = L.cond(p, lambda: L.fill_constant([1], "float32", 1.0),
                     lambda: L.fill_constant([1], "float32", 2.0))
    return main, startup, [out]


@pytest.mark.card
@pytest.mark.parametrize("build,op", [
    (lambda: _while_program(0), "while"), (_cond_program, "cond")])
def test_host_reading_programs_are_refused_capture(build, op):
    _card()
    main, startup, fetch = build()
    feed = {"x": np.ones(4, "float32"), "p": np.array([True])}
    feed = {k: v for k, v in feed.items()
            if main.global_block().has_var(k)}
    exe = fluid.Executor()
    exe.run(startup)
    with pytest.raises(RuntimeError, match="cannot capture.*'%s'" % op):
        exe.run_multi_step(main, 2, feed=feed, fetch_list=fetch)
    assert exe.graph_stats()["graphs"] == 0
    flags.set_flag("cuda_graph", False)
    try:
        out = exe.run_multi_step(main, 2, feed=feed, fetch_list=fetch)
    finally:
        flags.set_flag("cuda_graph", True)
    assert np.isfinite(np.asarray(out[0])).all()


@pytest.mark.card
@pytest.mark.parametrize("peep,masked", [(True, True), (False, False)])
def test_lstm_cell_at_d32_matches_its_plain_version(peep, masked):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, T, D = 64, 50, 32
    xw = torch.randn(B, T, 4 * D, generator=gen, device="cuda")
    w_h = 0.2 * torch.randn(D, 4 * D, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(4 * D, generator=gen, device="cuda")
    p = (0.1 * torch.randn(3, D, generator=gen, device="cuda")
         if peep else None)
    mask = None
    if masked:
        lens = torch.randint(10, T + 1, (B,), generator=gen, device="cuda")
        mask = (torch.arange(T, device="cuda")[None, :]
                < lens[:, None]).float()
    KERNELS["lstm_cell"].reset()
    hid, cel = lc.lstm_cell_forward(xw, w_h, bias, p, mask=mask)
    torch.cuda.synchronize()
    assert KERNELS["lstm_cell"].launches == 1
    ref_h, ref_c = lc.lstm_reference(xw, w_h, bias, p, mask=mask)
    assert float((hid - ref_h).abs().max()) <= B6_TOL
    assert float((cel - ref_c).abs().max()) <= B6_TOL
