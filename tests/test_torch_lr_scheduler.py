"""The LR schedulers of the PyTorch port against the JAX package, on the
CPU.

The twin of ``tests/test_lr_scheduler.py``: each schedule's value over 12
steps, run as in-graph ops over ``@LR_DECAY_COUNTER@`` in both packages
(all ten in one program each, on their one shared counter),
equals the JAX package's within two float32 ulps (XLA folds the division
by ``decay_steps`` into a product with its float32 reciprocal, torch
divides); the counter ops and their role attr
are the JAX program's; one counter serves several schedules and
``autoincreased_step_counter``; a schedule drives an optimizer.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state

STEPS = 12

SCHEDULES = [
    ("exponential", lambda L: L.exponential_decay(0.1, 3, 0.5)),
    ("exponential_staircase",
     lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True)),
    ("natural_exp", lambda L: L.natural_exp_decay(0.1, 2, 0.9)),
    ("natural_exp_staircase",
     lambda L: L.natural_exp_decay(0.1, 2, 0.9, staircase=True)),
    ("inverse_time", lambda L: L.inverse_time_decay(0.1, 2, 0.5)),
    ("polynomial", lambda L: L.polynomial_decay(0.1, 4, 0.01, power=2.0)),
    ("polynomial_cycle",
     lambda L: L.polynomial_decay(0.1, 4, 0.01, power=2.0, cycle=True)),
    ("piecewise", lambda L: L.piecewise_decay([2, 5], [0.1, 0.05, 0.01])),
    ("noam", lambda L: L.noam_decay(64, 4)),
    ("cosine", lambda L: L.cosine_decay(0.1, 2, 4)),
]


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _values(pkg, unique_name, build, steps=STEPS):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        out = build(pkg.layers)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = tfluid.Scope() if pkg is tfluid else JScope()
    exe.run(startup, scope=scope)
    outs = out if isinstance(out, (list, tuple)) else [out]
    vals = [[np.asarray(v).reshape(-1)[0] for v in exe.run(
        main, feed={}, fetch_list=outs, scope=scope)] for _ in range(steps)]
    return np.array(vals), main


_ALL = {}


def _all_values(pkg, unique_name):
    """Every schedule of SCHEDULES in one program (their one shared
    counter), run STEPS times: (values [STEPS, len(SCHEDULES)], the
    program), computed once a package."""
    if pkg not in _ALL:
        _ALL[pkg] = _values(pkg, unique_name, lambda L: [
            build(L) for _, build in SCHEDULES])
    return _ALL[pkg]


@pytest.mark.parametrize("i", range(len(SCHEDULES)),
                         ids=[s[0] for s in SCHEDULES])
def test_schedule_values_match_jax(i):
    want, jmain = _all_values(jfluid, j_unique_name)
    got, tmain = _all_values(tfluid, t_unique_name)
    assert got.dtype == np.float32
    # step 0 of noam is 0 ** -0.5 = inf on both sides; min takes the other.
    # XLA folds step / decay_steps into a product with the float32
    # reciprocal, torch divides: a few values land an ulp or two apart
    np.testing.assert_array_max_ulp(got[:, i], want[:, i], maxulp=2)
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    inc = [op for op in tmain.global_block().ops if op.type == "increment"]
    assert len(inc) == 1
    assert all(op.attrs["op_role"] == tfluid.framework.OpRole.LRSched
               for op in tmain.global_block().ops)


def test_schedules_and_step_counter_share_one_increment():
    """Two schedules and the user counter (its own name, begin 1): one
    +1 a run on the shared decay counter, one on the user's."""
    def build(L):
        a = L.exponential_decay(0.1, 3, 0.5)
        b = L.cosine_decay(0.1, 2, 4)
        c = L.autoincreased_step_counter(begin=1)
        return [a, b, c]

    want, _ = _values(jfluid, j_unique_name, build, steps=5)
    got, main = _values(tfluid, t_unique_name, build, steps=5)
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    np.testing.assert_array_equal(got[:, 2], np.arange(1, 6))
    assert sum(op.type == "increment"
               for op in main.global_block().ops) == 2


def test_scheduler_drives_optimizer():
    """The schedule changes the applied step size: the learning rate
    drops to 0 at step 2 and the weights freeze from then on."""
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [2], stop_gradient=False)
        y = tfluid.layers.data("y", [1])
        pred = tfluid.layers.fc(x, 1, bias_attr=False)
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(pred, y))
        lr = tfluid.layers.piecewise_decay([2], [0.5, 0.0])
        tfluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((4, 2), "float32"), "y": np.ones((4, 1), "float32")}
    w = main.global_block().all_parameters()[0].name
    seen = []
    for _ in range(4):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        seen.append(scope.get_value(w).clone().numpy())
    assert not np.array_equal(seen[0], seen[1])
    np.testing.assert_array_equal(seen[2], seen[1])
    np.testing.assert_array_equal(seen[3], seen[1])
