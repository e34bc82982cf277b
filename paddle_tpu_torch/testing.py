"""Testing utilities: deterministic parameters and fresh port state.

``set_deterministic_params`` is a copy of ``paddle_tpu/testing.py``'s:
every float persistable is overwritten with numpy values seeded by the
variable's NAME, so the two packages (which mint identical names) hold
bit-identical weights, and the committed goldens in ``tests/golden/``
apply to the port too. ``fresh_state`` gives a test fresh default
programs, name counters and global scope of this package (the JAX
package's conftest resets only its own). The control-flow builders
(``while_loss`` to ``lod_array``, and ``control_flow_cases``) build one
construct each through either package.
"""

import contextlib
import hashlib

import numpy as np
import torch

from paddle_tpu_torch.framework import Parameter


def _seed_of(name):
    return int.from_bytes(
        hashlib.md5(name.encode("utf-8")).digest()[:4], "little")


def set_deterministic_params(program, scope, scale=0.1,
                             parameters_only=False):
    """Overwrite every float persistable of ``program`` that ``scope``
    holds with seeded numpy values, on the device it already lives on.
    ``parameters_only`` leaves every other persistable (an optimizer's
    accumulators and learning rate) as the startup program set it."""
    for var in program.global_block().vars.values():
        if not getattr(var, "persistable", False):
            continue
        if parameters_only and not isinstance(var, Parameter):
            continue
        cur = scope.get_value(var.name)
        if cur is None:
            continue
        if not isinstance(cur, torch.Tensor):
            cur = torch.from_numpy(np.asarray(cur))
        if not cur.dtype.is_floating_point:
            continue
        rng = np.random.RandomState(_seed_of(var.name))
        lname = var.name.lower()
        # batch_norm running stats: variances stay positive
        if "variance" in lname or ".var_" in lname or \
                lname.endswith("_var") or lname.endswith(".var"):
            val = 0.5 + rng.rand(*cur.shape)
        elif "mean" in lname:
            val = 0.05 * rng.randn(*cur.shape)
        else:
            val = scale * rng.randn(*cur.shape)
        scope.set_value(var.name, torch.from_numpy(val).to(
            dtype=cur.dtype, device=cur.device))


@contextlib.contextmanager
def fresh_state():
    """Fresh default main/startup programs, ``unique_name`` counters and
    global scope for this package, restored on exit."""
    from paddle_tpu_torch import executor, framework, unique_name
    from paddle_tpu_torch.core.scope import Scope

    prev_main = framework.switch_main_program(framework.Program())
    prev_startup = framework.switch_startup_program(framework.Program())
    prev_names = unique_name.switch({})
    prev_stack = executor._scope_stack[:]
    executor._scope_stack[:] = [Scope()]
    try:
        yield
    finally:
        framework.switch_main_program(prev_main)
        framework.switch_startup_program(prev_startup)
        unique_name.switch(prev_names)
        executor._scope_stack[:] = prev_stack


# -- control-flow programs ---------------------------------------------------
# Each builds one construct through ``fluid`` (either package: the two mint
# the same names) inside the caller's program guard and returns its fetch
# vars. tests/test_torch_control_flow.py holds the two packages' runs of
# them equal on the CPU; chip_smoke.py holds the card's run to the CPU's.


def while_loss(fluid, max_iterations, iters=3, n=4, name="w_while"):
    """``acc += x * w`` for ``iters`` iterations of a ``While`` (bounded
    at ``max_iterations``, or unbounded at 0): (mean(acc), w, acc, i)."""
    L = fluid.layers
    x = L.data(name="x", shape=[n], append_batch_size=False)
    w = L.create_parameter([n], "float32", name=name)
    acc = L.fill_constant([n], "float32", 0.0)
    i = L.fill_constant([1], "int64", 0)
    limit = L.fill_constant([1], "int64", iters)
    cond = L.less_than(i, limit)
    loop = L.While(cond, max_iterations=max_iterations)
    with loop.block():
        step = L.elementwise_mul(x, w)
        acc2 = L.elementwise_add(acc, step)
        L.assign(acc2, acc)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, limit, cond=cond)
    return L.mean(acc), w, acc, i


def bounded_while_grad(fluid, iters=5, n=8):
    """``while_loss`` in a loop bounded at ``iters + 3`` and the gradient
    of its loss: [loss, acc, i, w@GRAD]."""
    loss, w, acc, i = while_loss(fluid, iters + 3, iters=iters, n=n)
    return [loss, acc, i] + fluid.backward.calc_gradient([loss], [w])


def array_loop(fluid, max_iterations=0):
    """The decode-loop pattern: a tensor array seeded before a ``While``
    and grown inside it; [row 4, row 11 (past the capacity of 8: it
    clamps), the array's length, i]."""
    L = fluid.layers
    x = L.data("x", shape=[3])
    i = L.fill_constant([1], "int64", 1)
    limit = L.fill_constant([1], "int64", 5)
    i0 = L.fill_constant([1], "int64", 0)
    arr = L.array_write(x, i0, capacity=8)
    cond = L.less_than(i, limit)
    w = L.While(cond, max_iterations=max_iterations)
    with w.block():
        prev = L.array_read(arr, L.elementwise_sub(
            i, L.fill_constant([1], "int64", 1)))
        L.array_write(L.scale(prev, scale=2.0), i, array=arr)
        L.increment(i, value=1, in_place=True)
        L.less_than(i, limit, cond=cond)
    last = L.array_read(arr, L.fill_constant([1], "int64", 4))
    past = L.array_read(arr, L.fill_constant([1], "int64", 11))
    return [last, past, L.array_length(arr), i]


def static_rnn_dropout(fluid, T=3, D=16):
    """A ``StaticRNN`` whose step adds ``dropout(x_t)`` to its memory
    (initial value 1): [the step outputs [B, T, D]]."""
    L = fluid.layers
    inp = L.data("x", shape=[T, D])
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(inp)
        h_prev = rnn.memory(shape=[-1, D], batch_ref=inp, init_value=1.0)
        h = L.elementwise_add(L.dropout(x_t, dropout_prob=0.5), h_prev)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
    return [rnn()]


def dynamic_rnn(fluid, T=5, D=4, H=6):
    """A masked ``DynamicRNN`` (``fc`` of the word and the memory, tanh)
    over ``x`` [B, T, D] at lengths ``len``, the mean square of its last
    steps and every parameter's gradient: [out, loss, grads...]."""
    L = fluid.layers
    x = L.data("x", shape=[T, D])
    ln = L.data("len", shape=[1], dtype="int64")
    rnn = L.DynamicRNN(lengths=ln)
    with rnn.block():
        w = rnn.step_input(x)
        h_prev = rnn.memory(shape=[-1, H], batch_ref=x)
        h = L.fc(input=[w, h_prev], size=H, act="tanh")
        rnn.update_memory(h_prev, h)
        rnn.output(h)
    out = rnn()
    loss = L.mean(L.square(L.sequence_last_step(out, length=ln)))
    grads = fluid.backward.append_backward(loss)
    return [out, loss] + [g for _, g in sorted(
        grads, key=lambda pg: pg[0].name)]


def cond_pair(fluid):
    """Two ``cond``s on ``p``: [2x or -x, 3x or x]."""
    L = fluid.layers
    x = L.data("x", shape=[4])
    p = L.data("p", shape=[1], dtype="bool")
    out = L.cond(p, lambda: L.scale(x, scale=2.0),
                 lambda: L.scale(x, scale=-1.0))
    keep = L.cond(p, lambda: L.scale(x, scale=3.0), lambda: x)
    return [out, keep]


def switch(fluid):
    """A ``Switch`` of three cases and a default on the scalar ``x``:
    10x below 1, 100x below 2, -3 below 3, else -1."""
    L = fluid.layers
    x = L.data("x", shape=[1], append_batch_size=False)
    out = L.fill_constant([1], "float32", 0.0)
    one = L.fill_constant([1], "float32", 1.0)
    two = L.fill_constant([1], "float32", 2.0)
    sw = L.Switch()
    with sw.case(L.less_than(x, one)):
        L.assign(L.scale(x, scale=10.0), out)
    with sw.case(L.less_than(x, two)):
        L.assign(L.scale(x, scale=100.0), out)
    with sw.case(L.less_than(x, L.fill_constant([1], "float32", 3.0))):
        L.assign(L.fill_constant([1], "float32", -3.0), out)
    with sw.default():
        L.assign(L.fill_constant([1], "float32", -1.0), out)
    return [out]


def ifelse(fluid):
    """An ``IfElse`` on the rows of ``c``: 10x where true, 0 where
    false."""
    L = fluid.layers
    x = L.data("x", shape=[3])
    c = L.data("c", shape=[1], dtype="bool")
    ie = L.IfElse(c)
    with ie.true_block():
        ie.output(L.scale(x, scale=10.0))
    with ie.false_block():
        ie.output(L.scale(x, scale=0.0))
    return list(ie())


def lod_array(fluid, T=4, D=3):
    """``x`` [B, T, D] through ``lod_tensor_to_array`` and back, and the
    gradient of the square sum of the result: [back, row 1, the array's
    length, x@GRAD]."""
    L = fluid.layers
    x = L.data("x", shape=[T, D])
    x.stop_gradient = False
    ln = L.data("len", shape=[1], dtype="int64")
    table = L.lod_rank_table(x, lengths=ln)
    arr = L.lod_tensor_to_array(x, table)
    row = L.array_read(arr, L.fill_constant([1], "int64", 1))
    back = L.array_to_lod_tensor(arr, table)
    loss = L.reduce_sum(L.square(back))
    (gx,) = fluid.backward.calc_gradient([loss], [x])
    return [back, row, L.array_length(arr), gx]


def control_flow_cases(seed=47):
    """One case of each construct: (name, build(fluid) -> fetch vars,
    feeds), the feeds drawn from ``seed``."""
    r = np.random.RandomState(seed)

    def f32(*shape):
        return r.randn(*shape).astype("float32")

    return [
        ("StaticRNN dropout", static_rnn_dropout,
         [{"x": np.ones((4, 3, 16), "float32")}]),
        ("DynamicRNN masked", dynamic_rnn,
         [{"x": f32(3, 5, 4), "len": np.array([[2], [5], [3]], "int64")}]),
        ("bounded While + grad", bounded_while_grad, [{"x": f32(8)}]),
        ("unbounded While + array", array_loop, [{"x": f32(2, 3)}]),
        ("cond", cond_pair, [{"x": f32(2, 4), "p": np.array([v])}
                             for v in (True, False)]),
        ("Switch", switch, [{"x": np.array([v], "float32")}
                            for v in (0.5, 1.5, 2.5, 7.0)]),
        ("IfElse", ifelse, [{"x": f32(4, 3), "c": np.array(
            [[True], [False], [True], [False]])}]),
        ("lod_tensor_to_array and back", lod_array,
         [{"x": f32(2, 4, 3), "len": np.array([[2], [4]], "int64")}]),
    ]
