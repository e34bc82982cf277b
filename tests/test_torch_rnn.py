"""``dynamic_lstm`` and ``dynamic_gru`` through the PyTorch port against
the JAX package, on the CPU.

One-op programs (the layer, then a loss that weighs every output entry
differently) built in both packages, with the same parameters (seeded by
name: both packages mint the same names), run in both with the flag that
routes the op to its fused entry (``FLAGS_use_pallas_lstm`` /
``FLAGS_use_pallas_gru``) off and on, in every variant the ops take:
``Length``, reverse, peepholes on and off, an initial state, other
activations. Outputs and the ``@GRAD`` of every parameter agree within
1e-5. The ops' build-time shapes and the program's ops equal the JAX
package's too.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.testing import set_deterministic_params as j_seed_params
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params

TOL = 1e-5
B, T, D = 3, 6, 5
LENS = np.array([[6], [2], [4]], "int64")


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _build(pkg, cell, opts):
    """The one-op program: returns (main, startup, loss, outputs)."""
    layers = pkg.layers
    gates = 4 if cell == "lstm" else 3
    x = layers.data("x", shape=[T, gates * D])
    wts = layers.data("wts", shape=[T, D])
    length = (layers.data("len", shape=[1], dtype="int64")
              if opts.get("length") else None)
    h0 = layers.data("h0", shape=[D]) if opts.get("init") else None
    if cell == "lstm":
        c0 = layers.data("c0", shape=[D]) if opts.get("init") else None
        outs = list(layers.dynamic_lstm(
            x, size=4 * D, length=length, h_0=h0, c_0=c0,
            use_peepholes=opts.get("peep", True),
            is_reverse=opts.get("reverse", False),
            gate_activation=opts.get("gate", "sigmoid"),
            cell_activation=opts.get("cell_act", "tanh"),
            candidate_activation=opts.get("cand", "tanh")))
    else:
        outs = [layers.dynamic_gru(
            x, size=D, length=length, h_0=h0,
            is_reverse=opts.get("reverse", False),
            gate_activation=opts.get("gate", "sigmoid"),
            candidate_activation=opts.get("cand", "tanh"))]
    terms = [layers.reduce_sum(layers.elementwise_mul(o, wts)) for o in outs]
    loss = terms[0] if len(terms) == 1 else layers.elementwise_add(*terms)
    return loss, outs


def _feed(cell, opts):
    rng = np.random.RandomState(11)
    gates = 4 if cell == "lstm" else 3
    feed = {"x": (0.5 * rng.randn(B, T, gates * D)).astype("float32"),
            "wts": rng.randn(B, T, D).astype("float32")}
    if opts.get("length"):
        feed["len"] = LENS
    if opts.get("init"):
        feed["h0"] = (0.5 * rng.randn(B, D)).astype("float32")
        feed["c0"] = (0.5 * rng.randn(B, D)).astype("float32")
    return feed


def _run_both(cell, opts, fused):
    """Run the program in both packages with the routing flag set to
    ``fused``; returns per package (fetched values by name, program)."""
    flag = "use_pallas_lstm" if cell == "lstm" else "use_pallas_gru"
    feed = _feed(cell, opts)
    if cell == "gru":
        feed.pop("c0", None)
    res = {}
    for name, pkg, unique_name, flags in (
            ("jax", jfluid, j_unique_name, j_flags),
            ("torch", tfluid, t_unique_name, t_flags)):
        main, startup = pkg.Program(), pkg.Program()
        with unique_name.guard({}), pkg.program_guard(main, startup):
            loss, outs = _build(pkg, cell, opts)
            _, params_grads = pkg.optimizer.SGD(
                learning_rate=0.0).minimize(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = JScope() if pkg is jfluid else tfluid.Scope()
        exe.run(startup, scope=scope)
        (j_seed_params if pkg is jfluid else set_deterministic_params)(
            main, scope)
        fetch = ([o.name for o in outs] + [p.name for p, _ in params_grads]
                 + [g.name for _, g in params_grads])
        flags.set_flag(flag, fused)
        try:
            vals = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        finally:
            flags.set_flag(flag, False)
        res[name] = (dict(zip(fetch, (np.asarray(v) for v in vals))), main,
                     outs)
    return res


LSTM_CASES = {
    "length_peepholes": dict(length=True),
    "reverse_length": dict(length=True, reverse=True),
    "no_peepholes_no_length": dict(peep=False),
    "mt_encoder_reverse": dict(length=True, reverse=True, peep=False),
    "h0_c0_length": dict(length=True, init=True),
    "acts_relu_identity": dict(length=True, cell_act="relu",
                               cand="identity"),
}
GRU_CASES = {
    "length": dict(length=True),
    "reverse_length": dict(length=True, reverse=True),
    "no_length": dict(),
    "h0_length": dict(length=True, init=True),
    "acts_tanh_relu": dict(length=True, gate="tanh", cand="relu"),
}


def _check(res):
    (jv, jm, jouts), (tv, tm, touts) = res["jax"], res["torch"]
    assert set(tv) == set(jv) and any(n.endswith("@GRAD") for n in tv)
    for name in jv:
        np.testing.assert_allclose(tv[name], jv[name], rtol=TOL, atol=TOL,
                                   err_msg=name)
    assert ([op.type for op in tm.global_block().ops]
            == [op.type for op in jm.global_block().ops])
    for j, t in zip(jouts, touts):
        assert tuple(t.shape) == tuple(j.shape)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(LSTM_CASES))
def test_dynamic_lstm_matches_jax(case, fused):
    _check(_run_both("lstm", LSTM_CASES[case], fused))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(GRU_CASES))
def test_dynamic_gru_matches_jax(case, fused):
    _check(_run_both("gru", GRU_CASES[case], fused))


def test_length_freezes_the_state_past_each_end():
    """The port's twin of tests/test_rnn.py's length-mask test: a step
    past a row's length repeats the row's last state; a reverse pass
    runs the padded steps first and keeps them at the zero state."""
    res = _run_both("lstm", dict(length=True, reverse=True), False)
    vals, _, outs = res["torch"]
    hidden = vals[outs[0].name]
    np.testing.assert_array_equal(hidden[1, 2:], 0.0)
    assert np.abs(hidden[1, :2]).min() > 0
    res = _run_both("lstm", dict(length=True), False)
    vals, _, outs = res["torch"]
    hidden = vals[outs[0].name]
    np.testing.assert_array_equal(hidden[1, 2:], np.broadcast_to(
        hidden[1, 1], (T - 2, D)))
