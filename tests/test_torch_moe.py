"""The Mixture-of-Experts FFN (``moe_ffn``) and the Switch Transformer
of the port, on the CPU: ``tests/test_moe.py``'s cases (expert
parallelism aside, A10) and parity with the JAX package.

- the numpy mirror of Switch routing (token order, queue positions,
  top-2 renormalization by the pre-drop gates), roomy and dropping, top-1
  and top-2;
- capacity overflow keeps exactly the first token; the aux loss scores
  collapse at full strength; a padding mask keeps pads out of routing; a
  named ``ParamAttr`` makes five distinct parameters (``_gate``, ``_w1``,
  ``_b1``, ``_w2``, ``_b2``); an MoE regression and the Switch
  Transformer classifier train;
- the port's index routing (``ops/moe_ops.py`` ``route``) against the JAX
  package's one-hot ``_route_one``: experts, kept routes, queue slots and
  gates equal, with overflow, top-2 and a mask;
- one ``moe_ffn`` program in both packages from the same weights (carried
  into the port by ``convert.params_from_numpy``): ``Out``, ``AuxLoss``
  and the gradients of X and of all five parameters within 1e-5, at
  top-1 and top-2, with overflow, with a padding mask, relu and gelu.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.testing import fresh_state

fluid = tfluid
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _build(e=4, h=8, d=6, top_k=1, cap=4.0, act="identity", seed=3):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [5, d])
        out, aux = fluid.layers.moe_ffn(
            x, num_experts=e, d_hidden=h, top_k=top_k,
            capacity_factor=cap, act=act, name="moe")
        loss = fluid.layers.mean(out)
    return main, startup, x, out, aux, loss


def _params(scope, prefix="moe"):
    names = sorted(n for n in scope.local_var_names()
                   if n.startswith(prefix) and ".w_" in n)
    return [np.asarray(scope.get_value(n)) for n in names]


def _np_moe(xv, gate_w, w1, b1, w2, b2, top_k, capacity, act=lambda v: v):
    """Numpy mirror of the Switch routing (token order, queue positions)."""
    n, d = xv.reshape(-1, xv.shape[-1]).shape
    xf = xv.reshape(-1, d).astype(np.float64)
    logits = xf @ gate_w.astype(np.float64)
    ex = np.exp(logits - logits.max(-1, keepdims=True))
    probs = ex / ex.sum(-1, keepdims=True)
    e = gate_w.shape[1]
    out = np.zeros_like(xf)
    counts = np.zeros(e, int)
    chosen = [[] for _ in range(n)]
    for route in range(top_k):
        for i in range(n):
            p = probs[i].copy()
            p[chosen[i]] = 0.0
            sel = int(np.argmax(p))
            gate = p[sel]
            pos = counts[sel]
            counts[sel] += 1
            chosen[i].append(sel)
            if pos < capacity:
                hdn = act(xf[i] @ w1[sel].astype(np.float64)
                          + b1[sel].astype(np.float64))
                y = hdn @ w2[sel].astype(np.float64) + b2[sel].astype(
                    np.float64)
                out[i] += gate * y
    if top_k > 1:
        for i in range(n):
            tot = sum(probs[i][s] for s in chosen[i][:top_k])
            out[i] = out[i] / (tot + 1e-9) if tot > 0 else out[i]
    return out.reshape(xv.shape)


@pytest.mark.parametrize("cap", [8.0, 0.6], ids=["roomy", "dropping"])
@pytest.mark.parametrize("top_k", [1, 2], ids=["top1", "top2"])
def test_moe_matches_numpy_mirror(top_k, cap):
    e, h, d = 4, 8, 6
    main, startup, x, out, aux, _ = _build(e=e, h=h, d=d, top_k=top_k,
                                           cap=cap)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    gate_w, w1, b1, w2, b2 = _params(fluid.global_scope())
    assert gate_w.shape == (d, e) and w1.shape == (e, d, h)
    xv = np.random.RandomState(5).randn(3, 5, d).astype("float32")
    capacity = max(1, int(cap * 3 * 5 * top_k / e))
    (ov,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    expect = _np_moe(xv, gate_w, w1, b1, w2, b2, top_k, capacity)
    np.testing.assert_allclose(np.asarray(ov), expect, atol=1e-4,
                               rtol=1e-3)


def _gate_name(scope, prefix):
    return [n for n in scope.local_var_names()
            if n.startswith(prefix) and ".w_0" in n][0]


def test_moe_capacity_drops_overflow():
    """Every token on expert 0 with capacity 1: exactly the first token
    gets an output (Switch overflow rule, token order)."""
    e, h, d = 4, 8, 6
    main, startup, x, out, aux, _ = _build(e=e, h=h, d=d, cap=1e-9)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    scope = fluid.global_scope()
    gw = np.zeros((d, e), "float32")
    gw[:, 0] = 5.0
    scope.set_value(_gate_name(scope, "moe"), torch.from_numpy(gw))
    xv = (0.1 + np.abs(
        np.random.RandomState(6).randn(2, 5, d))).astype("float32")
    (ov,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    nonzero = np.abs(np.asarray(ov).reshape(-1, d)).sum(-1) > 1e-7
    assert nonzero.sum() == 1 and nonzero[0], nonzero


def test_moe_aux_loss_prefers_balance():
    """Collapse onto one expert scores about E even where the capacity
    drops most of the collapsed tokens (f from pre-drop choices)."""
    e, h, d = 4, 8, 8
    main, startup, x, out, aux, _ = _build(e=e, h=h, d=d, cap=1.0)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    scope = fluid.global_scope()
    gate = _gate_name(scope, "moe")
    xv = np.eye(8, d, dtype="float32")[None].repeat(2, 0)
    collapsed = np.zeros((d, e), "float32")
    collapsed[:, 2] = 4.0
    scope.set_value(gate, torch.from_numpy(collapsed))
    (a_col,) = exe.run(main, feed={"x": xv}, fetch_list=[aux])
    balanced = np.zeros((d, e), "float32")
    for j in range(d):
        balanced[j, j % e] = 4.0
    scope.set_value(gate, torch.from_numpy(balanced))
    (a_bal,) = exe.run(main, feed={"x": xv}, fetch_list=[aux])
    a_col, a_bal = float(np.ravel(a_col)[0]), float(np.ravel(a_bal)[0])
    assert a_bal < a_col
    assert a_col > 0.5 * e, a_col


def test_moe_trains_with_aux():
    d = 8
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 9
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, d])
        t = fluid.layers.data("t", [4, d])
        y, aux = fluid.layers.moe_ffn(x, num_experts=4, d_hidden=16,
                                      top_k=2, act="gelu", name="m2")
        err = fluid.layers.mean(
            fluid.layers.square(fluid.layers.elementwise_sub(y, t)))
        loss = err + 0.01 * fluid.layers.mean(aux)
        fluid.optimizer.Adam(5e-3).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(10)
    xv = rng.randn(8, 4, d).astype("float32")
    tv = np.tanh(xv) * 0.5
    losses = []
    for _ in range(60):
        (lv,) = exe.run(main, feed={"x": xv, "t": tv}, fetch_list=[err])
        losses.append(float(np.ravel(lv)[0]))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert exe.grad_op_reruns == 0


def test_moe_named_param_attr_creates_distinct_params():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4, 6])
        out, _ = fluid.layers.moe_ffn(
            x, num_experts=2, d_hidden=8,
            param_attr=fluid.ParamAttr(name="named_moe"))
    params = sorted(p.name for p in main.global_block().all_parameters()
                    if p.name.startswith("named_moe"))
    assert params == ["named_moe_b1", "named_moe_b2", "named_moe_gate",
                      "named_moe_w1", "named_moe_w2"], params
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    (ov,) = exe.run(main, feed={"x": np.zeros((2, 4, 6), "float32")},
                    fetch_list=[out])
    assert np.asarray(ov).shape == (2, 4, 6)


def test_switch_transformer_model_trains():
    """models/switch_transformer: the MoE encoder classifier learns a
    separable toy task (first-token parity decides the class)."""
    from paddle_tpu_torch.models import switch_transformer

    vocab, seq = 20, 8
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 21
    with fluid.program_guard(main, startup):
        loss, feeds, extras = switch_transformer.build(
            vocab_size=vocab, max_length=seq, n_layer=2, n_head=2,
            d_model=16, d_inner=32, num_experts=4, top_k=1,
            moe_every=2, num_classes=2)
        fluid.optimizer.Adam(3e-3).minimize(loss)
    assert extras["aux_loss"] is not None
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(22)
    losses = []
    for _ in range(90):
        w = rng.randint(1, vocab, (16, seq)).astype("int64")
        (lv,) = exe.run(
            main, feed={"word": w, "seq_len": np.full((16, 1), seq, "int64"),
                        "label": (w[:, :1] % 2).astype("int64")},
            fetch_list=[extras["ce_loss"]])
        losses.append(float(np.ravel(lv)[0]))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert exe.grad_op_reruns == 0


def test_moe_mask_keeps_padding_out_of_routing():
    """Pads get zero output and take no capacity (the one real token is
    served though the pads come first), and the aux statistics run over
    the valid token only."""
    e, h, d = 2, 8, 6
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [6, d])
        m = fluid.layers.data("m", [6])
        out, aux = fluid.layers.moe_ffn(
            x, num_experts=e, d_hidden=h, capacity_factor=0.5, mask=m,
            name="mk")
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    xv = np.random.RandomState(30).randn(1, 6, d).astype("float32")
    mv = np.zeros((1, 6), "float32")
    mv[0, -1] = 1.0
    ov, av = exe.run(main, feed={"x": xv, "m": mv}, fetch_list=[out, aux])
    ov = np.asarray(ov)[0]
    assert (np.abs(ov[:-1]).sum(-1) < 1e-7).all()
    assert np.abs(ov[-1]).sum() > 1e-4
    assert 0.0 < float(np.ravel(av)[0]) <= e + 1e-5


def _jax_routes(probs, capacity, top_k, valid):
    """The JAX package's routing, as its lowering loops ``_route_one``:
    per route (expert, gate after the drop, kept, slot)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.moe_ops import _route_one

    probs = jnp.asarray(probs)
    n, e = probs.shape
    v = None if valid is None else jnp.asarray(valid, jnp.float32)
    used = jnp.zeros_like(probs)
    masked, base = probs, jnp.zeros((e,), probs.dtype)
    out = []
    for _ in range(top_k):
        expert, gate, _, dispatch, base = _route_one(masked, base,
                                                     capacity, v)
        disp = np.asarray(dispatch).reshape(n, -1)
        out.append((np.asarray(expert), np.asarray(gate),
                    disp.sum(-1) > 0, disp.argmax(-1)))
        used = used + jax.nn.one_hot(expert, e, dtype=probs.dtype)
        masked = probs * (1.0 - used)
    return out


@pytest.mark.parametrize("top_k,capacity,masked", [
    (1, 64, False), (1, 3, False), (2, 5, False), (2, 4, True),
    (1, 2, True)], ids=["top1_roomy", "top1_overflow", "top2_overflow",
                        "top2_mask", "top1_mask_overflow"])
def test_index_routing_equals_the_one_hot_routing(top_k, capacity, masked):
    """Experts, kept routes, queue slots and post-drop gates equal the JAX
    package's dense one-hot dispatch, route by route."""
    from paddle_tpu_torch.ops.moe_ops import route

    rng = np.random.RandomState(top_k * 10 + capacity)
    n, e = 24, 4
    logits = rng.randn(n, e).astype("float32") * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = (rng.rand(n) > 0.3) if masked else None
    if masked:
        probs = probs * valid[:, None]
    want = _jax_routes(probs, capacity, top_k, valid)
    got = route(torch.from_numpy(probs), capacity, top_k,
                None if valid is None else torch.from_numpy(valid))
    assert len(got) == len(want) == top_k
    dropped = 0
    for (expert, gate, keep, slot), (j_expert, j_gate, j_keep, j_slot) in \
            zip(got, want):
        np.testing.assert_array_equal(expert.numpy(), j_expert)
        np.testing.assert_array_equal(keep.numpy(), j_keep)
        np.testing.assert_array_equal(slot.numpy()[j_keep], j_slot[j_keep])
        np.testing.assert_allclose((gate * keep).numpy(), j_gate, rtol=0,
                                   atol=0)
        dropped += int((~j_keep).sum())
    if capacity < n * top_k // e:
        assert dropped > 0


def _moe_run(pkg, unique_name, xv, mv, arrays, top_k, cap, act):
    """One moe_ffn program: Out, AuxLoss, and the gradients of X and the
    five parameters of ``sum(Out * W) + 3 * AuxLoss``."""
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", list(xv.shape[1:]), stop_gradient=False)
        w = pkg.layers.data("w", list(xv.shape[1:]))
        m = pkg.layers.data("m", list(mv.shape[1:])) if mv is not None \
            else None
        out, aux = pkg.layers.moe_ffn(
            x, num_experts=4, d_hidden=8, top_k=top_k, capacity_factor=cap,
            act=act, mask=m, param_attr=pkg.ParamAttr(name="moe"))
        loss = pkg.layers.elementwise_add(
            pkg.layers.reduce_sum(pkg.layers.elementwise_mul(out, w)),
            pkg.layers.scale(aux, scale=3.0))
        params = sorted(main.global_block().all_parameters(),
                        key=lambda p: p.name)
        grads = pkg.backward.calc_gradient(loss, [x] + params)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = JScope() if pkg is jfluid else tfluid.Scope()
    exe.run(startup, scope=scope)
    if pkg is jfluid:
        for name, a in arrays.items():
            scope.set_value(name, a)
    else:
        params_from_numpy(main, scope, arrays, "cpu")
    feed = {"x": xv, "w": np.random.RandomState(8).uniform(
        0.5, 1.5, xv.shape).astype("float32")}
    if mv is not None:
        feed["m"] = mv
    return [np.asarray(v) for v in exe.run(
        main, feed=feed, fetch_list=[out, aux] + grads, scope=scope)]


@pytest.mark.parametrize("top_k,cap,masked,act", [
    (1, 4.0, False, "gelu"), (1, 0.5, False, "gelu"),
    (2, 0.75, False, "relu"), (2, 4.0, True, "gelu"),
    (1, 0.6, True, "identity")], ids=[
        "top1_roomy", "top1_overflow", "top2_overflow", "top2_mask",
        "top1_mask_overflow"])
def test_moe_ffn_matches_jax(top_k, cap, masked, act):
    rng = np.random.RandomState(40 + top_k)
    d = 6
    arrays = {"moe_gate": (rng.randn(d, 4) * 1.5).astype("float32"),
              "moe_w1": (rng.randn(4, d, 8) * 0.5).astype("float32"),
              "moe_b1": (rng.randn(4, 8) * 0.1).astype("float32"),
              "moe_w2": (rng.randn(4, 8, d) * 0.5).astype("float32"),
              "moe_b2": (rng.randn(4, d) * 0.1).astype("float32")}
    xv = rng.randn(3, 5, d).astype("float32")
    mv = (rng.rand(3, 5) > 0.3).astype("float32") if masked else None
    want = _moe_run(jfluid, j_unique_name, xv, mv, arrays, top_k, cap, act)
    got = _moe_run(tfluid, t_unique_name, xv, mv, arrays, top_k, cap, act)
    assert len(got) == len(want) == 2 + 1 + 5
    for name, g, w in zip(["Out", "AuxLoss", "dX", "db1", "db2", "dgate",
                           "dw1", "dw2"], got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)
    out = want[0].reshape(-1, d)
    if masked:
        assert (np.abs(out[mv.reshape(-1) == 0]).sum(-1) == 0).all()
