"""The sequence ops, their layers, the seqconv fuse pass and the book's
sentiment CNN in the PyTorch port against the JAX package, on the CPU.

Each op case runs the JAX lowering and the port's on the same seeded
inputs: every output within 1e-5 (integer outputs equal), and the
gradients of a random cotangent in every float input that takes one
within 1e-5 of ``jax.vjp``'s. The cases are the twins of the sequence
rows of ``tests/test_nlp_ops.py``, ``tests/test_op_breadth_misc.py``,
``tests/test_check_grad_sweep.py`` (``fusion_seqconv_eltadd_relu``
included) and ``tests/test_layers_misc.py``; the layer cases build the
same program in both packages (state carried over with ``convert.py``).
``seqconv_eltadd_relu_fuse`` fuses what the JAX pass fuses and leaves
the outputs as they were; ``fusion_seqexpand_concat_fc`` equals its
unfused chain. The sentiment CNN (``models/understand_sentiment.py``)
at embedding 16, hid 32 and T 24 takes 3 Adagrad steps in both packages:
losses within 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core import op_registry as j_registry
from paddle_tpu.core.passes import apply_pass as j_apply_pass
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.core import op_registry as t_registry
from paddle_tpu_torch.core.passes import PassManager
from paddle_tpu_torch.core.passes import apply_pass as t_apply_pass
from paddle_tpu_torch.models import understand_sentiment as sentiment
from paddle_tpu_torch.testing import fresh_state

TOL = 1e-5
rng = np.random.RandomState(53)


def f32(*shape):
    return rng.randn(*shape).astype("float32")


def lens(*v):
    return np.asarray(v, "int64")


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _as_list(v):
    return list(v) if isinstance(v, list) else [v]


def op_twin(op_type, ins, attrs, tol=TOL, grad_tol=TOL):
    """Run ``op_type``'s JAX and torch lowerings on ``ins`` (slot ->
    array, or a list for a duplicable slot); outputs compared within
    ``tol``, input gradients within ``grad_tol``. Returns the torch
    outputs."""
    jdef = j_registry.get_op_def(op_type)
    tdef = t_registry.get_op_def(op_type)
    attrs = dict(jdef.attrs, **attrs)
    ctx = types.SimpleNamespace(is_test=False)
    flat = [(s, i, a) for s in sorted(ins)
            for i, a in enumerate(_as_list(ins[s]))]
    diff = [k for k, (s, _, a) in enumerate(flat)
            if a.dtype.kind == "f" and s not in jdef.no_grad_inputs
            and jdef.grad is not None]

    def pack(vals):
        out = {}
        for (s, _, _), v in zip(flat, vals):
            out.setdefault(s, []).append(v)
        return out

    def jfn(fixed, *dvals):
        vals = list(fixed)
        for k, v in zip(diff, dvals):
            vals[k] = v
        res = j_registry.normalize_outputs(
            jdef, jdef.lower(ctx, pack(vals), attrs))
        return {s: v[0] for s, v in res.items()}

    # every input an argument of the jitted function, as the executor's
    # state and feeds are (no constant folding of the non-diff inputs)
    fixed = [jnp.asarray(a) for _, _, a in flat]
    dargs = tuple(fixed[k] for k in diff)
    want = jax.jit(jfn)(fixed, *dargs)
    leaves = [torch.from_numpy(a.copy()) for _, _, a in flat]
    for k in diff:
        leaves[k].requires_grad_(True)
    got = t_registry.normalize_outputs(
        tdef, tdef.lower(ctx, pack(leaves), attrs))
    got = {s: v[0] for s, v in got.items()}
    for slot, w in want.items():
        g = got[slot].detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=slot)
        else:
            np.testing.assert_array_equal(g, w, err_msg=slot)
    if not diff:
        return got
    outs = [s for s, w in want.items() if np.asarray(w).dtype.kind == "f"
            and s not in jdef.intermediate_outputs]
    cots = {s: rng.randn(*np.asarray(want[s]).shape).astype("float32")
            for s in outs}

    def run(fixed, dargs, cots):
        res, vjp = jax.vjp(lambda *d: {s: jfn(fixed, *d)[s] for s in outs},
                           *dargs)
        return vjp(cots)

    jgrads = jax.jit(run)(fixed, dargs, {s: jnp.asarray(c) for s, c in
                                         cots.items()})
    tgrads = torch.autograd.grad(
        [got[s] for s in outs], [leaves[k] for k in diff],
        [torch.from_numpy(cots[s]) for s in outs], allow_unused=True)
    for k, g, jg in zip(diff, tgrads, jgrads):
        g = np.zeros_like(np.asarray(jg)) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(jg), rtol=grad_tol,
                                   atol=grad_tol,
                                   err_msg="d%s[%d]" % flat[k][:2])
    return got


TIED = np.round(f32(2, 5, 3)).astype("float32")   # many tied maxima
OPS = [
    # tests/test_check_grad_sweep.py:144-170
    ("sequence_pool", {"X": (rng.permutation(24).reshape(2, 4, 3) * 0.37)
                       .astype("float32"), "Length": lens(4, 2)},
     {"pooltype": "AVERAGE"}),
    ("sequence_pool", {"X": f32(2, 4, 3), "Length": lens(4, 2)},
     {"pooltype": "SUM"}),
    ("sequence_pool", {"X": f32(2, 4, 3), "Length": lens(4, 2)},
     {"pooltype": "SQRT"}),
    ("sequence_pool", {"X": TIED, "Length": lens(5, 3)},
     {"pooltype": "MAX"}),
    ("sequence_softmax", {"X": f32(2, 5), "Length": lens(5, 3)}, {}),
    ("sequence_softmax", {"X": f32(3, 4)}, {}),
    ("sequence_conv", {"X": f32(2, 5, 3), "Filter": f32(9, 4),
                       "Length": lens(5, 4)},
     {"contextLength": 3, "contextStart": -1}),
    ("sequence_conv", {"X": f32(3, 7, 4), "Filter": f32(16, 5),
                       "Length": lens(7, 2, 5)},
     {"contextLength": 4, "contextStart": -2}),
    ("sequence_conv", {"X": f32(2, 6, 3), "Filter": f32(6, 2)},
     {"contextLength": 2, "contextStart": 0}),
    ("sequence_expand_as", {"X": f32(2, 3), "Y": f32(2, 4, 3)}, {}),
    ("sequence_expand_as", {"X": f32(2, 1, 3), "Y": f32(2, 5, 3)}, {}),
    # tests/test_op_breadth_misc.py:346-390
    ("sequence_pad", {"X": f32(2, 3, 4), "PadValue": np.asarray(
        [0.25], "float32"), "Length": lens(3, 1)}, {"padded_length": 5}),
    ("sequence_pad", {"X": f32(3, 6), "PadValue": np.asarray(
        [-1.0], "float32"), "Length": lens(6, 2, 4)}, {"padded_length": 4}),
    ("sequence_reverse", {"X": f32(2, 4, 3), "Length": lens(4, 2)}, {}),
    ("sequence_reverse", {"X": f32(2, 4)}, {}),
    ("sequence_scatter", {"X": f32(2, 5), "Ids": np.asarray(
        [[0, 3], [1, 4]], "int32"), "Updates": f32(2, 2)}, {}),
    ("sequence_scatter", {"X": f32(2, 5, 3), "Ids": np.asarray(
        [[0, 3, 3], [1, 4, 0]], "int32"), "Updates": f32(2, 3, 3)}, {}),
    # the rest of the family
    ("sequence_expand", {"X": f32(3, 2), "Y": f32(3, 4, 1)}, {}),
    ("sequence_concat", {"X": [f32(2, 3, 2), f32(2, 4, 2)],
                         "Length": [lens(2, 1), lens(4, 1)]}, {}),
    ("sequence_concat", {"X": [f32(3, 3), f32(3, 2), f32(3, 2)]}, {}),
    ("sequence_unpad", {"X": f32(2, 6, 2), "Length": lens(3, 6)}, {}),
    ("sequence_slice", {"X": f32(2, 6, 2), "Offset": lens(2, 0),
                        "Length": lens(3, 5)}, {}),
    ("sequence_erase", {"X": rng.randint(0, 5, (3, 7)).astype("int64"),
                        "Length": lens(7, 4, 0)}, {"tokens": [2, 0]}),
    ("sequence_enumerate", {"X": rng.randint(1, 9, (2, 5)).astype("int64"),
                            "Length": lens(4, 5)},
     {"win_size": 3, "pad_value": -1}),
    ("sequence_reshape", {"X": f32(2, 4, 6)}, {"new_dim": 3}),
    ("lod_reset", {"X": f32(2, 3, 2)}, {"target_lod": [0, 2, 6]}),
    ("lod_rank_table", {"Length": lens(2, 5, 5, 1, 5)}, {}),
    ("reorder_lod_tensor_by_rank", {"X": f32(4, 3), "RankIndex": lens(
        1, 2, 0, 3)}, {}),
    # tests/test_check_grad_sweep.py:339
    ("fusion_seqconv_eltadd_relu", {"X": f32(2, 6, 3),
                                    "Filter": f32(9, 4) * 0.4,
                                    "Bias": np.full((4,), 1.5, "float32")},
     {}),
    ("fusion_seqconv_eltadd_relu", {"X": f32(2, 6, 3), "Filter": f32(9, 4),
                                    "Bias": f32(4), "Length": lens(6, 3)},
     {}),
    ("fusion_seqexpand_concat_fc", {"X": [f32(2, 5, 3), f32(2, 4)],
                                    "FCWeight": f32(7, 6),
                                    "FCBias": f32(6)},
     {"fc_activation": "relu"}),
    ("fusion_seqexpand_concat_fc", {"X": [f32(2, 4, 3), f32(2, 2),
                                          f32(2, 1)],
                                    "FCWeight": f32(6, 3)}, {}),
]


@pytest.mark.parametrize("op_type,ins,attrs", OPS,
                         ids=["%s%d" % (o[0], i) for i, o in enumerate(OPS)])
def test_op_value_and_grad_match_jax(op_type, ins, attrs):
    op_twin(op_type, ins, attrs)


def test_sequence_conv_refuses_stride():
    with pytest.raises(NotImplementedError, match="contextStride"):
        t_registry.get_op_def("sequence_conv").lower(
            None, {"X": [torch.zeros(1, 3, 2)],
                   "Filter": [torch.zeros(6, 1)]},
            {"contextLength": 3, "contextStride": 2})


# -- layer programs through both packages ---------------------------------


def _both(build, feed, grads=()):
    """``build(layers) -> fetch vars`` in both packages from one state;
    with ``grads``, the gradients of the first fetch's sum in those data
    vars are fetched too. Returns {package: [arrays]}."""
    out, state = {}, None
    for name, pkg, unique_name in (("jax", jfluid, j_unique_name),
                                   ("torch", tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 7
        with unique_name.guard({}), pkg.program_guard(main, startup):
            v = {k: pkg.layers.data(k, list(a.shape[1:]), dtype=str(a.dtype),
                                    stop_gradient=k not in grads)
                 for k, a in feed.items()}
            fetch = list(build(pkg.layers, v))
            if grads:
                fetch += pkg.backward.calc_gradient(
                    pkg.layers.reduce_sum(fetch[0]), [v[g] for g in grads])
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            state = {k.name: np.asarray(scope.get_value(k.name))
                     for k in main.global_block().vars.values()
                     if k.persistable and scope.get_value(k.name) is not None}
        else:
            scope = tfluid.Scope()
            persistables_from_numpy(main, scope, state, "cpu")
        out[name] = [np.asarray(a) for a in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope)]
    return out


def _concat(L, v):
    return [L.sequence_concat([v["x"], v["y"]], lengths=[v["lx"], v["ly"]])]


def _erase_enum(L, v):
    erased, n = L.sequence_erase(v["ids"], tokens=[2], length=v["l"])
    return [erased, n, L.sequence_enumerate(v["ids"], win_size=2,
                                            length=v["l"])]


def _slice_unpad(L, v):
    return [L.sequence_slice(v["x"], v["o"], v["l"]),
            L.sequence_unpad(v["x"], v["l"])]


def _seq_conv(L, v):
    return [L.sequence_conv(v["x"], num_filters=4, filter_size=3,
                            length=v["l"], act="tanh")]


def _pool_family(L, v):
    return [L.sequence_softmax(v["s"], length=v["l"]),
            L.sequence_reverse(v["x"], length=v["l"]),
            L.sequence_first_step(v["x"], length=v["l"]),
            L.sequence_last_step(v["x"], length=v["l"]),
            L.sequence_reshape(v["x"], 1),
            L.sequence_pad(v["x"], L.fill_constant([1], "float32", 0.5),
                           maxlen=7, length=v["l"])[0],
            L.sequence_expand_as(v["s"], v["x"])]


def _expand(L, v):
    return [L.sequence_expand(v["x"], v["y"])]


def _rank(L, v):
    table = L.lod_rank_table(lengths=v["lens"])
    y = L.reorder_lod_tensor_by_rank(v["x"], table)
    w = L.assign(np.arange(12, dtype="float32").reshape(4, 3))
    return [L.elementwise_mul(y, w), table.index, table.length]


def _lod_reset_layer(L, v):
    return list(L.lod_reset(v["x"], target_lod=[0, 2, 6]))


def _scatter(L, v):
    return [L.sequence_scatter(v["x"], v["ids"], v["upd"])]


X5 = f32(2, 5, 3)
LAYER_CASES = [
    # tests/test_nlp_ops.py:307-380
    ("sequence_concat", _concat,
     {"x": np.array([[1, 2, 0], [3, 0, 0]], "float32"),
      "y": np.array([[7, 8], [9, 0]], "float32"),
      "lx": np.array([[2], [1]], "int64"),
      "ly": np.array([[2], [1]], "int64")}, ("x", "y")),
    ("sequence_erase_enumerate", _erase_enum,
     {"ids": np.array([[2, 5, 2, 7, 0], [1, 2, 3, 2, 2]], "int64"),
      "l": np.array([[4], [5]], "int64")}, ()),
    ("sequence_slice_unpad", _slice_unpad,
     {"x": np.arange(24, dtype="float32").reshape(2, 6, 2),
      "o": np.array([[2], [0]], "int64"), "l": np.array([[3], [6]],
                                                          "int64")},
     ("x",)),
    ("sequence_conv", _seq_conv, {"x": X5, "l": np.array([[5], [3]],
                                                          "int64")},
     ("x",)),
    ("sequence_pool_family", _pool_family,
     {"x": X5, "s": f32(2, 5), "l": np.array([[5], [2]], "int64")},
     ("s",)),
    # tests/test_layers_misc.py
    ("sequence_expand", _expand,
     {"x": np.asarray([[1.0, 2.0], [3.0, 4.0]], "float32"),
      "y": np.zeros((2, 3, 1), "float32")}, ("x",)),
    ("lod_rank_table_reorder", _rank,
     {"x": np.arange(12, dtype="float32").reshape(4, 3),
      "lens": np.array([[2], [5], [5], [1]], "int64")}, ("x",)),
    ("lod_reset", _lod_reset_layer,
     {"x": np.arange(12, dtype="float32").reshape(2, 3, 2)}, ("x",)),
    ("sequence_scatter", _scatter,
     {"x": f32(2, 5), "ids": np.asarray([[0, 3], [1, 4]], "int32"),
      "upd": f32(2, 2)}, ("x", "upd")),
]


@pytest.mark.parametrize("name,build,feed,grads", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, build, feed, grads):
    res = _both(build, feed, grads)
    assert len(res["torch"]) == len(res["jax"])
    for g, w in zip(res["torch"], res["jax"]):
        assert g.shape == w.shape
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(g, w)


def test_rank_table_orders_and_gradient():
    """lod_rank_table: descending lengths, ties stable; the reorder's
    gradient scatters back through the permutation
    (test_layers_misc.py::test_lod_rank_table_and_reorder)."""
    res = _both(_rank, {"x": np.arange(12, dtype="float32").reshape(4, 3),
                        "lens": np.array([[2], [5], [5], [1]], "int64")},
                ("x",))["torch"]
    np.testing.assert_array_equal(res[1].ravel(), [1, 2, 0, 3])
    np.testing.assert_array_equal(res[2].ravel(), [5, 5, 2, 1])
    w = np.arange(12, dtype="float32").reshape(4, 3)
    want = np.empty_like(w)
    want[[1, 2, 0, 3]] = w
    np.testing.assert_allclose(res[3], want)


# -- the fuse pass and the fused ops ----------------------------------------


def _seqconv_relu_program(pkg, unique_name, act_layer=True, bias=True):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 23
    with unique_name.guard({}), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[9, 4], dtype="float32")
        ln = pkg.layers.data(name="l", shape=[1], dtype="int64")
        conv = pkg.layers.sequence_conv(
            x, num_filters=6, filter_size=3, act=None, length=ln,
            bias_attr=None if bias else False)
        out = pkg.layers.relu(conv) if act_layer else conv
        final = pkg.layers.reduce_mean(out)
    return main, startup, final


def test_seqconv_eltadd_relu_fuse_matches_jax():
    """The twin of test_graph_pattern.py::test_seqconv_eltadd_relu_fuse:
    the same op list after the pass, and the same output before and
    after it, in both packages."""
    feed = {"x": np.random.RandomState(8).rand(2, 9, 4).astype("float32"),
            "l": np.array([[9], [5]], "int64")}
    res, state = {}, None
    for name, pkg, un, apply_pass in (
            ("jax", jfluid, j_unique_name, j_apply_pass),
            ("torch", tfluid, t_unique_name, t_apply_pass)):
        main, startup, final = _seqconv_relu_program(pkg, un)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            scope = tfluid.Scope()
            persistables_from_numpy(main, scope, state, "cpu")
        (ref,) = exe.run(main, feed=feed, fetch_list=[final], scope=scope)
        apply_pass(main, "seqconv_eltadd_relu_fuse")
        types_ = [op.type for op in main.block(0).ops]
        (got,) = exe.run(main, feed=feed, fetch_list=[final], scope=scope)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6)
        res[name] = (types_, np.asarray(got))
    assert res["torch"][0] == res["jax"][0]
    assert "fusion_seqconv_eltadd_relu" in res["torch"][0]
    assert "sequence_conv" not in res["torch"][0]
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("act_layer,bias", [(False, True), (True, False)])
def test_seqconv_fuse_leaves_unmatched_chains(act_layer, bias):
    """No relu (the sentiment CNN's tanh branches) or no bias: nothing
    fused, and the "inference" pass list runs the program."""
    main, _, _ = _seqconv_relu_program(tfluid, t_unique_name, act_layer,
                                       bias)
    before = [op.type for op in main.block(0).ops]
    out = PassManager(strategy="inference").apply(main)
    assert [op.type for op in out.block(0).ops] == before


def test_fusion_seqexpand_concat_fc_equals_unfused_chain():
    """test_graph_pattern.py::test_fusion_seqexpand_concat_fc_op's twin:
    the fused op against the expand / concat / fc composition."""
    r = np.random.RandomState(15)
    xv, vv = r.rand(2, 5, 3).astype("float32"), r.rand(2, 4).astype(
        "float32")
    wv, bv = r.rand(7, 6).astype("float32"), r.rand(6).astype("float32")
    got = t_registry.get_op_def("fusion_seqexpand_concat_fc").lower(
        None, {"X": [torch.from_numpy(xv), torch.from_numpy(vv)],
               "FCWeight": [torch.from_numpy(wv)],
               "FCBias": [torch.from_numpy(bv)]},
        {"fc_activation": "relu"})["Out"].numpy()
    cat = np.concatenate([xv, np.broadcast_to(vv[:, None, :], (2, 5, 4))],
                         axis=-1)
    np.testing.assert_allclose(got, np.maximum(cat @ wv + bv, 0.0),
                               rtol=1e-5, atol=1e-6)


# -- the sentiment CNN -------------------------------------------------------


SMALL = dict(max_len=24, input_dim=60, emb_dim=16, hid_dim=32)


def test_sentiment_cnn_three_steps_match_jax():
    """3 Adagrad steps of the book's convolution_net at embedding 16, hid
    32, T 24 (lengths 3..24) from the JAX run's initial state: losses and
    predictions within 1e-5, and no grad op reran its forward."""
    r = np.random.RandomState(4)
    feeds = [sentiment.batch(np, r, 6, SMALL["max_len"], 3,
                             SMALL["input_dim"]) for _ in range(3)]
    out, state = {}, None
    for name, pkg, un in (("jax", jfluid, j_unique_name),
                          ("torch", tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with un.guard({}), pkg.program_guard(main, startup):
            loss, acc, pred = sentiment.build(pkg, **SMALL)
            pkg.optimizer.Adagrad(
                learning_rate=sentiment.LEARNING_RATE).minimize(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            scope = tfluid.Scope()
            persistables_from_numpy(main, scope, state, "cpu")
        out[name] = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=[loss, pred], scope=scope)]
            for f in feeds]
        if pkg is tfluid:
            assert exe.grad_op_reruns == 0
            types_ = [op.type for op in main.global_block().ops]
            assert types_.count("sequence_conv") == 2
            assert "sequence_conv_grad" in types_
    for (tl, tp), (jl, jp) in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tp, jp, rtol=TOL, atol=TOL)
    assert np.isfinite([o[0] for o in out["torch"]]).all()
