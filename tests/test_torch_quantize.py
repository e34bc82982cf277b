"""Quantization-aware training in the PyTorch port against the JAX
package, on the CPU: the fake quantize / dequantize ops, ``dequantize_weight``
and ``QuantizeTranspiler``.

The op cases are the twins of ``tests/test_vision_quant_ops.py``'s
quantize rows: every output equals the JAX lowering's bit for bit (both
compute ``y + (round(q) - y)`` in the same order), and the
straight-through gradient is ``range / scale``, clipped elements
included, within 1e-5 of ``jax.vjp``'s. The transpiler cases are the twins of five of the six cases of
``tests/test_quantize_transpiler.py`` (``test_preprocessor_in_graph``
waits for ``io.py``'s ``Preprocessor``): the same convnet built in both
packages from one initial state (``convert.py``) gives the same op and
var lists after ``training_transpile`` and ``minimize``; the first
step's quantized input and weights are bit-equal; the losses over the
JAX test's steps agree within 1e-5; ``freeze_program`` and
``convert_to_int8`` of one state give equal snapped weights, scales and
int8 tensors; the int8 model saved by the port stores int8 files and is
served by ``load_inference_model`` and by the C++ interpreter
(``native.py``) within the JAX test's tolerances of the frozen program.
"""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.transpiler import QuantizeTranspiler as JQuantizeTranspiler
from paddle_tpu_torch import native
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.core import op_registry as t_registry
from paddle_tpu_torch.inference import NativeConfig, create_paddle_predictor
from paddle_tpu_torch.io import prune_program
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.transpiler import QuantizeTranspiler
from test_torch_sequence import op_twin

LOSS_TOL = 1e-5
rng = np.random.RandomState(71)


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


# -- the ops ----------------------------------------------------------------

X = rng.randn(4, 7).astype("float32")
OPS = [
    # tests/test_vision_quant_ops.py:495-557
    ("fake_quantize_abs_max", {"X": np.asarray([[0.5, -1.0], [0.25, 0.75]],
                                               "float32")}, {}),
    ("fake_quantize_abs_max", {"X": X}, {}),
    ("fake_quantize_abs_max", {"X": X}, {"bit_length": 4}),
    ("fake_quantize_abs_max", {"X": np.zeros((2, 3), "float32")}, {}),
    ("fake_quantize_range_abs_max", {"X": np.asarray([[2.0, -4.0]],
                                                     "float32"),
                                     "InScale": np.asarray([3.0], "float32")},
     {"is_test": False}),
    ("fake_quantize_range_abs_max", {"X": np.asarray([[2.0, -4.0]],
                                                     "float32"),
                                     "InScale": np.asarray([3.0], "float32")},
     {"is_test": True}),
    # :587, clipped elements keep the straight-through gradient
    ("fake_quantize_range_abs_max", {"X": np.asarray([[0.5, 9.0]],
                                                     "float32"),
                                     "InScale": np.asarray([1.0], "float32")},
     {"is_test": True}),
    ("fake_quantize_range_abs_max", {"X": X, "InScale": np.asarray(
        [0.5], "float32")}, {}),
    ("fake_dequantize_max_abs", {"X": np.asarray([[127.0, -64.0]], "float32"),
                                 "Scale": np.asarray([2.0], "float32")},
     {"max_range": 127.0}),
    ("fake_dequantize_max_abs", {"X": np.round(X * 40), "Scale": np.asarray(
        [1.7], "float32")}, {"max_range": 7.0}),
    ("dequantize_weight", {"X": rng.randint(-128, 128, (3, 5)).astype(
        "int8"), "Scale": np.asarray([0.013], "float32")}, {}),
]


@pytest.mark.parametrize("op_type,ins,attrs", OPS,
                         ids=["%s%d" % (o[0], i) for i, o in enumerate(OPS)])
def test_op_matches_jax(op_type, ins, attrs):
    got = op_twin(op_type, ins, attrs, tol=0.0, grad_tol=1e-5)
    if op_type.startswith("fake_quantize"):
        q = got["Out"].detach().numpy()
        np.testing.assert_array_equal(q, np.round(q))  # integers


@pytest.mark.parametrize("op_type,x,scale,want", [
    ("fake_quantize_abs_max", [[0.5, -0.25], [0.125, -1.0]], None, 127.0),
    ("fake_quantize_range_abs_max", [[0.5, 9.0]], 1.0, 127.0)])
def test_straight_through_gradient(op_type, x, scale, want):
    """d(out)/d(x) = range / scale everywhere, never zero despite the
    round (test_vision_quant_ops.py:542 and :587)."""
    xt = torch.tensor(x, requires_grad=True)
    ins = {"X": [xt]}
    if scale is not None:
        ins["InScale"] = [torch.tensor([scale])]
    out = t_registry.get_op_def(op_type).lower(
        type("Ctx", (), {"is_test": True})(), ins, {})["Out"]
    (g,) = torch.autograd.grad(out.sum(), [xt])
    np.testing.assert_allclose(g.numpy(), np.full_like(g.numpy(), want),
                               rtol=1e-5)


def test_quantize_layer_and_its_gradient():
    """fake_quantize_abs_max through layers and calc_gradient in both
    packages."""
    x = np.asarray([[0.5, -0.25], [0.125, -1.0]], "float32")
    res = {}
    for pkg, un in ((jfluid, j_unique_name), (tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard({}), pkg.program_guard(main, startup):
            xv = pkg.layers.data("x", [2], stop_gradient=False)
            out, scale = pkg.layers.fake_quantize_abs_max(xv)
            grads = pkg.backward.calc_gradient(pkg.layers.reduce_sum(out),
                                               [xv])
        res[pkg] = [np.asarray(v) for v in pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": x}, fetch_list=[out, scale] + grads)]
    for g, w in zip(res[tfluid], res[jfluid]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(res[tfluid][2], np.full_like(x, 127.0),
                               rtol=1e-5)


# -- the transpiler ----------------------------------------------------------


def _build_convnet(pkg):
    L = pkg.layers
    img = L.data("img", [1, 8, 8])
    label = L.data("label", [1], dtype="int64")
    c = L.conv2d(img, num_filters=4, filter_size=3, padding=1, act="relu")
    logits = L.fc(L.flatten(c), size=3)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    return img, label, logits, loss


def _batch(r, bs=8):
    y = r.randint(0, 3, (bs, 1)).astype("int64")
    x = np.zeros((bs, 1, 8, 8), "float32")
    for i, lab in enumerate(y[:, 0]):
        x[i, 0, int(lab) * 2:(int(lab) + 1) * 2, :] = 1.0
    x += 0.1 * r.rand(bs, 1, 8, 8)
    return x.astype("float32"), y


def _state_of(main, scope):
    return {v.name: np.asarray(scope.get_value(v.name))
            for v in main.global_block().vars.values()
            if v.persistable and scope.get_value(v.name) is not None}


def _qat_programs(seed, act_type="abs_max", minimize=True):
    """The convnet built and transpiled in both packages (the test clone
    taken before minimize), the port's state carried over from the JAX
    startup run: {package: (main, test, logits, loss, qt, exe, scope)}."""
    out, state = {}, None
    for name, pkg, un, qt_cls in (
            ("jax", jfluid, j_unique_name, JQuantizeTranspiler),
            ("torch", tfluid, t_unique_name, QuantizeTranspiler)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with un.guard({}), pkg.program_guard(main, startup):
            img, label, logits, loss = _build_convnet(pkg)
            qt = qt_cls(activation_quantize_type=act_type)
            qt.training_transpile(main, startup)
            test = main.clone(for_test=True)
            if minimize:
                pkg.optimizer.Adam(learning_rate=5e-3).minimize(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            state = _state_of(main, scope)
        else:
            scope = tfluid.Scope()
            persistables_from_numpy(main, scope, state, "cpu")
        out[name] = (main, test, logits, loss, qt, exe, scope)
    return out


def _ops(program):
    return [(op.type, sorted((k, tuple(v)) for k, v in op.inputs.items()),
             sorted((k, tuple(v)) for k, v in op.outputs.items()))
            for op in program.global_block().ops]


@pytest.mark.parametrize("act_type", ["abs_max", "range_abs_max"])
def test_training_transpile_inserts_pairs_and_converges(act_type):
    """test_training_transpile_inserts_pairs_and_converges's twin: the same
    op lists, vars and wiring; the first step's quantized image and
    weights bit-equal; 60 Adam steps' losses within 1e-5, falling as the
    JAX test asks."""
    progs = _qat_programs(3, act_type)
    jm, tm = progs["jax"][0], progs["torch"][0]
    assert _ops(tm) == _ops(jm)
    assert sorted(tm.global_block().vars) == sorted(jm.global_block().vars)
    types = [op.type for op in tm.global_block().ops]
    quant = ("fake_quantize_abs_max" if act_type == "abs_max"
             else "fake_quantize_range_abs_max")
    assert types.count("fake_dequantize_max_abs") == 4
    assert types.count(quant) >= 2
    conv = next(op for op in tm.global_block().ops if op.type == "conv2d")
    assert all(n.endswith(".dequantized")
               for n in conv.inputs["Input"] + conv.inputs["Filter"])
    q_names = ["img.quantized"] + [
        n + ".quantized" for n in conv.inputs["Filter"]
        for n in [n[:-len(".dequantized")]]]
    r = np.random.RandomState(0)
    feeds = [_batch(r) for _ in range(60)]
    losses = {}
    for name, (main, _, _, loss, _, exe, scope) in progs.items():
        losses[name] = []
        for i, (x, y) in enumerate(feeds):
            vals = exe.run(main, feed={"img": x, "label": y},
                           fetch_list=[loss] + (q_names if i == 0 else []),
                           scope=scope)
            losses[name].append(float(np.asarray(vals[0]).ravel()[0]))
            if i == 0:
                losses[name + "_q"] = [np.asarray(v) for v in vals[1:]]
        if name == "torch":
            assert exe.grad_op_reruns == 0
    for a, b in zip(losses["torch_q"], losses["jax_q"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    assert losses["torch"][-1] < losses["torch"][0] * 0.3


def test_range_abs_max_scale_state_grows():
    """The running scale grows to the batch abs-max and never shrinks; at
    test time it is read unchanged (test_range_abs_max_scale_state_grows's
    twin)."""
    states = {}
    for name, pkg, un, qt_cls in (
            ("jax", jfluid, j_unique_name, JQuantizeTranspiler),
            ("torch", tfluid, t_unique_name, QuantizeTranspiler)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard({}), pkg.program_guard(main, startup):
            x = pkg.layers.data("x", [4])
            y = pkg.layers.fc(x, size=2)
            qt_cls(activation_quantize_type="range_abs_max") \
                .training_transpile(main, startup)
        scope = JScope() if pkg is jfluid else tfluid.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        names = sorted(n for n in main.global_block().vars
                       if n.endswith(".scale.state"))
        assert names
        seen = []
        for v in (3.0, 1.0):
            exe.run(main, feed={"x": np.full((2, 4), v, "float32")},
                    fetch_list=[y], scope=scope)
            seen.append(float(np.asarray(scope.get_value(names[0]))
                              .ravel()[0]))
        test = main.clone(for_test=True)
        exe.run(test, feed={"x": np.full((2, 4), 5.0, "float32")},
                fetch_list=[y], scope=scope)
        seen.append(float(np.asarray(scope.get_value(names[0])).ravel()[0]))
        states[name] = (names, seen)
    assert states["torch"] == states["jax"]
    assert abs(states["torch"][1][0] - 3.0) < 1e-5
    assert abs(states["torch"][1][1] - 3.0) < 1e-5
    assert abs(states["torch"][1][2] - 3.0) < 1e-5


def _train(progs, r, steps):
    for main, _, _, loss, _, exe, scope in progs.values():
        rr = np.random.RandomState(r)
        for _ in range(steps):
            x, y = _batch(rr)
            exe.run(main, feed={"img": x, "label": y}, fetch_list=[loss],
                    scope=scope)


def test_freeze_program_strips_fakes_and_snaps_weights():
    """test_freeze_program_strips_fakes_and_snaps_weights's twin: 20
    steps in each package; from the JAX package's trained state both
    freeze to the same op list, scales and snapped weights (equal), and
    the frozen program reproduces the QAT logits within the JAX test's
    0.15."""
    progs = _qat_programs(5)
    _train(progs, 1, 20)
    jstate = _state_of(progs["jax"][0], progs["jax"][6])
    tscope = progs["torch"][6]
    persistables_from_numpy(progs["torch"][0], tscope, jstate, "cpu")
    x, y = _batch(np.random.RandomState(9), bs=4)
    res = {}
    for name, (main, test, logits, _, qt, exe, scope) in progs.items():
        (qat,) = exe.run(test, feed={"img": x, "label": y},
                         fetch_list=[logits], scope=scope)
        scales = qt.freeze_program(test, scope=scope)
        (frozen,) = exe.run(test, feed={"img": x, "label": y},
                            fetch_list=[logits], scope=scope)
        snapped = {n: np.asarray(scope.get_value(n)) for n in scales}
        res[name] = (np.asarray(qat), scales, [op.type for op in
                                               test.global_block().ops],
                     snapped, np.asarray(frozen))
    t, j = res["torch"], res["jax"]
    assert t[1] and t[1] == j[1]
    assert t[2] == j[2] and not any(s.startswith("fake_") for s in t[2])
    for n in j[3]:
        np.testing.assert_array_equal(t[3][n], j[3][n])
    np.testing.assert_allclose(t[0], j[0], rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(t[4], j[4], rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(t[4], t[0], rtol=0.15, atol=0.15)


def test_freeze_rejects_training_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        _, _, _, loss = _build_convnet(tfluid)
        qt = QuantizeTranspiler()
        qt.training_transpile(main, startup)
        tfluid.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    with pytest.raises(ValueError, match="backward/optimizer"):
        qt.freeze_program(main)


def test_transpiler_refuses_unknown_types():
    for kw in ({"activation_quantize_type": "moving"},
               {"weight_quantize_type": "range_abs_max"}):
        with pytest.raises(ValueError):
            QuantizeTranspiler(**kw)


def test_convert_to_int8_roundtrip(tmp_path):
    """test_convert_to_int8_roundtrip's twin: 15 steps, prune, freeze,
    convert. From one trained state both packages give the same int8
    tensors, steps and op list; the port's int8 outputs reproduce its
    frozen ones within 1e-5; the saved directory holds the int8 files
    and no float weight; load_inference_model and the C++ interpreter
    serve it within the JAX test's tolerances."""
    progs = _qat_programs(7)
    _train(progs, 2, 15)
    jstate = _state_of(progs["jax"][0], progs["jax"][6])
    persistables_from_numpy(progs["torch"][0], progs["torch"][6], jstate,
                            "cpu")
    x, _ = _batch(np.random.RandomState(3), bs=4)
    res = {}
    for name, (main, test, logits, _, qt, exe, scope) in progs.items():
        pkg = jfluid if name == "jax" else tfluid
        test = pkg.io.prune_program(test, ["img"], [logits.name])
        scales = qt.freeze_program(test, scope=scope)
        (frozen,) = exe.run(test, feed={"img": x}, fetch_list=[logits],
                            scope=scope)
        converted = qt.convert_to_int8(test, scope=scope, scales=scales)
        gb = test.global_block()
        assert gb.ops[0].type == "dequantize_weight"
        assert sorted(converted) == sorted(scales)
        tensors = {}
        for n in converted:
            assert str(gb.vars[n + ".int8"].dtype) == "int8"
            assert not gb.vars[n].persistable
            tensors[n] = (np.asarray(scope.get_value(n + ".int8")),
                          np.asarray(scope.get_value(n + ".int8_scale")))
        (int8_out,) = exe.run(test, feed={"img": x}, fetch_list=[logits],
                              scope=scope)
        res[name] = (test, logits, exe, scope, np.asarray(frozen),
                     np.asarray(int8_out), tensors,
                     [op.type for op in gb.ops])
    t, j = res["torch"], res["jax"]
    assert t[7] == j[7]
    assert sorted(t[6]) == sorted(j[6])
    for n in j[6]:
        assert t[6][n][0].dtype == np.int8
        np.testing.assert_array_equal(t[6][n][0], j[6][n][0])
        np.testing.assert_array_equal(t[6][n][1], j[6][n][1])
    np.testing.assert_allclose(t[5], t[4], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t[5], j[5], rtol=LOSS_TOL, atol=LOSS_TOL)

    test, logits, exe, scope, frozen = t[:5]
    path = str(tmp_path / "int8_model")
    tfluid.io.save_inference_model(path, ["img"], [logits], exe,
                                   main_program=test, scope=scope)
    saved = {fn: np.load(os.path.join(path, fn))
             for fn in os.listdir(path) if fn.endswith(".npy")}
    assert len([a for a in saved.values() if a.dtype == np.int8]) \
        == len(t[6])
    for n in t[6]:
        assert not any(fn.startswith(n + ".npy") for fn in saved)
    prog2, _, fetches2 = tfluid.io.load_inference_model(
        path, tfluid.Executor(tfluid.CPUPlace()), scope=tfluid.Scope())
    pred = create_paddle_predictor(NativeConfig(model_dir=path,
                                                use_tpu=False))
    (loaded,) = pred.run({"img": x})
    np.testing.assert_allclose(np.asarray(loaded), frozen, rtol=1e-5,
                               atol=1e-6)
    assert [op.type for op in prog2.global_block().ops][0] \
        == "dequantize_weight"
    if native.available():
        got = pred.run_native_reference({"img": x})
        np.testing.assert_allclose(np.asarray(got), frozen, rtol=1e-4,
                                   atol=1e-5)
