"""The activation and math ops of the port against the JAX package's
lowerings, forward and gradient, on the CPU.

Each case is one op program built the same way in both packages: the
forward outputs are compared, and ``calc_gradient`` of
``reduce_sum(Out * W)`` (W a seeded weight of Out's shape) with respect
to every floating input is compared too, unless the op has no gradient.
Inputs hold the values where a formula has a kink or a tie (0 for
``abs`` / ``relu`` / ``leaky_relu``, a clip's bounds, equal maxout
candidates), so the gradient the JAX package picks there is held too.
``matmul`` runs ``tests/test_ops_numeric.py``'s transposed batch case
plus transposes of either side, batch broadcasting, a vector operand and
``alpha``. Tolerance: rtol 1e-5, atol 1e-6 (float32 sums in another
order).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _r(seed, *shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        "float32")


# x with the kinks in it: 0, +-1, and the bounds the cases below use
KINKS = np.array([[-6.0, -2.5, -1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 2.5, 4.0,
                   6.0, 7.0]], "float32")


def _x(seed=0, shape=(3, 12)):
    x = _r(seed, *shape, lo=-3.0, hi=3.0)
    x[0] = KINKS[0, :shape[1]]
    return x


def _pos(seed=0, *shape):
    return _r(seed, *(shape or (3, 5)), lo=0.2, hi=3.0)


def case(op, ins, attrs=None, grad=True, outs=("Out",)):
    return (op, ins, dict(attrs or {}), grad, outs)


UNARY = ["sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink",
         "abs", "cos", "sin", "square", "softplus", "softsign", "gelu",
         "softmax", "rsqrt"]

CASES = {}
for _op in UNARY:
    CASES[_op] = case(_op, {"X": _pos() if _op == "rsqrt" else _x()})
for _op in ("ceil", "floor", "round", "sign"):
    CASES[_op] = case(_op, {"X": _x()}, grad=False)
CASES.update({
    "sqrt": case("sqrt", {"X": _pos()}),
    "log": case("log", {"X": _pos()}),
    "reciprocal": case("reciprocal", {"X": _pos()}),
    "relu6": case("relu6", {"X": _x()}, {"threshold": 6.0}),
    "leaky_relu": case("leaky_relu", {"X": _x()}, {"alpha": 0.1}),
    "elu": case("elu", {"X": _x()}, {"alpha": 1.5}),
    "pow": case("pow", {"X": _pos()}, {"factor": 2.5}),
    "stanh": case("stanh", {"X": _x()}, {"scale_a": 0.5, "scale_b": 1.5}),
    "hard_sigmoid": case("hard_sigmoid", {"X": _x()},
                         {"slope": 0.5, "offset": 0.5}),
    "thresholded_relu": case("thresholded_relu", {"X": _x()},
                             {"threshold": 0.5}),
    "soft_relu": case("soft_relu", {"X": _x()}, {"threshold": 2.5}),
    "brelu": case("brelu", {"X": _x()}, {"t_min": -1.0, "t_max": 4.0}),
    "swish": case("swish", {"X": _x()}, {"beta": 1.5}),
    "prelu_all": case("prelu", {"X": _x(), "Alpha": np.array([0.2],
                                                             "float32")},
                      {"mode": "all"}),
    "prelu_channel": case("prelu", {"X": _r(1, 2, 3, 4),
                                    "Alpha": _r(2, 3)}, {"mode": "channel"}),
    "prelu_element": case("prelu", {"X": _r(1, 2, 3, 4),
                                    "Alpha": _r(2, 3, 4)},
                          {"mode": "element"}),
    "log_softmax": case("log_softmax", {"X": _x()}, {"axis": 0}),
    "softshrink": case("softshrink", {"X": _x()}, {"lambda": 0.5}),
    "hard_shrink": case("hard_shrink", {"X": _x()}, {"threshold": 0.5}),
    "maxout": case("maxout", {"X": np.repeat(_r(3, 2, 3, 2, 2), 2, axis=1)},
                   {"groups": 2}),
    # math_ops.py
    "mul": case("mul", {"X": _r(1, 2, 3, 4), "Y": _r(2, 12, 5)},
                {"x_num_col_dims": 1}),
    "mul_cols2": case("mul", {"X": _r(1, 2, 3, 4), "Y": _r(2, 4, 5)},
                      {"x_num_col_dims": 2}),
    "matmul_transpose_x": case("matmul", {"X": _r(1, 2, 5, 4),
                                          "Y": _r(2, 2, 5, 3)},
                               {"transpose_X": True}),
    "matmul_transpose_y": case("matmul", {"X": _r(1, 2, 4, 5),
                                          "Y": _r(2, 2, 3, 5)},
                               {"transpose_Y": True, "alpha": 0.5}),
    "matmul_both": case("matmul", {"X": _r(1, 5, 4), "Y": _r(2, 3, 5)},
                        {"transpose_X": True, "transpose_Y": True}),
    "matmul_broadcast": case("matmul", {"X": _r(1, 2, 3, 4, 5),
                                        "Y": _r(2, 5, 6)}, {"alpha": 2.0}),
    "matmul_vector": case("matmul", {"X": _r(1, 3, 4), "Y": _r(2, 4)}),
    "sum": case("sum", {"X": [_r(1, 3, 4), _r(2, 3, 4), _r(3, 3, 4)]}),
    "scale": case("scale", {"X": _x()}, {"scale": 0.5, "bias": 1.0,
                                         "bias_after_scale": False}),
    "mean": case("mean", {"X": _x()}),
    "clip": case("clip", {"X": _x()}, {"min": -1.0, "max": 2.5}),
    "clip_by_norm_clips": case("clip_by_norm", {"X": _x()},
                               {"max_norm": 1.0}),
    "clip_by_norm_passes": case("clip_by_norm", {"X": _x()},
                                {"max_norm": 100.0}),
    "cumsum": case("cumsum", {"X": _x()}, {"axis": 1}),
    "cumsum_exclusive_reverse": case("cumsum", {"X": _x()},
                                     {"axis": 0, "exclusive": True,
                                      "reverse": True}),
    "l2_normalize": case("l2_normalize", {"X": _x()}, {"axis": 1},
                         outs=("Out", "Norm")),
    "norm": case("norm", {"X": _r(1, 2, 3, 4)}, {"axis": 1},
                 outs=("Out", "Norm")),
    "isfinite": case("isfinite", {"X": [_x(), _x(1)]}, grad=False),
    "isinf": case("isinf", {"X": _x()}, grad=False),
    "isnan": case("isnan", {"X": _x()}, grad=False),
    "cos_sim": case("cos_sim", {"X": _r(1, 4, 6), "Y": _r(2, 4, 6)},
                    outs=("Out", "XNorm", "YNorm")),
    "cos_sim_one_row": case("cos_sim", {"X": _r(1, 4, 6), "Y": _r(2, 1, 6)},
                            outs=("Out", "XNorm", "YNorm")),
    "minus": case("minus", {"X": _r(1, 3, 4), "Y": _r(2, 3, 4)}),
    "l1_norm": case("l1_norm", {"X": _x()}),
    "multiplex": case("multiplex", {"Ids": np.array([[1], [0], [2]],
                                                    "int32"),
                                    "X": [_r(1, 3, 4), _r(2, 3, 4),
                                          _r(3, 3, 4)]}),
    "bilinear_tensor_product": case(
        "bilinear_tensor_product", {"X": _r(1, 3, 4), "Y": _r(2, 3, 5),
                                    "Weight": _r(3, 2, 4, 5),
                                    "Bias": _r(4, 1, 2)}),
    "conv_shift": case("conv_shift", {"X": _r(1, 3, 7), "Y": _r(2, 3, 3)}),
})
for _op in ("elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_div", "elementwise_max", "elementwise_min"):
    CASES[_op] = case(_op, {"X": _r(1, 2, 3, 4), "Y": _r(2, 3)},
                      {"axis": 1})
    CASES[_op + "_same"] = case(_op, {"X": _r(1, 3, 4), "Y": _r(2, 3, 4)})
# a tie in every entry for max; positive bases for pow
_tie = _r(3, 3, 4)
CASES["elementwise_max_ties"] = case("elementwise_max",
                                     {"X": _tie, "Y": _tie.copy()})
CASES["elementwise_pow"] = case("elementwise_pow", {"X": _pos(1, 3, 4),
                                                    "Y": _r(2, 3, 4)})
CASES["elementwise_mod"] = case("elementwise_mod", {"X": _r(1, 3, 4) * 3,
                                                    "Y": _pos(2, 3, 4)})
CASES["elementwise_floordiv"] = case("elementwise_floordiv",
                                     {"X": _r(1, 3, 4) * 3,
                                      "Y": _pos(2, 3, 4)})
for _op in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
            "reduce_prod"):
    CASES[_op] = case(_op, {"X": _r(1, 2, 3, 4, lo=0.5, hi=1.5)},
                      {"dim": [1, 2], "keep_dim": False})
    CASES[_op + "_keep"] = case(_op, {"X": _r(2, 2, 3, 4, lo=0.5, hi=1.5)},
                                {"dim": [-1], "keep_dim": True})
    CASES[_op + "_all"] = case(_op, {"X": _r(3, 2, 3, lo=0.5, hi=1.5)},
                               {"reduce_all": True})
# reduce_max / reduce_min share the gradient among equal entries
CASES["reduce_max_ties"] = case("reduce_max", {"X": np.array(
    [[1.0, 3.0, 3.0], [2.0, 2.0, 2.0]], "float32")}, {"dim": [1]})


def _build(pkg, unique_name, op, ins, attrs, outs, weights=None):
    """The op, and with ``weights`` the loss sum(Out * W) and its
    gradients. Returns (program, feed, fetch names)."""
    main, startup = pkg.Program(), pkg.Program()
    feed, in_vars, names = {}, [], {}
    with unique_name.guard({}), pkg.program_guard(main, startup):
        blk = main.global_block()
        for slot, arr in ins.items():
            arrs = arr if isinstance(arr, list) else [arr]
            names[slot] = []
            for i, a in enumerate(arrs):
                name = "%s_%d" % (slot.lower(), i)
                v = blk.create_var(name=name, shape=a.shape,
                                   dtype=str(a.dtype), is_data=True,
                                   stop_gradient=a.dtype.kind != "f")
                feed[name] = a
                names[slot].append(name)
                if a.dtype.kind == "f":
                    in_vars.append(v)
        out_names = {s: "out_" + s.lower() for s in outs}
        for n in out_names.values():
            blk.create_var(name=n)
        blk.append_op(type=op, inputs=names,
                      outputs={s: [n] for s, n in out_names.items()},
                      attrs=attrs)
        fetch = [out_names[s] for s in outs]
        if weights is not None:
            w = blk.create_var(name="w", shape=weights.shape,
                               dtype="float32", is_data=True)
            feed["w"] = weights
            loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(
                blk.var(out_names[outs[0]]), w))
            grads = pkg.backward.calc_gradient(loss, in_vars)
            fetch = [g.name for g in grads if g is not None]
            assert len(fetch) == len(in_vars)
    return main, feed, fetch


def _run(pkg, unique_name, c, weights=None):
    op, ins, attrs, _, outs = c
    main, feed, fetch = _build(pkg, unique_name, op, ins, attrs, outs,
                               weights)
    exe = pkg.Executor(pkg.CPUPlace())
    return [np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=fetch)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_forward_and_gradient(name):
    c = CASES[name]
    want = _run(jfluid, j_unique_name, c)
    got = _run(tfluid, t_unique_name, c)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, w)
    if not c[3]:
        return
    weights = np.random.RandomState(9).uniform(
        0.5, 1.5, want[0].shape).astype("float32")
    want = _run(jfluid, j_unique_name, c, weights)
    got = _run(tfluid, t_unique_name, c, weights)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_every_reference_activation_and_math_op_is_registered():
    """The two reference files' op tables, whole."""
    from paddle_tpu.core import op_registry as j_registry
    from paddle_tpu_torch.core import op_registry as t_registry

    import paddle_tpu.ops.activation_ops as j_act
    import paddle_tpu.ops.math_ops as j_math

    mods = {j_act.__name__, j_math.__name__}
    want = {t for t in j_registry.registered_ops()
            if not t.endswith("_grad")
            and j_registry.get_op_def(t).lower.__module__ in mods}
    assert len(want) >= 60
    for t in sorted(want):
        jd, td = j_registry.get_op_def(t), t_registry.get_op_def(t)
        assert td.inputs == jd.inputs and td.outputs == jd.outputs, t
        assert td.attrs == jd.attrs, t
        assert (td.grad is None) == (jd.grad is None), t


def test_generated_layers_take_their_attrs():
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        tfluid.layers.leaky_relu(x, alpha=0.3)
        tfluid.layers.clip(x, min=-1.0, max=1.0)
        tfluid.layers.matmul(x, x, transpose_y=True, alpha=0.5)
        tfluid.layers.sums([x, x])
        tfluid.layers.reduce_prod(x, dim=1)
    ops = main.global_block().ops
    assert [o.type for o in ops] == ["leaky_relu", "clip", "matmul", "sum",
                                     "reduce_prod"]
    assert ops[0].attrs["alpha"] == 0.3
    assert (ops[1].attrs["min"], ops[1].attrs["max"]) == (-1.0, 1.0)
    assert ops[2].attrs["transpose_Y"] and ops[2].attrs["alpha"] == 0.5


def _sdpa(pkg, unique_name, qkv, heads):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        q, k, v = [pkg.layers.data(n, shape=list(a.shape[1:]),
                                   stop_gradient=False)
                   for n, a in zip("qkv", qkv)]
        out = pkg.nets.scaled_dot_product_attention(q, k, v, num_heads=heads)
        grads = pkg.backward.calc_gradient(pkg.layers.reduce_sum(
            pkg.layers.elementwise_mul(out, out)), [q, k, v])
    exe = pkg.Executor(pkg.CPUPlace())
    return [np.asarray(a) for a in exe.run(
        main, feed=dict(zip("qkv", qkv)), fetch_list=[out] + grads)]


@pytest.mark.parametrize("heads", [1, 2])
def test_scaled_dot_product_attention_matches_jax(heads):
    """nets.scaled_dot_product_attention: matmul, scale, softmax and the
    head split, forward and the gradients of q, k and v."""
    qkv = [_r(s, 2, 5, 8) for s in (1, 2, 3)]
    want = _sdpa(jfluid, j_unique_name, qkv, heads)
    got = _sdpa(tfluid, t_unique_name, qkv, heads)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
