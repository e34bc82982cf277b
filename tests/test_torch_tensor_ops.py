"""The tensor ops of the port against the JAX package's lowerings, one
case per op type, on the CPU.

Each case is one program built the same way in both packages: through
the layer where the JAX package has one (``layers.split``,
``layers.cast``, ...), else (the ``*2`` ops, which saved programs carry)
with ``append_op``. The two programs hold the same ops: types, input and
output names, attrs. The forward outputs are compared (index outputs
exactly: the port's are int64, the JAX package's int32), and where the
op is differentiable, ``calc_gradient`` of ``sum_i reduce_sum(Out_i *
W_i)`` (W_i seeded weights) with respect to every floating input too;
``split_one_piece`` weights one piece only, so its grad ops include the
``fill_zeros_like`` the maker path inserts. ``hash`` buckets are equal
bit for bit, its uint32 mixing emulated in int64 lanes. Tolerance: rtol
1e-5, atol 1e-6.
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


def case(build, ins, grad=True, weighted=None):
    """``build(pkg, vars) -> out var or list`` on the data vars named as
    ``ins``'s keys; ``weighted``: the indices of the outputs the loss
    weighs (all by default)."""
    return (build, ins, grad, weighted)


def raw(op, out_slots=("Out",), **attrs):
    """A build that appends ``op`` itself, its one input under slot X."""
    def build(pkg, vs):
        blk = pkg.default_main_program().global_block()
        outs = [blk.create_var(name="out_" + s.lower()) for s in out_slots]
        blk.append_op(type=op, inputs={"X": [v.name for v in vs.values()]},
                      outputs={s: [v.name] for s, v in zip(out_slots, outs)},
                      attrs=attrs)
        return outs
    return build


L = lambda fn: (lambda pkg, vs: fn(pkg.layers, *vs.values()))  # noqa: E731

_ties = np.array([[1.0, 3.0, 3.0, -1.0], [2.0, 2.0, 0.5, 2.0],
                  [0.0, -4.0, 5.0, -4.0]], "float32")
_ids = np.array([[5, -7], [2 ** 31 - 1, 0], [-2 ** 31, 123456],
                 [5, -7]], "int64")

CASES = {
    "cast": case(L(lambda l, x: l.cast(x, "int32")),
                 {"x": _r(1, 3, 4) * 3}, grad=False),
    "cast_float16": case(L(lambda l, x: l.cast(x, "float16")),
                         {"x": _r(1, 3, 4)}),
    "reshape2": case(raw("reshape2", ("Out", "XShape"), shape=[0, -1, 2]),
                     {"x": _r(1, 3, 4, 2)}, weighted=[0]),
    "transpose2": case(raw("transpose2", ("Out", "XShape"), axis=[2, 0, 1]),
                       {"x": _r(1, 3, 4, 2)}, weighted=[0]),
    "slice": case(L(lambda l, x: l.slice(x, axes=[0, 2], starts=[1, -3],
                                         ends=[3, 100])),
                  {"x": _r(1, 4, 3, 5)}),
    "split": case(L(lambda l, x: l.split(x, 3, dim=1)), {"x": _r(1, 2, 6, 2)}),
    "split_sections": case(L(lambda l, x: l.split(x, [2, 1, 3], dim=-1)),
                           {"x": _r(1, 3, 6)}),
    "split_one_piece": case(L(lambda l, x: l.split(x, 3, dim=0)),
                            {"x": _r(1, 6, 2)}, weighted=[1]),
    "squeeze": case(L(lambda l, x: l.squeeze(x, axes=[1, -1, 2])),
                    {"x": _r(1, 3, 1, 4, 1)}),
    "squeeze2": case(raw("squeeze2", ("Out", "XShape"), axes=[]),
                     {"x": _r(1, 1, 3, 1)}, weighted=[0]),
    "unsqueeze": case(L(lambda l, x: l.unsqueeze(x, axes=[0, -1, 2])),
                      {"x": _r(1, 3, 4)}),
    "unsqueeze2": case(raw("unsqueeze2", ("Out", "XShape"), axes=[1]),
                       {"x": _r(1, 3, 4)}, weighted=[0]),
    "stack": case(lambda pkg, vs: pkg.layers.stack(list(vs.values()),
                                                   axis=1),
                  {"a": _r(1, 3, 4), "b": _r(2, 3, 4), "c": _r(3, 3, 4)}),
    "unstack": case(L(lambda l, x: l.unstack(x, axis=1)),
                    {"x": _r(1, 2, 3, 4)}),
    "expand": case(L(lambda l, x: l.expand(x, [2, 1, 3])),
                   {"x": _r(1, 2, 3, 2)}),
    "flatten": case(L(lambda l, x: l.flatten(x, axis=2)),
                    {"x": _r(1, 2, 3, 4)}),
    "flatten2": case(raw("flatten2", ("Out", "XShape"), axis=0),
                     {"x": _r(1, 2, 3)}, weighted=[0]),
    "fill": case(lambda pkg, vs: pkg.layers.fill([2, 3], [1, -2.5, 3, 4,
                                                          0.5, 6]),
                 {}, grad=False),
    "fill_int": case(lambda pkg, vs: pkg.layers.fill([3], [1, 7, -2],
                                                     dtype="int64"),
                     {}, grad=False),
    "fill_constant_batch_size_like": case(
        L(lambda l, x: l.fill_constant_batch_size_like(
            x, [1, 5], "float32", 2.5, input_dim_idx=1, output_dim_idx=0)),
        {"x": _r(1, 2, 4)}, grad=False),
    "fill_zeros_like": case(L(lambda l, x: l.zeros_like(x)),
                            {"x": _r(1, 2, 3)}, grad=False),
    "shape": case(L(lambda l, x: l.shape(x)), {"x": _r(1, 2, 3, 5)},
                  grad=False),
    "crop": case(L(lambda l, x: l.crop(x, shape=[2, 3], offsets=[1, 4])),
                 {"x": _r(1, 4, 5)}),
    "scatter": case(L(lambda l, x, i, u: l.scatter(x, i, u)),
                    {"x": _r(1, 5, 3), "ids": np.array([3, 0, -1], "int64"),
                     "upd": _r(2, 3, 3)}),
    "scatter_add": case(L(lambda l, x, i, u: l.scatter(x, i, u,
                                                       overwrite=False)),
                        {"x": _r(1, 5, 3), "ids": np.array([3, 0, 3],
                                                           "int64"),
                         "upd": _r(2, 3, 3)}),
    "pad": case(L(lambda l, x: l.pad(x, [1, 0, 0, 2], pad_value=0.5)),
                {"x": _r(1, 2, 3)}),
    "pad2d": case(L(lambda l, x: l.pad2d(x, [1, 2, 0, 1], pad_value=-1.0)),
                  {"x": _r(1, 2, 3, 4, 5)}),
    "pad2d_reflect": case(L(lambda l, x: l.pad2d(x, [2, 1, 1, 3],
                                                 mode="reflect")),
                          {"x": _r(1, 2, 3, 4, 5)}),
    "pad2d_edge_nhwc": case(L(lambda l, x: l.pad2d(x, [1, 2, 2, 0],
                                                   mode="edge",
                                                   data_format="NHWC")),
                            {"x": _r(1, 2, 4, 5, 3)}),
    "pad_constant_like": case(L(lambda l, x, y: l.pad_constant_like(
        x, y, pad_value=1.5)), {"x": _r(1, 4, 5, 2), "y": _r(2, 2, 3, 2)}),
    "argsort": case(L(lambda l, x: l.argsort(x, axis=1)), {"x": _ties},
                    grad=False),
    "arg_max": case(L(lambda l, x: l.argmax(x, axis=1)), {"x": _ties},
                    grad=False),
    "arg_min": case(L(lambda l, x: l.argmin(x, axis=0)), {"x": _ties},
                    grad=False),
    "reverse": case(L(lambda l, x: l.reverse(x, [0, 2])),
                    {"x": _r(1, 2, 3, 4)}),
    "range": case(lambda pkg, vs: pkg.layers.range(2, 17, 3, "int64"), {},
                  grad=False),
    "range_float": case(lambda pkg, vs: pkg.layers.range(0.5, 3.0, 0.25,
                                                         "float32"),
                        {}, grad=False),
    "batched_gather": case(L(lambda l, x, i: l.batched_gather(x, i)),
                           {"x": _r(1, 2, 5, 3),
                            "idx": np.array([[4, 0, -1], [2, 2, 1]],
                                            "int64")}),
    "hash": case(L(lambda l, x: l.hash(x, hash_size=1000, num_hash=3)),
                 {"x": _ids}, grad=False),
    "hash_large_modulus": case(L(lambda l, x: l.hash(
        x, hash_size=2 ** 31 - 1, num_hash=2)), {"x": _ids[:, :1]},
        grad=False),
}


def _build(pkg, unique_name, c, weights):
    """The case's program; with ``weights`` also the loss and its
    gradients. Returns (program, feed, fetch names)."""
    build, ins, _, weighted = c
    main, startup = pkg.Program(), pkg.Program()
    feed, vs = {}, {}
    with unique_name.guard({}), pkg.program_guard(main, startup):
        blk = main.global_block()
        for name, a in ins.items():
            vs[name] = blk.create_var(name=name, shape=a.shape,
                                      dtype=str(a.dtype), is_data=True,
                                      stop_gradient=a.dtype.kind != "f")
            feed[name] = a
        outs = build(pkg, vs)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        fetch = [o.name for o in outs]
        if weights is not None:
            picked = [outs[i] for i in (weighted or range(len(outs)))]
            terms = []
            for i, (o, w) in enumerate(zip(picked, weights)):
                wv = blk.create_var(name="w_%d" % i, shape=w.shape,
                                    dtype="float32", is_data=True)
                feed[wv.name] = w
                terms.append(pkg.layers.reduce_sum(
                    pkg.layers.elementwise_mul(o, wv)))
            loss = terms[0] if len(terms) == 1 else pkg.layers.sums(terms)
            floats = [v for v in vs.values() if not v.stop_gradient]
            grads = pkg.backward.calc_gradient(loss, floats)
            # None where the op has no gradient for the input
            fetch = [g.name for g in grads if g is not None]
    return main, feed, fetch


def _ops(program):
    return [(op.type, op.inputs, op.outputs,
             {k: v for k, v in op.attrs.items()})
            for op in program.global_block().ops]


def run_case(c, weights=None):
    """Both packages' (ops, fetched values)."""
    res = []
    for pkg, un in ((jfluid, j_unique_name), (tfluid, t_unique_name)):
        main, feed, fetch = _build(pkg, un, c, weights)
        exe = pkg.Executor(pkg.CPUPlace())
        vals = [np.asarray(v) for v in exe.run(main, feed=feed,
                                               fetch_list=fetch)]
        res.append((_ops(main), vals))
    return res


def check_case(c):
    """Forward, then (where the case has a gradient) the gradient: equal
    programs, equal values."""
    (j_ops, want), (t_ops, got) = run_case(c)
    assert t_ops == j_ops
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            assert g.dtype.kind == w.dtype.kind
            np.testing.assert_array_equal(g, w)
    if not c[2]:
        return
    picked = [want[i] for i in (c[3] or range(len(want)))]
    weights = [np.random.RandomState(9 + i).uniform(
        0.5, 1.5, w.shape).astype("float32") for i, w in enumerate(picked)]
    (j_ops, want), (t_ops, got) = run_case(c, weights)
    assert t_ops == j_ops
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_forward_and_gradient(name):
    check_case(CASES[name])


def test_split_gradient_is_a_concat_of_zero_filled_pieces():
    """split's grad op is the JAX package's maker: a fill_zeros_like for
    each piece no loss reaches, then one concat."""
    _, (t_ops, _) = run_case(CASES["split_one_piece"],
                             [np.ones((2, 2), "float32")])
    types = [t for t, _, _, _ in t_ops]
    assert types.count("fill_zeros_like") == 2
    assert types[-1] == "concat" and "split_grad" not in types


def test_every_reference_tensor_op_is_registered():
    """The JAX package's tensor_ops.py table, whole."""
    from paddle_tpu.core import op_registry as j_registry
    from paddle_tpu_torch.core import op_registry as t_registry

    import paddle_tpu.ops.tensor_ops as j_tensor

    want = {t for t in j_registry.registered_ops()
            if not t.endswith("_grad")
            and j_registry.get_op_def(t).lower.__module__
            == j_tensor.__name__}
    assert len(want) >= 40
    for t in sorted(want):
        assert t_registry.has_op(t), t
        jd, td = j_registry.get_op_def(t), t_registry.get_op_def(t)
        assert (td.inputs, td.outputs, td.attrs) == \
            (jd.inputs, jd.outputs, jd.attrs), t
        assert (td.grad is None) == (jd.grad is None), t
        assert td.intermediate_outputs == jd.intermediate_outputs, t
        assert td.no_grad_inputs == jd.no_grad_inputs, t
