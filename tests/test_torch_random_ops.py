"""The port's random ops against the JAX package's, draw for draw.

Both packages draw from jax's threefry stream (the port through
``paddle_tpu_torch/core/prng.py``), keyed by the executor's run counter
and each op's ``__rng_id__``. Held here, from fresh executors with the
same ``random_seed``:

- each random op through a one-op program: bit-equal outputs, and the
  normal family (``gaussian_random``, ``truncated_gaussian_random``,
  ``gaussian_random_batch_size_like``) within ``NORMAL_TOL`` (its
  ``erf_inv`` takes ``log1p`` and ``sqrt``, whose float32 results differ
  by an ulp between XLA and torch; measured at most 4.8e-7 in
  ``test_torch_prng.py``);
- the run counter, held across ``run``, ``run_async`` and
  ``run_multi_step`` (each call one step of it; a multi-step loop folds
  the step index in);
- a startup program initialized by every initializer gives the JAX
  package's parameters;
- the twins of ``test_op_breadth_misc.py``'s random-op statistics and
  ``test_layers_misc.py``'s ``random_crop`` cases, now also equal to the
  JAX package's draws;
- ``random_data_generator`` equals the JAX op's batch, and
  ``assign_value`` (``layers.assign`` of a numpy array) works.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state

NORMAL_TOL = 2e-6
SEED = 1234


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _pkg(which):
    if which == "jax":
        return jfluid, j_unique_name, JScope
    return tfluid, t_unique_name, tfluid.Scope


def _one_op(pkg, unique_name, op_type, ins, outs, attrs, seed=SEED):
    """A one-op program: ``ins`` {slot: numpy} become data vars, ``outs``
    {slot: (dtype, shape)} the fetched vars."""
    main = pkg.Program()
    main.random_seed = seed
    with unique_name.guard({}), pkg.program_guard(main, pkg.Program()):
        blk = main.global_block()
        in_vars = {}
        for slot, arr in ins.items():
            in_vars[slot] = [pkg.layers.data(
                slot.lower(), shape=list(arr.shape), dtype=str(arr.dtype),
                append_batch_size=False).name]
        out_vars = {slot: [blk.create_var(name="out_" + slot.lower(),
                                          dtype=dt, shape=list(sh)).name]
                    for slot, (dt, sh) in outs.items()}
        blk.append_op(type=op_type, inputs=in_vars, outputs=out_vars,
                      attrs=dict(attrs))
    feed = {slot.lower(): arr for slot, arr in ins.items()}
    fetch = ["out_" + slot.lower() for slot in outs]
    return main, feed, fetch


def _runs(which, op_type, ins, outs, attrs, n_runs=2):
    pkg, un, Scope = _pkg(which)
    main, feed, fetch = _one_op(pkg, un, op_type, ins, outs, attrs)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = Scope()
    return [[np.asarray(v) for v in
             exe.run(main, feed=feed, fetch_list=fetch, scope=scope)]
            for _ in range(n_runs)]


def _assert_runs_equal(got, want, tol=0.0):
    for g_run, w_run in zip(got, want):
        for g, w in zip(g_run, w_run):
            assert g.shape == w.shape
            if tol:
                np.testing.assert_allclose(g, w, rtol=0, atol=tol)
            else:
                np.testing.assert_array_equal(g, w.astype(g.dtype))


_X = np.random.RandomState(0).randn(6, 40).astype("float32")
_PROBS = np.random.RandomState(1).dirichlet(
    np.ones(7), size=9).astype("float32")
_IMG = np.random.RandomState(2).rand(2, 3, 9, 8).astype("float32")

OP_CASES = {
    "uniform_random": (
        {}, {"Out": ("float32", (5, 37))},
        {"shape": [5, 37], "min": -0.25, "max": 0.75, "dtype": "float32"},
        0.0),
    "uniform_random_fixed_seed": (
        {}, {"Out": ("float32", (33,))},
        {"shape": [33], "min": -1.0, "max": 1.0, "seed": 99,
         "dtype": "float32"}, 0.0),
    "gaussian_random": (
        {}, {"Out": ("float32", (7, 31))},
        {"shape": [7, 31], "mean": 0.5, "std": 0.02, "dtype": "float32"},
        NORMAL_TOL),
    "truncated_gaussian_random": (
        {}, {"Out": ("float32", (4, 51))},
        {"shape": [4, 51], "mean": -1.0, "std": 2.0, "dtype": "float32"},
        NORMAL_TOL),
    "dropout": (
        {"X": _X}, {"Out": ("float32", _X.shape),
                    "Mask": ("float32", _X.shape)},
        {"dropout_prob": 0.3}, 0.0),
    "dropout_upscale": (
        {"X": _X}, {"Out": ("float32", _X.shape),
                    "Mask": ("float32", _X.shape)},
        {"dropout_prob": 0.1,
         "dropout_implementation": "upscale_in_train"}, 0.0),
    "sampling_id": (
        {"X": _PROBS}, {"Out": ("int64", (9,))}, {}, 0.0),
    "random_crop": (
        {"X": _IMG, "Seed": np.zeros(1, "int64")},
        {"Out": ("float32", (2, 3, 5, 4)), "SeedOut": ("int64", (1,))},
        {"shape": [5, 4]}, 0.0),
    "gaussian_random_batch_size_like": (
        {"Input": _X}, {"Out": ("float32", (6, 13))},
        {"shape": [-1, 13], "mean": 0.0, "std": 1.0, "dtype": "float32"},
        NORMAL_TOL),
    "uniform_random_batch_size_like": (
        {"Input": _X}, {"Out": ("float32", (3, 6))},
        {"shape": [3, -1], "input_dim_idx": 0, "output_dim_idx": 1,
         "min": 0.0, "max": 2.0, "dtype": "float32"}, 0.0),
    "random_data_generator": (
        {}, {"Out": ("float32", (4, 3, 5))},
        {"shape_concat": [4, 3, 5], "ranks": [3], "dtypes": ["float32"],
         "min": -2.0, "max": 3.0}, 0.0),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_random_op_matches_jax(case):
    ins, outs, attrs, tol = OP_CASES[case]
    op_type = {"uniform_random_fixed_seed": "uniform_random",
               "dropout_upscale": "dropout"}.get(case, case)
    want = _runs("jax", op_type, ins, outs, attrs)
    got = _runs("torch", op_type, ins, outs, attrs)
    _assert_runs_equal(got, want, tol)
    # each run draws anew, unless the op's own seed pins the stream
    first, second = got[0][0], got[1][0]
    if case == "uniform_random_fixed_seed":
        np.testing.assert_array_equal(first, second)
    elif case != "random_crop":
        assert not np.array_equal(first, second)


def _dropout_prog(pkg, un):
    main = pkg.Program()
    main.random_seed = SEED
    with un.guard({}), pkg.program_guard(main, pkg.Program()):
        x = pkg.layers.data("x", shape=[16, 8], dtype="float32",
                            append_batch_size=False)
        y = pkg.layers.dropout(x, dropout_prob=0.5)
        z = pkg.layers.uniform_random([3, 4], min=0.0, max=1.0)
    return main, [y, z]


def _counter_sequence(which):
    """run, run_async, run_multi_step (stacked), run: the outputs of
    each call in order."""
    pkg, un, Scope = _pkg(which)
    main, fetch = _dropout_prog(pkg, un)
    exe, scope = pkg.Executor(pkg.CPUPlace()), Scope()
    feed = {"x": np.ones((16, 8), "float32")}
    seq = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)]
    seq.append(exe.run_async(main, feed=feed, fetch_list=fetch,
                             scope=scope).result())
    seq.append(exe.run_multi_step(main, 3, feed=feed, fetch_list=fetch,
                                  scope=scope, stack_fetches=True))
    seq.append(exe.run_multi_step(main, 2, feed=feed, fetch_list=fetch,
                                  scope=scope))
    seq.append(exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
    return [[np.asarray(v) for v in outs] for outs in seq]


def test_run_counter_across_run_async_and_multi_step():
    want = _counter_sequence("jax")
    got = _counter_sequence("torch")
    assert [len(o) for o in got] == [len(o) for o in want]
    _assert_runs_equal(got, want)
    # the three stacked steps differ from one another
    stacked = got[2][0]
    assert stacked.shape == (3, 16, 8)
    assert not np.array_equal(stacked[0], stacked[1])


def _init_startup(which):
    pkg, un, Scope = _pkg(which)
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 77
    init = pkg.initializer
    bil = np.zeros((2, 2, 4, 4), "float32")
    with un.guard({}), pkg.program_guard(main, startup):
        specs = [
            ("u", [6, 7], init.Uniform(-0.3, 0.4)),
            ("u_seed", [5], init.Uniform(seed=3)),
            ("xav", [8, 12], init.Xavier()),
            ("xav_n", [8, 12], init.Xavier(uniform=False)),
            ("nrm", [9, 4], init.Normal(0.1, 0.5)),
            ("tn", [10, 6], init.TruncatedNormal(0.0, 0.02)),
            ("msra", [4, 3, 3, 3], init.MSRA()),
            ("msra_n", [4, 3, 3, 3], init.MSRA(uniform=False)),
            ("npa", [2, 3], init.NumpyArrayInitializer(
                np.arange(6, dtype="float32").reshape(2, 3))),
            ("bil", list(bil.shape), init.Bilinear()),
        ]
        for name, shape, ini in specs:
            pkg.layers.create_parameter(
                shape, "float32", name=name,
                attr=pkg.ParamAttr(name=name, initializer=ini))
    exe, scope = pkg.Executor(pkg.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    return {name: np.asarray(scope.find_var(name).value)
            for name, _, _ in specs}


def test_startup_initializers_match_jax():
    want = _init_startup("jax")
    got = _init_startup("torch")
    assert sorted(got) == sorted(want)
    for name in want:
        tol = NORMAL_TOL if name in ("xav_n", "nrm", "tn", "msra_n") else 0
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=tol,
                                   err_msg=name)
    assert np.abs(got["tn"]).max() <= 2 * 0.02 + 1e-7
    np.testing.assert_array_equal(got["npa"],
                                  np.arange(6).reshape(2, 3))


# -- twins of test_op_breadth_misc.py's random-op statistics -------------

def _both(op_type, ins, outs, attrs):
    want = _runs("jax", op_type, ins, outs, attrs, n_runs=1)[0]
    got = _runs("torch", op_type, ins, outs, attrs, n_runs=1)[0]
    return got, want


def test_gaussian_random_statistics():
    (out,), (want,) = _both(
        "gaussian_random", {}, {"Out": ("float32", (200, 100))},
        {"shape": [200, 100], "mean": 1.0, "std": 2.0, "seed": 7,
         "dtype": "float32"})
    assert out.shape == (200, 100)
    assert abs(out.mean() - 1.0) < 0.05
    assert abs(out.std() - 2.0) < 0.05
    np.testing.assert_allclose(out, want, rtol=0, atol=2 * NORMAL_TOL)


def test_uniform_random_statistics():
    (out,), (want,) = _both(
        "uniform_random", {}, {"Out": ("float32", (200, 100))},
        {"shape": [200, 100], "min": -2.0, "max": 4.0, "seed": 7,
         "dtype": "float32"})
    assert out.shape == (200, 100)
    assert out.min() >= -2.0 and out.max() <= 4.0
    assert abs(out.mean() - 1.0) < 0.1
    np.testing.assert_array_equal(out, want)


def test_truncated_gaussian_random_statistics():
    (out,), (want,) = _both(
        "truncated_gaussian_random", {}, {"Out": ("float32", (200, 100))},
        {"shape": [200, 100], "mean": 0.0, "std": 1.0, "seed": 7,
         "dtype": "float32"})
    assert np.abs(out).max() <= 2.0 + 1e-5
    assert abs(out.mean()) < 0.05
    np.testing.assert_allclose(out, want, rtol=0, atol=NORMAL_TOL)


def test_sampling_id_distribution():
    probs = np.tile(np.asarray([[0.7, 0.2, 0.1, 0.0]], "float32"), (512, 1))
    (ids,), (want,) = _both("sampling_id", {"X": probs},
                            {"Out": ("int64", (512,))}, {"seed": 9})
    assert ids.shape[0] == 512
    assert set(np.unique(ids)) <= {0, 1, 2}
    assert 0.6 < float(np.mean(ids == 0)) < 0.8
    np.testing.assert_array_equal(ids, want)


# -- twins of test_layers_misc.py's random_crop cases --------------------

def _crop_run(which, x, shape, seed=None, steps=1):
    pkg, un, Scope = _pkg(which)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = SEED
    with un.guard({}), pkg.program_guard(main, startup):
        xv = pkg.layers.data("x", list(x.shape[1:]))
        out = pkg.layers.random_crop(xv, shape=shape, seed=seed)
    exe, scope = pkg.Executor(pkg.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(exe.run(main, feed={"x": x}, fetch_list=[out],
                               scope=scope)[0]) for _ in range(steps)]


def test_random_crop_layer():
    x = np.random.RandomState(0).rand(4, 3, 8, 8).astype("float32")
    outs = _crop_run("torch", x, [3, 5, 5], steps=3)
    want = _crop_run("jax", x, [3, 5, 5], steps=3)
    for out, w in zip(outs, want):
        assert out.shape == (4, 3, 5, 5)
        np.testing.assert_array_equal(out, w)
    found = any(np.allclose(outs[0][0], x[0, :, i:i + 5, j:j + 5])
                for i in range(4) for j in range(4))
    assert found


def test_random_crop_seed_deterministic():
    x = np.arange(36, dtype="float32").reshape(1, 1, 6, 6)
    a = _crop_run("torch", x, [1, 3, 3], seed=42)[0]
    b = _crop_run("torch", x, [1, 3, 3], seed=42)[0]
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, _crop_run("jax", x, [1, 3, 3],
                                               seed=42)[0])


# -- random_data_generator and assign_value ------------------------------

def _rdg(which, steps=2):
    pkg, un, Scope = _pkg(which)
    main = pkg.Program()
    main.random_seed = 5
    with un.guard({}), pkg.program_guard(main, pkg.Program()):
        img, label = pkg.layers.random_data_generator(
            [[4, 3, 6, 6], [4, 1]], ["float32", "int64"], low=-1.0,
            high=1.0, int_low=0, int_high=999)
        s = pkg.layers.reduce_sum(img)
    exe, scope = pkg.Executor(pkg.CPUPlace()), Scope()
    return [[np.asarray(v) for v in exe.run(
        main, fetch_list=[img, label, s], scope=scope)]
        for _ in range(steps)]


def test_random_data_generator_matches_jax():
    want = _rdg("jax")
    got = _rdg("torch")
    for g_run, w_run in zip(got, want):
        np.testing.assert_array_equal(g_run[0], w_run[0])
        np.testing.assert_array_equal(g_run[1], w_run[1].astype(np.int64))
        np.testing.assert_allclose(g_run[2], w_run[2], rtol=1e-6)
    img, label = got[0][0], got[0][1]
    assert img.shape == (4, 3, 6, 6) and label.shape == (4, 1)
    assert img.min() >= -1.0 and img.max() < 1.0
    assert label.min() >= 0 and label.max() <= 999
    assert not np.array_equal(got[0][0], got[1][0])


def test_assign_value_from_numpy():
    arr = np.arange(12, dtype="float32").reshape(3, 4) / 7.0
    idx = np.asarray([[3, 1, 2]], "int64")
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        a = tfluid.layers.assign(arr)
        b = tfluid.layers.assign(idx)
        c = tfluid.layers.scale(a, scale=2.0)
    assert [op.type for op in main.global_block().ops][:2] == [
        "assign_value", "assign_value"]
    exe = tfluid.Executor(tfluid.CPUPlace())
    ga, gb, gc = exe.run(main, fetch_list=[a, b, c])
    np.testing.assert_array_equal(ga, arr)
    np.testing.assert_array_equal(gb, idx)
    assert gb.dtype == np.int64
    np.testing.assert_array_equal(gc, arr * 2.0)
