"""Every op type of the serving slice, one program each, through both
packages.

Each case builds a one-op program in the JAX package and in the PyTorch
port, runs it through each package's ``Executor`` on the CPU with the
same numpy feeds, and compares the fetched outputs: exactly for integer
and data-movement ops, within 1e-5 (relative and absolute) for
arithmetic in fp32. The paged KV writes are compared outside the trash
page 0, where several writers land and which one survives is
unspecified. The random initializers draw other bits in each package,
so for them shape, dtype and range are compared.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import op_registry as t_registry
from paddle_tpu_torch.testing import fresh_state

FLOAT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _rng(seed):
    return np.random.RandomState(seed)


def _f(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _i(values):
    return np.asarray(values, dtype="int64")


def _pool_case(rng):
    """Paged pools for 3 slots: pages 1..6, slot 2 parked on the trash
    page."""
    S, H, ps, dh, npp = 3, 2, 4, 8, 2
    kp, vp = _f(rng, 7, H, ps, dh), _f(rng, 7, H, ps, dh)
    table = _i([[1, 2], [3, 3], [0, 0]])
    return S, H, ps, dh, npp, kp, vp, table


def _cases():
    r = _rng(0)
    cases = [
        ("add_position_encoding", {"X": [("x", _f(r, 2, 5, 8))]},
         {"Out": ["o"]}, {"alpha": 0.5, "beta": 2.0}, "close"),
        ("assign", {"X": [("x", _f(r, 3, 4))]}, {"Out": ["o"]}, {},
         "exact"),
        ("dynamic_update_slice",
         {"X": [("x", _f(r, 4, 6))], "Update": [("u", _f(r, 1, 6))],
          "Index": [("i", _i([2]))]}, {"Out": ["o"]}, {"axis": 0},
         "exact"),
        ("elementwise_add", {"X": [("x", _f(r, 2, 3, 4))],
                             "Y": [("y", _f(r, 3))]},
         {"Out": ["o"]}, {"axis": 1}, "close"),
        ("elementwise_sub", {"X": [("x", _i([[1], [0], [1]]))],
                             "Y": [("y", _i([[1], [1], [0]]))]},
         {"Out": ["o"]}, {"axis": -1}, "exact"),
        ("elementwise_mul", {"X": [("x", _f(r, 2, 4))],
                             "Y": [("y", _f(r, 2, 4))]},
         {"Out": ["o"]}, {"axis": -1}, "close"),
        ("elementwise_div", {"X": [("x", _f(r, 1))],
                             "Y": [("y", np.asarray([7.0], "float32"))]},
         {"Out": ["o"]}, {"axis": -1}, "close"),
        ("fill_constant", {}, {"Out": ["o"]},
         {"shape": [2, 3], "dtype": "int64", "value": 7.0}, "exact"),
        ("gather", {"X": [("x", _f(r, 5, 3))],
                    "Index": [("i", _i([4, 0, 4]))]},
         {"Out": ["o"]}, {}, "exact"),
        ("increment", {"X": [("x", _i([[3], [0]]))]}, {"Out": ["o"]},
         {"step": 1.0}, "exact"),
        ("layer_norm", {"X": [("x", _f(r, 2, 3, 8))],
                        "Scale": [("s", _f(r, 8))],
                        "Bias": [("b", _f(r, 8))]},
         {"Y": ["o"], "Mean": ["m"], "Variance": ["v"]},
         {"epsilon": 1e-5, "begin_norm_axis": 2}, "close"),
        ("lookup_table", {"W": [("w", _f(r, 10, 4))],
                          "Ids": [("ids", _i([[1, 9, 3], [3, 0, 0]]))]},
         {"Out": ["o"]}, {"padding_idx": 3}, "exact"),
        ("mul", {"X": [("x", _f(r, 2, 3, 4))], "Y": [("y", _f(r, 4, 5))]},
         {"Out": ["o"]}, {"x_num_col_dims": 2, "y_num_col_dims": 1},
         "close"),
        ("relu", {"X": [("x", _f(r, 3, 5))]}, {"Out": ["o"]}, {}, "exact"),
        ("reshape", {"X": [("x", _f(r, 2, 3, 4))]}, {"Out": ["o"]},
         {"shape": [0, -1]}, "exact"),
        ("scale", {"X": [("x", _f(r, 3, 4))]}, {"Out": ["o"]},
         {"scale": 2.5, "bias": 1.0, "bias_after_scale": False}, "close"),
        ("scaled_dot_product_attention",
         {"Q": [("q", _f(r, 2, 2, 5, 8))], "K": [("k", _f(r, 2, 2, 7, 8))],
          "V": [("v", _f(r, 2, 2, 7, 8))],
          "Mask": [("m", np.asarray([[1] * 7, [1] * 4 + [0] * 3],
                                    "float32"))]},
         {"Out": ["o"]}, {"sm_scale": 0.0}, "close"),
        ("sequence_mask", {"X": [("x", _i([[3], [0], [6]]))]},
         {"Y": ["o"]}, {"maxlen": 6, "out_dtype": "float32"}, "exact"),
        ("transpose", {"X": [("x", _f(r, 2, 3, 4))]}, {"Out": ["o"]},
         {"axis": [1, 0, 2]}, "exact"),
        ("softmax_with_cross_entropy",
         {"Logits": [("x", _f(r, 4, 6))],
          "Label": [("y", _i([[0], [5], [2], [2]]))]},
         {"Softmax": ["sm"], "Loss": ["o"]}, {}, "close"),
        ("reduce_sum", {"X": [("x", _f(r, 3, 4, 2))]}, {"Out": ["o"]},
         {"dim": [1], "keep_dim": True, "reduce_all": False}, "close"),
        # what the speculative verify program adds: concat, elementwise_min
        # and int64 arithmetic on positions, depths and page ids
        ("concat", {"X": [("a", _i([[1], [4]])), ("b", _i([[7, 8], [9, 3]]))]},
         {"Out": ["o"]}, {"axis": 1}, "exact"),
        ("elementwise_min", {"X": [("x", _i([[3, 9, 6], [7, 2, 8]]))],
                             "Y": [("y", _i([[6]]))]},
         {"Out": ["o"]}, {"axis": -1}, "exact"),
        ("elementwise_add", {"X": [("x", _i([[3], [250]]))],
                             "Y": [("y", _i([[0, 1, 2], [0, 1, 1]]))]},
         {"Out": ["o"]}, {"axis": -1}, "exact"),
        ("elementwise_mul", {"X": [("x", _i([[5, 6, 6], [2, 2, 2]]))],
                             "Y": [("y", _i([[1], [0]]))]},
         {"Out": ["o"]}, {"axis": -1}, "exact"),
        ("reduce_sum", {"X": [("x", _i(np.tril(np.ones((2, 3, 3)))))]},
         {"Out": ["o"]},
         {"dim": [2], "keep_dim": False, "reduce_all": False}, "exact"),
        ("uniform_random", {}, {"Out": ["o"]},
         {"shape": [64, 8], "min": -0.5, "max": 0.25, "seed": 3,
          "dtype": "float32"}, "random"),
        ("gaussian_random", {}, {"Out": ["o"]},
         {"shape": [64, 8], "mean": 0.0, "std": 1.0, "seed": 3,
          "dtype": "float32"}, "random"),
    ]
    # greedy decode step: a tie (first maximum wins), a done slot forced
    # to eos, an eos emission and a slot at the end of its budget
    logits = _f(r, 4, 1, 7)
    logits[0, 0, 3] = logits[0, 0, 5] = logits[0].max() + 1.0
    logits[2, 0, 2] = logits[2].max() + 1.0
    cases.append(("slot_decode_sample",
                  {"Logits": [("lg", logits)],
                   "Pos": [("pos", _i([[0], [2], [1], [4]]))],
                   "Done": [("done", _i([[0], [1], [0], [0]]))]},
                  {"Out": ["o"], "PosOut": ["p"], "DoneOut": ["d"]},
                  {"eos_id": 2, "max_length": 6}, "exact"))
    S, H, ps, dh, npp, kp, vp, table = _pool_case(r)
    cases.append(("paged_attention",
                  {"Q": [("q", _f(r, S, H, 1, dh))], "KPool": [("kp", kp)],
                   "VPool": [("vp", vp)], "PageTable": [("t", table)],
                   "Lengths": [("len", _i([[6], [3], [0]]))]},
                  {"Out": ["o"]}, {"sm_scale": 0.0}, "close"))
    cases.append(("paged_kv_write",
                  {"KPool": [("kp", kp)], "VPool": [("vp", vp)],
                   "KNew": [("kn", _f(r, S, H, 1, dh))],
                   "VNew": [("vn", _f(r, S, H, 1, dh))],
                   "PageTable": [("t", table)],
                   "Pos": [("pos", _i([[5], [2], [0]]))]},
                  {"KOut": ["kp"], "VOut": ["vp"]}, {}, "pool"))
    cases.append(("paged_kv_prefill",
                  {"KPool": [("kp", kp)], "VPool": [("vp", vp)],
                   "KNew": [("kn", _f(r, 1, H, 8, dh))],
                   "VNew": [("vn", _f(r, 1, H, 8, dh))],
                   "PageRow": [("row", _i([[4, 5]]))],
                   "WriteFrom": [("wf", _i([[1]]))],
                   "Len": [("len", _i([[7]]))]},
                  {"KOut": ["kp"], "VOut": ["vp"]}, {}, "pool"))
    cases.append(("paged_copy_page",
                  {"KPool": [("kp", kp)], "VPool": [("vp", vp)],
                   "Src": [("src", _i([2]))], "Dst": [("dst", _i([5]))]},
                  {"KOut": ["kp"], "VOut": ["vp"]}, {}, "exact"))
    G, T = 2, 6
    cases.append(("grouped_cross_attention",
                  {"Q": [("q", _f(r, 3, H, 1, dh))],
                   "KPool": [("kc", _f(r, G, H, T, dh))],
                   "VPool": [("vc", _f(r, G, H, T, dh))],
                   "GroupOf": [("gof", _i([[1], [0], [1]]))],
                   "Mask": [("m", np.asarray([[1] * 6, [1] * 2 + [0] * 4],
                                             "float32"))]},
                  {"Out": ["o"]}, {"sm_scale": 0.25}, "close"))
    # the RNN slice's op breadth (the recurrences themselves are in
    # tests/test_torch_rnn.py)
    for op_type in ("sigmoid", "tanh", "softmax", "mean"):
        cases.append((op_type, {"X": [("x", _f(r, 3, 5))]}, {"Out": ["o"]},
                      {}, "close"))
    probs = np.asarray([[0.7, 0.2, 0.1], [0.1, 0.3, 0.6], [0.5, 0.5, 0.0]],
                       "float32")
    cases.append(("cross_entropy", {"X": [("x", probs)],
                                    "Label": [("l", _i([[0], [1], [2]]))]},
                  {"Y": ["o"]}, {}, "close"))
    cases.append(("cross_entropy", {"X": [("x", probs)],
                                    "Label": [("l", probs[::-1].copy())]},
                  {"Y": ["o"]}, {"soft_label": True}, "close"))
    cases.append(("top_k", {"X": [("x", _f(r, 4, 6))]},
                  {"Out": ["o"], "Indices": ["i"]}, {"k": 2}, "exact"))
    cases.append(("accuracy", {"Out": [("v", _f(r, 4, 2))],
                               "Indices": [("i", _i([[0, 2], [1, 0], [2, 1],
                                                     [3, 1]]))],
                               "Label": [("l", _i([[2], [1], [0], [3]]))]},
                  {"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]}, {},
                  "exact"))
    seq = _f(r, 3, 5, 4)
    for ptype in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
        cases.append(("sequence_pool",
                      {"X": [("x", seq)], "Length": [("len",
                                                      _i([[5], [2], [0]]))]},
                      {"Out": ["o"], "MaxIndex": ["mi"]},
                      {"pooltype": ptype}, "close"))
    for ptype in ("AVERAGE", "MAX", "LAST"):
        cases.append(("sequence_pool", {"X": [("x", seq)]},
                      {"Out": ["o"], "MaxIndex": ["mi"]},
                      {"pooltype": ptype}, "close"))
    return cases


CASES = _cases()


def _ids(cases):
    """The op type, numbered from its second case on."""
    seen, ids = {}, []
    for c in cases:
        seen[c[0]] = seen.get(c[0], 0) + 1
        ids.append(c[0] if seen[c[0]] == 1 else "%s_%d" % (c[0], seen[c[0]]))
    return ids


def _run(pkg, op_type, ins, outs, attrs):
    prog = pkg.Program()
    blk = prog.global_block()
    feed = {}
    for items in ins.values():
        for name, arr in items:
            if not blk.has_var(name):
                blk.create_var(name=name, shape=arr.shape,
                               dtype=str(arr.dtype), is_data=True)
            feed[name] = arr
    fetch = [n for names in outs.values() for n in names]
    for name in fetch:
        if not blk.has_var(name):
            blk.create_var(name=name)
    blk.append_op(type=op_type,
                  inputs={s: [n for n, _ in items]
                          for s, items in ins.items()},
                  outputs=outs, attrs=dict(attrs))
    exe = pkg.Executor(pkg.CPUPlace())
    return [np.asarray(v) for v in exe.run(prog, feed=feed,
                                           fetch_list=fetch)]


def test_cases_cover_every_op_type_of_the_slice():
    """The 24 op types the paged serving programs run, the four that
    ``transformer.build()`` appends and the two plain ops the speculative
    verify program adds (its own ops are in
    tests/test_torch_speculative_ops.py), the RNN models' eight plain ops,
    and nothing missing from the port's registry."""
    covered = {c[0] for c in CASES}
    serving = {
        "add_position_encoding", "assign", "dynamic_update_slice",
        "elementwise_add", "elementwise_mul", "elementwise_sub",
        "fill_constant", "gather", "grouped_cross_attention", "increment",
        "layer_norm", "lookup_table", "mul", "paged_attention",
        "paged_kv_prefill", "paged_kv_write", "relu", "reshape", "scale",
        "scaled_dot_product_attention", "sequence_mask",
        "slot_decode_sample", "transpose", "paged_copy_page"}
    build = {"softmax_with_cross_entropy", "reduce_sum", "elementwise_div",
             "uniform_random"}
    rnn = {"sigmoid", "tanh", "softmax", "mean", "cross_entropy", "top_k",
           "accuracy", "sequence_pool"}
    assert serving | build | rnn | {"concat", "elementwise_min"} <= covered
    assert covered <= set(t_registry.registered_ops())


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_op_matches_jax(case):
    op_type, ins, outs, attrs, mode = case
    want = _run(jfluid, op_type, ins, outs, attrs)
    got = _run(tfluid, op_type, ins, outs, attrs)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if mode == "random":
            assert g.dtype == np.float32 and np.isfinite(g).all()
            if op_type == "uniform_random":
                assert g.min() >= attrs["min"] and g.max() < attrs["max"]
            assert np.unique(g).size > g.size // 2
        elif mode == "pool":
            np.testing.assert_array_equal(g[1:], w[1:])
        elif mode == "exact":
            np.testing.assert_array_equal(g, w.astype(g.dtype))
        else:
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL)


@pytest.mark.parametrize("in_place", [False, True])
def test_dynamic_update_slice_clamps_like_xla(in_place):
    """The start index clamps into range (XLA dynamic-update-slice), and
    the ``out=x`` form updates its input variable."""
    r = _rng(1)
    x = _f(r, 4, 6)
    ins = {"X": [("x", x)], "Update": [("u", _f(r, 2, 6))],
           "Index": [("i", _i([9]))]}
    outs = {"Out": ["x" if in_place else "o"]}
    want = _run(jfluid, "dynamic_update_slice", ins, outs, {"axis": 0})
    got = _run(tfluid, "dynamic_update_slice", ins, outs, {"axis": 0})
    np.testing.assert_array_equal(got[0], want[0])
