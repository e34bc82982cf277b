"""The metric op types of the PyTorch port against the JAX package, on the
CPU: ``auc``, ``precision_recall``, ``mean_iou`` and
``positive_negative_pair`` (``chunk_eval`` is in
``tests/test_torch_nlp.py``).

Each case's seeded numpy inputs go through the JAX op's lowering and the
port's: counts and states equal, metrics within 1e-6. The cases include
``tests/test_vision_quant_ops.py``'s ``mean_iou`` and
``positive_negative_pair`` rows (the tie quirk, weights and the
accumulators), and the ``auc`` and ``precision_recall`` layers run three
times in both packages, their persistable states accumulating.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.ops import metric_ops as j_metric
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.ops import metric_ops as t_metric
from paddle_tpu_torch.testing import fresh_state

rng = np.random.RandomState(31)


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _check(op, ins, attrs):
    # one jitted computation: eager JAX compiles every primitive apart
    lower = getattr(j_metric, "_lower_" + op)
    want = jax.jit(lambda d: lower(None, d, attrs))(
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()})
    got = getattr(t_metric, "_lower_" + op)(None, {
        k: [torch.from_numpy(np.array(a)) for a in v]
        for k, v in ins.items()}, attrs)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _probs(n, c):
    p = rng.rand(n, c).astype("float32")
    return p / p.sum(1, keepdims=True)


CASES = [
    ("auc", {"Predict": [_probs(40, 2)],
             "Label": [rng.randint(0, 2, (40, 1)).astype("int64")],
             "StatPos": [np.zeros(200, "int64")],
             "StatNeg": [np.zeros(200, "int64")]}, {"num_thresholds": 200}),
    ("auc", {"Predict": [rng.rand(30).astype("float32")],
             "Label": [rng.randint(0, 2, (30,)).astype("int64")],
             "StatPos": [rng.randint(0, 5, 50).astype("int64")],
             "StatNeg": [rng.randint(0, 5, 50).astype("int64")]},
     {"num_thresholds": 50}),
    ("precision_recall", {"MaxProbs": [rng.rand(25, 1).astype("float32")],
                          "Indices": [rng.randint(0, 4, (25, 1))],
                          "Labels": [rng.randint(0, 4, (25, 1))]},
     {"class_number": 4}),
    ("precision_recall", {"MaxProbs": [rng.rand(25, 1).astype("float32")],
                          "Indices": [rng.randint(0, 5, (25, 1))],
                          "Labels": [rng.randint(0, 5, (25, 1))],
                          "Weights": [rng.rand(25, 1).astype("float32")],
                          "StatesInfo": [rng.randint(0, 9, (5, 4)).astype(
                              "float32")]}, {"class_number": 5}),
    ("mean_iou", {"Predictions": [np.array([0, 1, 2, 2, 1, 0, 1], "int32")],
                  "Labels": [np.array([0, 1, 1, 2, 2, 0, 1], "int32")]},
     {"num_classes": 3}),
    ("mean_iou", {"Predictions": [rng.randint(0, 5, (4, 6)).astype("int32")],
                  "Labels": [rng.randint(0, 5, (4, 6)).astype("int32")],
                  "InWrongs": [rng.randint(0, 3, 6).astype("int32")] * 2,
                  "InCorrects": [rng.randint(0, 3, 6).astype("int32")],
                  "InMeanIou": [np.array([0.25], "float32")]},
     {"num_classes": 6}),
    ("positive_negative_pair",
     {"Score": [np.array([[0.9], [0.5], [0.7], [0.2], [0.2]], "float32")],
      "Label": [np.array([[1.0], [0.0], [1.0], [0.0], [1.0]], "float32")],
      "QueryID": [np.array([[1], [1], [1], [2], [2]], "int64")]}, {}),
    ("positive_negative_pair",
     {"Score": [np.array([[0.3], [0.6]], "float32")],
      "Label": [np.array([[1.0], [0.0]], "float32")],
      "QueryID": [np.array([[7], [7]], "int64")],
      "Weight": [np.array([[2.0], [4.0]], "float32")],
      "AccumulatePositivePair": [np.array([10.0], "float32")],
      "AccumulateNegativePair": [np.array([20.0], "float32")],
      "AccumulateNeutralPair": [np.array([30.0], "float32")]}, {}),
    ("positive_negative_pair",
     {"Score": [np.round(rng.rand(16, 3), 1).astype("float32")],
      "Label": [rng.randint(0, 3, (16, 1)).astype("float32")],
      "QueryID": [rng.randint(0, 3, (16, 1)).astype("int64")],
      "Weight": [rng.rand(16, 1).astype("float32")]}, {"column": 1}),
]


@pytest.mark.parametrize("op,ins,attrs", CASES,
                         ids=["%s%d" % (c[0], i) for i, c in
                              enumerate(CASES)])
def test_metric_op_matches_jax(op, ins, attrs):
    _check(op, ins, attrs)


def _metric_program(pkg, unique_name):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        p = pkg.layers.data("p", [3])
        lb = pkg.layers.data("lb", [1], dtype="int64")
        auc, _ = pkg.layers.auc(pkg.layers.slice(p, [1], [0], [2]), lb,
                                num_thresholds=64)
        batch, accum, _ = pkg.layers.precision_recall(p, lb, 3)
    return main, startup, [auc, batch, accum]


def test_auc_and_precision_recall_layers_accumulate_like_jax():
    feeds = [{"p": _probs(10, 3), "lb": rng.randint(0, 2, (10, 1)).astype(
        "int64")} for _ in range(3)]
    out = {}
    for name, pkg, un, scope in (("jax", jfluid, j_unique_name, JScope()),
                                 ("torch", tfluid, t_unique_name,
                                  tfluid.Scope())):
        main, startup, fetch = _metric_program(pkg, un)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        out[name] = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=fetch, scope=scope)] for f in feeds]
    for j, t in zip(out["jax"], out["torch"]):
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    # the accumulated metrics moved: the states persisted across runs
    assert not np.array_equal(out["torch"][0][2], out["torch"][2][2])
