"""The port's ``metrics``, ``evaluator`` and ``average`` against the JAX
package's, on the CPU.

- the twins of ``tests/test_evaluator.py``'s three cases, each built and
  run in both packages: the in-program states come from the port's
  ``chunk_eval``, ``edit_distance`` and ``detection_map`` ops and
  accumulate to the JAX package's results;
- every class of ``metrics.py`` and ``average.WeightedAverage``, fed the
  same numpy inputs in both packages: equal results, before and after a
  ``reset()``.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import average as j_average
from paddle_tpu import metrics as j_metrics
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu_torch import average as t_average
from paddle_tpu_torch import metrics as t_metrics
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state

PKGS = {"jax": (jfluid, j_unique_name), "torch": (tfluid, t_unique_name)}


@pytest.fixture(autouse=True)
def _fresh():
    with fresh_state():
        yield


def _both(build, run):
    """``build(fw)`` -> evaluator inside a program in each package;
    ``run(fw, exe, main, ev)`` -> its results."""
    out = {}
    for pkg, (fw, names) in PKGS.items():
        main, startup = fw.Program(), fw.Program()
        with names.guard({}), fw.program_guard(main, startup):
            ev = build(fw)
        exe = fw.Executor(fw.CPUPlace())
        exe.run(startup)
        out[pkg] = run(fw, exe, main, ev)
    return out


def test_chunk_evaluator_accumulates():
    seq = np.array([[0, 1, 4, 2, 3, 4]], "int64")  # B-0 I-0 O B-1 I-1 O
    none = np.full((1, 6), 4, "int64")
    ln = np.array([[6]], "int64")

    def build(fw):
        L = fw.layers
        return fw.evaluator.ChunkEvaluator(
            L.data("pred", [6], dtype="int64"),
            L.data("label", [6], dtype="int64"), "IOB", 2,
            length=L.data("len", [1], dtype="int64"))

    def run(fw, exe, main, ev):
        ev.reset()
        for pred_v, label_v in [(seq, seq), (none, seq)]:
            ev.update(exe.run(main, feed={"pred": pred_v, "label": label_v,
                                          "len": ln},
                              fetch_list=ev.metrics))
        got = ev.eval()
        ev.reset()
        return got, ev.eval()

    out = _both(build, run)
    assert out["torch"] == out["jax"]
    np.testing.assert_allclose(out["torch"][0], (1.0, 0.5, 2 / 3),
                               rtol=1e-6)
    assert out["torch"][1] == (0.0, 0.0, 0.0)


def test_edit_distance_evaluator_accumulates():
    h = np.array([[1, 2, 3, 4], [1, 2, 3, 4]], "int64")
    r = np.array([[1, 2, 3, 4], [4, 3, 2, 1]], "int64")

    def build(fw):
        L = fw.layers
        return fw.evaluator.EditDistance(L.data("hyp", [4], dtype="int64"),
                                         L.data("ref", [4], dtype="int64"),
                                         normalized=False)

    def run(fw, exe, main, ev):
        ev.reset()
        ev.update(exe.run(main, feed={"hyp": h, "ref": r},
                          fetch_list=ev.metrics))
        return ev.eval()

    out = _both(build, run)
    assert out["torch"] == out["jax"]
    assert out["torch"][1] == 0.5 and out["torch"][0] > 0


def test_detection_map_evaluator_accumulates():
    det = np.zeros((1, 2, 6), "float32")
    det[0, 0] = [1, 0.9, 0.1, 0.1, 0.4, 0.4]
    det[0, 1] = [-1, 0, 0, 0, 0, 0]
    gt_label = np.array([[1]], "int32")
    gt_box = np.array([[[0.1, 0.1, 0.4, 0.4]]], "float32")

    def build(fw):
        L = fw.layers
        return fw.evaluator.DetectionMAP(L.data("d", [2, 6]),
                                         L.data("l", [1], dtype="int32"),
                                         L.data("b", [1, 4]), class_num=2)

    def run(fw, exe, main, ev):
        (batch_map,) = exe.run(main, feed={"d": det, "l": gt_label,
                                           "b": gt_box},
                               fetch_list=ev.metrics)
        ev.update(det, gt_label, gt_box)
        got = (float(np.ravel(batch_map)[0]), ev.eval())
        ev.reset()
        return got + (ev.eval(),)

    out = _both(build, run)
    np.testing.assert_allclose(out["torch"], out["jax"], atol=1e-6)
    np.testing.assert_allclose(out["torch"][:2], (1.0, 1.0), atol=1e-5)
    assert out["torch"][2] == 0.0


# -- metrics.py and average.py, fed the same inputs -----------------------------

def _feed_both(make, feed, mods=(j_metrics, t_metrics)):
    results = []
    for mod in mods:
        m = make(mod)
        for args in feed:
            m.update(*args) if not hasattr(m, "add") else m.add(*args)
        got = m.eval()
        m.reset()
        results.append((got, m))
    return results


def _eq(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _eq(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


_RNG = np.random.RandomState(9)
_PREDS = [_RNG.rand(16, 1).astype("float32") for _ in range(3)]
_LABELS = [(_RNG.rand(16, 1) > 0.5).astype("int64") for _ in range(3)]

CASES = {
    "Precision": (lambda m: m.Precision(),
                  [(p, l) for p, l in zip(_PREDS, _LABELS)]),
    "Recall": (lambda m: m.Recall(),
               [(p, l) for p, l in zip(_PREDS, _LABELS)]),
    "Accuracy": (lambda m: m.Accuracy(), [(0.75, 16), (0.5, 8), (1.0, 4)]),
    "ChunkEvaluator": (lambda m: m.ChunkEvaluator(),
                       [(4, 5, 3), (2, 2, 2), (0, 3, 0)]),
    "EditDistance": (lambda m: m.EditDistance(),
                     [(np.array([[0.0], [2.0], [1.0]]), 3),
                      (np.array([[0.0]]), 1)]),
    "Auc": (lambda m: m.Auc(num_thresholds=200),
            [(np.concatenate([1 - p, p], 1), l)
             for p, l in zip(_PREDS, _LABELS)]),
    "DetectionMAP": (lambda m: m.DetectionMAP(class_num=3),
                     [(np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                                  [2, 0.8, 0.5, 0.5, 0.9, 0.9],
                                  [1, 0.3, 0.6, 0.6, 0.8, 0.8]]], "float32"),
                       np.array([[1, 2]], "int32"),
                       np.array([[[0.1, 0.1, 0.4, 0.4],
                                  [0.5, 0.5, 0.8, 0.8]]], "float32"))]),
    "CompositeMetric": (None, [(p, l) for p, l in zip(_PREDS, _LABELS)]),
    "WeightedAverage": (None, [(1.5, 2), (np.float32(0.25), 6), (3.0, 1)]),
}


def _composite(m):
    c = m.CompositeMetric()
    c.add_metric(m.Precision())
    c.add_metric(m.Recall())
    return c


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_class_matches_jax_package(name):
    make, feed = CASES[name]
    mods = (j_metrics, t_metrics)
    if name == "CompositeMetric":
        make = _composite
    elif name == "WeightedAverage":
        make, mods = (lambda m: m.WeightedAverage()), (j_average, t_average)
    (jgot, jm), (tgot, tm) = _feed_both(make, feed, mods)
    _eq(tgot, jgot)
    assert type(tgot) is type(jgot)
    # after reset(): equal results, or the same error in both
    after = []
    for m in (jm, tm):
        try:
            after.append(m.eval())
        except ValueError as e:
            after.append(type(e))
    if isinstance(after[0], type):
        assert after[1] is after[0]
    else:
        _eq(after[1], after[0])


def test_detection_map_accumulated_equals_in_graph_over_images():
    """Several images, several classes, padded detections and gts: the
    host accumulator's mAP equals the in-graph ``detection_map`` op's,
    in both packages."""
    rng = np.random.RandomState(3)
    N, D, G, C = 6, 20, 5, 4
    det = np.zeros((N, D, 6), "float32")
    det[:, :, 0] = -1
    gl = np.full((N, G), -1, "int32")
    gb = np.zeros((N, G, 4), "float32")
    for i in range(N):
        m = rng.randint(1, G + 1)
        xy = rng.uniform(0, 0.7, (m, 2))
        gb[i, :m] = np.concatenate([xy, xy + rng.uniform(0.1, 0.3, (m, 2))],
                                   1)
        gl[i, :m] = rng.randint(1, C, m)
        k = rng.randint(1, D)
        j = rng.randint(0, m, k)
        det[i, :k, 0] = np.where(rng.rand(k) < 0.8, gl[i, j],
                                 rng.randint(1, C, k))
        det[i, :k, 1] = rng.rand(k)
        det[i, :k, 2:] = gb[i, j] + rng.normal(0, 0.02, (k, 4))

    def build(fw):
        L = fw.layers
        return fw.evaluator.DetectionMAP(L.data("d", [D, 6]),
                                         L.data("l", [G], dtype="int32"),
                                         L.data("b", [G, 4]), class_num=C)

    def run(fw, exe, main, ev):
        (m,) = exe.run(main, feed={"d": det, "l": gl, "b": gb},
                       fetch_list=ev.metrics)
        ev.update(det, gl, gb)
        return float(np.ravel(m)[0]), ev.eval()

    out = _both(build, run)
    np.testing.assert_allclose(out["torch"], out["jax"], atol=1e-6)
    assert 0.2 < out["torch"][1] <= 1.0
    np.testing.assert_allclose(out["torch"][0], out["torch"][1], atol=1e-6)
