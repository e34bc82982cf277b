"""The detection ops of the port against the JAX package's, on the CPU:
twins of ``tests/test_detection.py``'s op cases (its ``metrics``
accumulator and its mesh run are A11 and A10), each built the same way
in both packages from the same seeded numpy inputs.

Selections are equal: match indices, negative masks, keep masks,
``Count``, the sampled RPN and RoI labels and indices (both draw jax's
threefry stream from the same keys). Values are within 1e-5, and so is
``roi_align``'s gradient. Beside the op cases: the plain versions of the
port's two kernels (``kernels/detection.py``) against the JAX
package's own loops on inputs with tied scores, ``greedy_nms`` with
``eta < 1`` against ``_nms_single_class`` and ``det_match``'s true and
false positives against the ones ``detection_map``'s lowering computes
inside its ``fori_loop``.
"""

import inspect
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _ops(program):
    return [(op.type, op.inputs, op.outputs, dict(op.attrs))
            for op in program.global_block().ops]


def _run_both(build, feed, seed=7, grads_of=None):
    """``build(pkg) -> fetches`` in both packages (program seeds
    ``seed``; each executor runs its startup program first, so both key
    their draws from the same run count). ``grads_of(fetches) -> (loss,
    [vars])`` appends the gradients of ``loss`` to the fetches. Returns
    the JAX package's and the port's fetched values; their programs'
    ops must be equal."""
    res, progs = [], []
    for pkg, un in ((jfluid, j_unique_name), (tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = seed
        with un.guard({}), pkg.program_guard(main, startup):
            fetches = list(build(pkg))
            if grads_of is not None:
                loss, wrt = grads_of(pkg, fetches)
                fetches += pkg.backward.calc_gradient(loss, wrt)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup)
        outs = exe.run(main, feed=feed, fetch_list=fetches)
        res.append([np.asarray(o) for o in outs])
        progs.append(_ops(main))
    assert progs[0] == progs[1]
    return res


def _check(want, got):
    """Equal selections, values within TOL."""
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        else:
            assert g.dtype.kind == w.dtype.kind, (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)


def _both(build, feed, **kw):
    want, got = _run_both(build, feed, **kw)
    _check(want, got)
    return got


def _np_iou(a, b):
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1],
                                                           0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1],
                                                           0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-10)


def _rand_boxes(rng, n, scale=1.0):
    xy = rng.uniform(0, 0.7 * scale, (n, 2))
    wh = rng.uniform(0.1 * scale, 0.3 * scale, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype("float32")


# ---------------------------------------------------------------------------
# the registry and the layers
# ---------------------------------------------------------------------------


def test_every_reference_detection_op_is_registered():
    from paddle_tpu.core import op_registry as j_registry
    from paddle_tpu_torch.core import op_registry as t_registry

    import paddle_tpu.ops.detection_ops as j_det

    want = {t for t in j_registry.registered_ops()
            if not t.endswith("_grad")
            and j_registry.get_op_def(t).lower.__module__ == j_det.__name__}
    assert len(want) == 17
    for t in sorted(want):
        assert t_registry.has_op(t), t
        jd, td = j_registry.get_op_def(t), t_registry.get_op_def(t)
        assert (td.inputs, td.outputs, td.attrs) == \
            (jd.inputs, jd.outputs, jd.attrs), t
        assert (td.grad is None) == (jd.grad is None), t
        assert td.no_grad_inputs == jd.no_grad_inputs, t


def test_detection_layers_are_exported_with_their_signatures():
    import paddle_tpu.layers.detection as j_det_layers

    assert len(j_det_layers.__all__) == 19
    for name in j_det_layers.__all__:
        assert hasattr(tfluid.layers, name), name
        assert inspect.signature(getattr(tfluid.layers, name)) == \
            inspect.signature(getattr(jfluid.layers, name)), name


# ---------------------------------------------------------------------------
# matching, assignment, mining
# ---------------------------------------------------------------------------


def _np_bipartite(dist, match_type, thr):
    g, p = dist.shape
    d = dist.copy()
    row_valid = d.max(axis=1) > 0
    d[~row_valid] = -1.0
    midx = np.full(p, -1, np.int32)
    mdist = np.zeros(p, np.float32)
    work = d.copy()
    for _ in range(min(g, p)):
        k = np.argmax(work)
        r, c = k // p, k % p
        if work[r, c] <= 0:
            break
        midx[c] = r
        mdist[c] = work[r, c]
        work[r, :] = -1
        work[:, c] = -1
    if match_type == "per_prediction":
        best = d.max(axis=0)
        best_row = d.argmax(axis=0)
        for c in range(p):
            if midx[c] < 0 and best[c] >= thr:
                midx[c] = best_row[c]
                mdist[c] = best[c]
    return midx, mdist


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match(match_type):
    rng = np.random.RandomState(7)
    n, g, p = 2, 3, 8
    gt = np.stack([_rand_boxes(rng, g) for _ in range(n)])
    gt[1, 2] = 0.0  # padded gt row
    priors = _rand_boxes(rng, p)
    dist = np.stack([_np_iou(gt[i], priors) for i in range(n)])

    def build(pkg):
        d = pkg.layers.data("dist", [g, p], append_batch_size=True)
        return pkg.layers.bipartite_match(d, match_type, 0.3)

    mi, md = _both(build, {"dist": dist.astype("float32")})
    assert mi.dtype == np.int32
    for i in range(n):
        emi, emd = _np_bipartite(dist[i], match_type, 0.3)
        np.testing.assert_array_equal(mi[i], emi)
        np.testing.assert_allclose(md[i], emd, rtol=1e-5)


def test_bipartite_match_with_ties_and_more_gt_than_priors():
    """Equal distances (the first flat argmax wins) and G > P (min(G, P)
    rounds)."""
    dist = np.array([[[0.5, 0.5, 0.2], [0.5, 0.9, 0.9], [0.0, 0.0, 0.0],
                      [0.7, 0.1, 0.7], [0.9, 0.3, 0.2]]], "float32")

    def build(pkg):
        d = pkg.layers.data("dist", [5, 3], append_batch_size=True)
        return pkg.layers.bipartite_match(d, "per_prediction", 0.4)

    _both(build, {"dist": dist})


def test_target_assign_gathers_matched_rows():
    rng = np.random.RandomState(3)
    n, g, p, k = 2, 3, 5, 4
    x = rng.randn(n, g, k).astype("float32")
    x4 = rng.randn(n, g, p, k).astype("float32")
    midx = np.array([[0, -1, 2, 1, -1], [2, 2, -1, 0, 1]], np.int32)
    neg = np.array([[0, 1, 0, 0, 0], [0, 0, 1, 0, 0]], "float32")
    lab = rng.randint(1, 5, (n, g, 1)).astype("int32")

    def build(pkg):
        xv = pkg.layers.data("x", [g, k])
        x4v = pkg.layers.data("x4", [g, p, k])
        lv = pkg.layers.data("lab", [g, 1], dtype="int32")
        mv = pkg.layers.data("m", [p], dtype="int32")
        nv = pkg.layers.data("neg", [p])
        out = pkg.layers.target_assign(xv, mv, mismatch_value=0)
        out4 = pkg.layers.target_assign(x4v, mv, mismatch_value=0.5)
        outl = pkg.layers.target_assign(lv, mv, negative_mask=nv,
                                        mismatch_value=0)
        return list(out) + list(out4) + list(outl)

    out, w = _both(build, {"x": x, "x4": x4, "lab": lab, "m": midx,
                           "neg": neg})[:2]
    for i in range(n):
        for j in range(p):
            if midx[i, j] >= 0:
                np.testing.assert_allclose(out[i, j], x[i, midx[i, j]],
                                           rtol=1e-6)
                assert w[i, j, 0] == 1.0
            else:
                np.testing.assert_array_equal(out[i, j], np.zeros(k))
                assert w[i, j, 0] == 0.0


def _mine_build(mining_type, sample_size):
    def build(pkg):
        cl = pkg.layers.data("cl", [6])
        mi = pkg.layers.data("mi", [6], dtype="int32")
        md = pkg.layers.data("md", [6])
        helper = pkg.layer_helper.LayerHelper("mine_hard_examples")
        neg = helper.create_variable_for_type_inference(
            "float32", stop_gradient=True)
        upd = helper.create_variable_for_type_inference(
            "int32", stop_gradient=True)
        helper.append_op(
            type="mine_hard_examples",
            inputs={"ClsLoss": [cl], "MatchIndices": [mi],
                    "MatchDist": [md]},
            outputs={"NegMask": [neg], "UpdatedMatchIndices": [upd]},
            attrs={"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
                   "mining_type": mining_type, "sample_size": sample_size})
        return neg, upd
    return build


def test_mine_hard_examples_both_mining_types():
    cls_loss = np.array([[5.0, 4.0, 3.0, 2.0, 1.0, 0.5],
                         [1.0, 1.0, 2.0, 1.0, 1.0, 0.5]], "float32")
    midx = np.array([[0, -1, -1, -1, -1, -1], [-1, -1, 0, 1, -1, -1]],
                    np.int32)
    mdist = np.array([[0.0] * 6, [0.1, 0.6, 0.0, 0.0, 0.2, 0.3]], "float32")
    feed = {"cl": cls_loss, "mi": midx, "md": mdist}
    neg_ratio, _ = _both(_mine_build("max_negative", 0), feed)
    np.testing.assert_array_equal(neg_ratio[0], [0, 1, 1, 1, 0, 0])
    # ties in the loss: the lower index first, as a stable sort gives
    np.testing.assert_array_equal(neg_ratio[1], [1, 0, 0, 0, 1, 1])
    neg_hard, _ = _both(_mine_build("hard_example", 2), feed)
    np.testing.assert_array_equal(neg_hard[0], [0, 1, 1, 0, 0, 0])


# ---------------------------------------------------------------------------
# multiclass NMS and the inference head
# ---------------------------------------------------------------------------


def _np_nms(boxes, scores, score_thr, nms_thr, top_k):
    order = np.argsort(-scores, kind="stable")[:top_k]
    keep = []
    for i in order:
        if scores[i] <= score_thr:
            continue
        if all(_np_iou(boxes[i:i + 1], boxes[j:j + 1])[0, 0] <= nms_thr
               for j in keep):
            keep.append(i)
    return keep


def test_multiclass_nms_matches_numpy():
    rng = np.random.RandomState(11)
    n, c, p = 2, 3, 12
    boxes = np.stack([_rand_boxes(rng, p) for _ in range(n)])
    scores = rng.uniform(0, 1, (n, c, p)).astype("float32")

    def build(pkg):
        bv = pkg.layers.data("b", [p, 4])
        sv = pkg.layers.data("s", [c, p])
        return pkg.layers.multiclass_nms(
            bv, sv, background_label=0, score_threshold=0.3,
            nms_top_k=10, nms_threshold=0.4, keep_top_k=6)

    out, count = _both(build, {"b": boxes, "s": scores})
    assert count.dtype == np.int32
    for i in range(n):
        expected = []
        for cls in range(1, c):
            for j in _np_nms(boxes[i], scores[i, cls], 0.3, 0.4, 10):
                expected.append((cls, scores[i, cls, j], j))
        expected.sort(key=lambda t: -t[1])
        expected = expected[:6]
        assert count[i] == len(expected)
        got = out[i][out[i][:, 0] >= 0]
        for row, (cls, sc, j) in zip(got, expected):
            assert int(row[0]) == cls
            np.testing.assert_allclose(row[1], sc, rtol=1e-5)
            np.testing.assert_allclose(row[2:6], boxes[i, j], rtol=1e-5)


def test_multiclass_nms_ties_eta_pixel_boxes_and_background():
    """Tied scores (the stable sort's order), an adaptive threshold (eta
    < 1), unnormalized pixel boxes (IoU offset 1) and a background label
    in the middle of the classes."""
    rng = np.random.RandomState(12)
    n, c, p = 2, 4, 16
    boxes = np.stack([_rand_boxes(rng, p, scale=20.0) for _ in range(n)])
    boxes[:, 8:] = boxes[:, :8] + 0.5  # near duplicates
    scores = np.round(rng.uniform(0, 1, (n, c, p)), 1).astype("float32")

    def build(pkg):
        bv = pkg.layers.data("b", [p, 4])
        sv = pkg.layers.data("s", [c, p])
        return pkg.layers.multiclass_nms(
            bv, sv, background_label=2, score_threshold=0.15,
            nms_top_k=12, nms_threshold=0.7, nms_eta=0.8, keep_top_k=20,
            normalized=False)

    _both(build, {"b": boxes, "s": scores})


def test_detection_output_inference_path():
    rng = np.random.RandomState(8)
    n, p, c = 2, 6, 3
    loc = (0.05 * rng.randn(n, p, 4)).astype("float32")
    scores = rng.randn(n, p, c).astype("float32")
    priors = _rand_boxes(rng, p)
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], "float32"), (p, 1))

    def build(pkg):
        lv = pkg.layers.data("loc", [p, 4])
        sv = pkg.layers.data("sc", [p, c])
        pb = pkg.layers.data("pb", [p, 4], append_batch_size=False)
        pv = pkg.layers.data("pv", [p, 4], append_batch_size=False)
        return [pkg.layers.detection_output(
            lv, sv, pb, pv, nms_threshold=0.45, score_threshold=0.01,
            nms_top_k=6, keep_top_k=4)]

    (out,) = _both(build, {"loc": loc, "sc": scores, "pb": priors,
                           "pv": pvar})
    assert out.shape == (n, 4, 6)


# ---------------------------------------------------------------------------
# generators, coding
# ---------------------------------------------------------------------------


def test_anchor_generator_and_density_prior_box():
    def build(pkg):
        feat = pkg.layers.data("feat", [8, 2, 2], append_batch_size=True)
        feat4 = pkg.layers.data("feat4", [4, 4, 4], append_batch_size=True)
        img = pkg.layers.data("img", [3, 32, 32], append_batch_size=True)
        a, v = pkg.layers.anchor_generator(
            feat, anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0],
            variance=[0.1, 0.1, 0.2, 0.2], stride=[16.0, 16.0], offset=0.5)
        b, bv = pkg.layers.density_prior_box(
            feat4, img, densities=[2, 1], fixed_sizes=[8.0, 16.0],
            fixed_ratios=[1.0], clip=True)
        b2, bv2 = pkg.layers.density_prior_box(
            feat4, img, densities=[1], fixed_sizes=[12.0],
            fixed_ratios=[0.5, 2.0], steps=(6.0, 6.0), offset=0.25,
            flatten_to_2d=True)
        return a, v, b, bv, b2, bv2

    a, v, b, bv, b2, _ = _both(build, {
        "feat": np.zeros((1, 8, 2, 2), "float32"),
        "feat4": np.zeros((1, 4, 4, 4), "float32"),
        "img": np.zeros((1, 3, 32, 32), "float32")})
    assert a.shape == (2, 2, 4, 4) and b.shape == (4, 4, 5, 4)
    assert b2.shape == (32, 4)


def test_prior_box_and_box_coder():
    rng = np.random.RandomState(4)
    n, g = 2, 3
    gt = np.stack([_rand_boxes(rng, g) for _ in range(n)])
    loc = (0.1 * rng.randn(n, 3 * 3 * 12, 4)).astype("float32")

    def build(pkg):
        feat = pkg.layers.data("feat", [4, 3, 3])
        img = pkg.layers.data("img", [3, 30, 30])
        gv = pkg.layers.data("gt", [g, 4])
        lv = pkg.layers.data("loc", [3 * 3 * 12, 4])
        box, var = pkg.layers.prior_box(
            feat, img, [6.0, 12.0], [12.0, 20.0], aspect_ratios=[2.0, 3.0],
            flip=True, clip=True)
        box2 = pkg.layers.reshape(box, [-1, 4])
        var2 = pkg.layers.reshape(var, [-1, 4])
        iou = pkg.layers.iou_similarity(gv, box2)
        enc = pkg.layers.box_coder(box2, var2, gv)
        enc_novar = pkg.layers.box_coder(box2, None, gv)
        dec = pkg.layers.box_coder(box2, var2, lv,
                                   code_type="decode_center_size")
        box3, _ = pkg.layers.prior_box(feat, img, [8.0], steps=(10.0, 10.0),
                                       offset=0.3)
        return box, var, iou, enc, enc_novar, dec, box3

    feed = {"feat": np.zeros((n, 4, 3, 3), "float32"),
            "img": np.zeros((n, 3, 30, 30), "float32"), "gt": gt,
            "loc": loc}
    box, _, iou, enc = _both(build, feed)[:4]
    assert box.shape == (3, 3, 12, 4) and enc.shape == (n, g, 108, 4)
    np.testing.assert_allclose(iou[1], _np_iou(gt[1], box.reshape(-1, 4)),
                               rtol=1e-5, atol=1e-6)


def test_polygon_box_transform_formula():
    x = np.random.RandomState(1).randn(1, 4, 3, 3).astype("float32")

    def build(pkg):
        xv = pkg.layers.data("x", [4, 3, 3])
        return [pkg.layers.polygon_box_transform(xv)]

    (out,) = _both(build, {"x": x})
    jj = np.arange(3)[None, :]
    ii = np.arange(3)[:, None]
    for c in range(4):
        exp = (jj * 4.0 - x[0, c]) if c % 2 == 0 else (ii * 4.0 - x[0, c])
        np.testing.assert_allclose(out[0, c], exp, rtol=1e-5)


# ---------------------------------------------------------------------------
# ROI ops
# ---------------------------------------------------------------------------


def _x_grad(pkg, fetches):
    blk = pkg.default_main_program().global_block()
    loss = pkg.layers.mean(fetches[0])
    return loss, [blk.var("x")]


def test_roi_pool_and_its_gradient():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 8, 8).astype("float32")
    rois = np.array([[0, 0, 7, 7], [2, 2, 6, 6], [1, 0, 5, 3],
                     [2.4, 1.6, 9.5, 4.5]], "float32")
    batch = np.array([0, 1, 1, 0], "int32")

    def build(pkg):
        xv = pkg.layers.data("x", [3, 8, 8], stop_gradient=False)
        rv = pkg.layers.data("r", [4], append_batch_size=True)
        bv = pkg.layers.data("bi", [], dtype="int32",
                             append_batch_size=True)
        return [pkg.layers.roi_pool(xv, rv, 2, 3, 0.9, rois_batch=bv)]

    out, g = _both(build, {"x": x, "r": rois, "bi": batch},
                   grads_of=_x_grad)
    assert out.shape == (4, 3, 2, 3) and np.abs(g).sum() > 0


def test_roi_align_and_its_gradient():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 2, 8, 8).astype("float32")
    rois = np.array([[0.5, 0.5, 6.5, 6.5], [2, 2, 5, 5],
                     [1.3, 4.1, 9.0, 7.7]], "float32")
    batch = np.array([1, 0, 1], "int32")

    def build(pkg):
        xv = pkg.layers.data("x", [2, 8, 8], stop_gradient=False)
        rv = pkg.layers.data("r", [4], append_batch_size=True)
        bv = pkg.layers.data("bi", [], dtype="int32",
                             append_batch_size=True)
        return [pkg.layers.roi_align(xv, rv, 3, 3, 0.8, sampling_ratio=2,
                                     rois_batch=bv),
                pkg.layers.roi_align(xv, rv, 2, 2, 1.0)]

    out, out_default, g = _both(build, {"x": x, "r": rois, "bi": batch},
                                grads_of=_x_grad)
    assert out.shape == (3, 2, 3, 3) and out_default.shape == (3, 2, 2, 2)
    assert g.shape == x.shape and np.abs(g).sum() > 0


def test_roi_perspective_transform_identity_warp_and_gradient():
    rng = np.random.RandomState(2)
    x = rng.rand(1, 2, 8, 8).astype("float32")
    quads = np.array([[0, 0, 7, 0, 7, 7, 0, 7],
                      [1, 1, 6, 0.5, 7, 6, 0.5, 5.5]], "float32")

    def build(pkg):
        xv = pkg.layers.data("x", [2, 8, 8], stop_gradient=False)
        rv = pkg.layers.data("q", [8], append_batch_size=True)
        return [pkg.layers.roi_perspective_transform(xv, rv, 8, 8, 1.0),
                pkg.layers.roi_perspective_transform(xv, rv, 4, 5, 0.9)]

    out, _, g = _both(build, {"x": x, "q": quads}, grads_of=_x_grad)
    np.testing.assert_allclose(out[0], x[0], rtol=1e-4, atol=1e-4)
    assert g.shape == x.shape


# ---------------------------------------------------------------------------
# RPN target assignment, proposals, RoI sampling (threefry draws)
# ---------------------------------------------------------------------------


def _rpn_build(a, g, s, use_random, with_crowd=False, with_im=True,
               **kw):
    def build(pkg):
        av = pkg.layers.data("a", [a, 4], append_batch_size=False)
        gv = pkg.layers.data("g", [g, 4])
        iv = pkg.layers.data("im", [3]) if with_im else None
        cv = pkg.layers.data("crowd", [g], dtype="int32") \
            if with_crowd else None
        bp = pkg.layers.data("bp", [a, 4])
        cl = pkg.layers.data("cl", [a, 1])
        return pkg.layers.rpn_target_assign(
            bp, cl, av, None, gv, is_crowd=cv, im_info=iv,
            rpn_batch_size_per_im=s, use_random=use_random, **kw)
    return build


def _rpn_feed(rng, a, n, g):
    anchors = _rand_boxes(rng, a, scale=30.0)
    gt = np.stack([_rand_boxes(rng, g, scale=30.0) for _ in range(n)])
    gt[0, g - 1] = 0.0  # padding
    return {"a": anchors, "g": gt,
            "im": np.tile(np.array([[40.0, 40.0, 1.0]], "float32"), (n, 1)),
            "bp": rng.randn(n, a, 4).astype("float32"),
            "cl": rng.randn(n, a, 1).astype("float32")}


@pytest.mark.parametrize("use_random", [False, True],
                         ids=["scored", "threefry"])
def test_rpn_target_assign_labels_and_counts(use_random):
    rng = np.random.RandomState(21)
    a, n, g, s = 32, 2, 3, 16
    logits, locs, tlabel, tbbox, bw, lw = _both(
        _rpn_build(a, g, s, use_random, rpn_straddle_thresh=-1.0,
                   rpn_fg_fraction=0.5, rpn_positive_overlap=0.6,
                   rpn_negative_overlap=0.3), _rpn_feed(rng, a, n, g))
    n_fg = s // 2
    assert logits.shape == (n, n_fg + s, 1) and locs.shape == (n, n_fg, 4)
    for i in range(n):
        assert (lw[i] > 0).sum() == s


def test_rpn_target_assign_crowd_no_im_info_and_background_only():
    rng = np.random.RandomState(4)
    a, n, g, s = 24, 2, 3, 8
    feed = _rpn_feed(rng, a, n, g)
    feed["crowd"] = np.array([[0, 1, 0], [0, 0, 0]], "int32")
    feed["g"][1] = 0.0  # an image with no gt at all
    del feed["im"]
    outs = _both(_rpn_build(a, g, s, True, with_crowd=True, with_im=False),
                 feed)
    tlabel, lw = outs[2], outs[5]
    assert (lw[1] > 0).sum() == s and (tlabel[1][lw[1] > 0] == 0).all()


def _proposals_build(a, h, w, **kw):
    def build(pkg):
        sv = pkg.layers.data("s", [a, h, w])
        dv = pkg.layers.data("d", [a * 4, h, w])
        iv = pkg.layers.data("im", [3])
        feat = pkg.layers.data("feat", [8, h, w])
        anchors, variances = pkg.layers.anchor_generator(
            feat, anchor_sizes=[8.0], aspect_ratios=[0.5, 1.0, 2.0],
            stride=[8.0, 8.0])
        return pkg.layers.generate_proposals(sv, dv, iv, anchors, variances,
                                             **kw)
    return build


@pytest.mark.parametrize("eta", [1.0, 0.9])
def test_generate_proposals_runs_and_clips(eta):
    rng = np.random.RandomState(2)
    n, a, h, w = 2, 3, 4, 4
    feed = {"s": rng.uniform(0, 1, (n, a, h, w)).astype("float32"),
            "d": (0.1 * rng.randn(n, a * 4, h, w)).astype("float32"),
            "im": np.array([[32.0, 32.0, 1.0], [28.0, 30.0, 2.0]],
                           "float32"),
            "feat": np.zeros((n, 8, h, w), "float32")}
    feed["s"][1, :, :2] = 0.5  # tied scores
    rois, probs, count = _both(
        _proposals_build(a, h, w, pre_nms_top_n=24, post_nms_top_n=8,
                         nms_thresh=0.7, min_size=1.0, eta=eta), feed)
    assert count.dtype == np.int32 and (count > 0).all()
    k = count[0]
    assert (rois[0, :k, 0::2] >= 0).all() and (rois[0, :k, 0::2] <= 31).all()
    assert (np.diff(probs[0, :k]) <= 1e-6).all()


def _labels_build(r, g, bs, use_random, crowd=False, im=False):
    def build(pkg):
        rv = pkg.layers.data("r", [r, 4], append_batch_size=False)
        cv = pkg.layers.data("c", [g], dtype="int32")
        gv = pkg.layers.data("g", [g, 4])
        ic = pkg.layers.data("ic", [g], dtype="int32") if crowd else None
        iv = pkg.layers.data("im", [3]) if im else None
        return pkg.layers.generate_proposal_labels(
            rv, cv, ic, gv, im_info=iv, batch_size_per_im=bs,
            fg_fraction=0.25, class_nums=3, use_random=use_random)
    return build


@pytest.mark.parametrize("use_random", [False, True],
                         ids=["scored", "threefry"])
def test_generate_proposal_labels_sampling(use_random):
    rng = np.random.RandomState(13)
    r, g, bs = 20, 3, 8
    gt = np.stack([_rand_boxes(rng, g, scale=30.0) for _ in range(2)])
    gt[0, 2] = 0.0  # padding
    rois = np.concatenate([
        gt[0, :2] + 0.8 * rng.randn(2, 4).astype("float32"),
        _rand_boxes(rng, r - 2, scale=30.0)])
    feed = {"r": rois, "c": np.array([[1, 2, -1], [2, 1, 1]], "int32"),
            "g": gt, "im": np.array([[40, 40, 1.0], [40, 40, 0.5]],
                                    "float32")}
    rois_o, labels, targets, inw, _, rw = _both(
        _labels_build(r, g, bs, use_random, im=True), feed)
    assert rois_o.shape == (2, 2 + bs, 4) and targets.shape == (2, 10, 12)
    assert labels.dtype == np.int32


def test_generate_proposal_labels_small_pool_and_crowd():
    rng = np.random.RandomState(17)
    r, g, bs = 3, 2, 8
    gt = np.stack([_rand_boxes(rng, g, scale=30.0)])
    rois = gt[0] + 0.5 * rng.randn(g, 4).astype("float32")
    rois = np.concatenate([rois, _rand_boxes(rng, r - g, scale=30.0)])
    feed = {"r": rois, "c": np.array([[1, 2]], "int32"), "g": gt,
            "ic": np.array([[0, 1]], "int32")}
    _, labels, _, _, _, rw = _both(_labels_build(r, g, bs, False,
                                                 crowd=True), feed)
    assert 2 not in set(labels[0][rw[0] > 0].tolist())


# ---------------------------------------------------------------------------
# detection_map
# ---------------------------------------------------------------------------


def _map_build(d, g, class_num, difficult=False, **kw):
    def build(pkg):
        dv = pkg.layers.data("d", [d, 6])
        lv = pkg.layers.data("l", [g], dtype="int32")
        bv = pkg.layers.data("b", [g, 4])
        fv = pkg.layers.data("f", [g]) if difficult else None
        return [pkg.layers.detection_map(dv, lv, bv, gt_difficult=fv,
                                         class_num=class_num, **kw)]
    return build


def test_detection_map_ignores_difficult_when_not_evaluated():
    det = np.zeros((1, 2, 6), "float32")
    det[0, 0] = [1, 0.9, 0.5, 0.5, 0.8, 0.8]  # on the difficult gt
    det[0, 1] = [1, 0.8, 0.1, 0.1, 0.4, 0.4]  # on the normal gt
    gt_box = np.zeros((1, 2, 4), "float32")
    gt_box[0, 0] = [0.1, 0.1, 0.4, 0.4]
    gt_box[0, 1] = [0.5, 0.5, 0.8, 0.8]
    (m,) = _both(_map_build(2, 2, 2, difficult=True,
                            evaluate_difficult=False),
                 {"d": det, "l": np.array([[1, 1]], "int32"), "b": gt_box,
                  "f": np.array([[0.0, 1.0]], "float32")})
    np.testing.assert_allclose(m, 1.0, atol=1e-5)


def test_detection_map_perfect_and_mixed():
    det = np.zeros((1, 3, 6), "float32")
    det[0, 0] = [1, 0.9, 0.1, 0.1, 0.4, 0.4]
    det[0, 1] = [1, 0.5, 0.6, 0.6, 0.9, 0.9]
    det[0, 2] = [-1, 0, 0, 0, 0, 0]
    gt_box = np.zeros((1, 2, 4), "float32")
    gt_box[0, 0] = [0.1, 0.1, 0.4, 0.4]
    (m,) = _both(_map_build(3, 2, 2, overlap_threshold=0.5),
                 {"d": det, "l": np.array([[1, -1]], "int32"), "b": gt_box})
    np.testing.assert_allclose(m, 1.0, atol=1e-5)


def _map_inputs(seed, n=3, d=8, g=4, classes=4):
    """Detections near the gts, with duplicates, misses, ties across
    images and padding."""
    rng = np.random.RandomState(seed)
    gt_box = np.stack([_rand_boxes(rng, g) for _ in range(n)])
    gt_label = rng.randint(1, classes, (n, g)).astype("int32")
    gt_label[0, -1] = -1
    det = np.zeros((n, d, 6), "float32")
    for i in range(n):
        for j in range(d):
            src = rng.randint(g)
            det[i, j, 0] = gt_label[i, src] if rng.rand() < 0.8 else \
                rng.randint(1, classes)
            det[i, j, 2:] = gt_box[i, src] + 0.03 * rng.randn(4)
    det[:, :, 1] = np.round(rng.uniform(0.1, 1.0, (n, d)), 1)
    det[1, -2:, 0] = -1  # padding rows
    difficult = (rng.rand(n, g) < 0.3).astype("float32")
    return det, gt_label, gt_box, difficult


@pytest.mark.parametrize("ap_version,eval_diff", [
    ("integral", True), ("integral", False), ("11point", True),
    ("11point", False)])
def test_detection_map_several_images_classes_and_ties(ap_version,
                                                       eval_diff):
    det, lab, box, diff = _map_inputs(5)
    _both(_map_build(8, 4, 4, difficult=True, ap_version=ap_version,
                     evaluate_difficult=eval_diff, overlap_threshold=0.6),
          {"d": det, "l": lab, "b": box, "f": diff})


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX package's loops
# ---------------------------------------------------------------------------


def test_greedy_nms_plain_matches_the_jax_loop_with_eta_and_ties():
    """``greedy_nms_plain`` (the kernel's oracle on the card) against
    ``_nms_single_class`` (vmapped over the rows): tied scores, near-duplicate
    boxes, eta 0.9 (the threshold shrinks from 0.75), both IoU offsets."""
    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import detection_ops as j_det
    from paddle_tpu_torch.kernels import detection as kdet

    rng = np.random.RandomState(3)
    b, p, k = 6, 40, 30
    boxes = np.stack([_rand_boxes(rng, p, scale=10.0) for _ in range(b)])
    boxes[:, 20:] = boxes[:, :20] + rng.uniform(-0.3, 0.3, (b, 20, 4))
    scores = np.round(rng.uniform(0, 1, (b, p)), 1).astype("float32")
    for normalized in (True, False):
        nms_rows = jax.jit(jax.vmap(lambda bx, sc: j_det._nms_single_class(
            bx, sc, 0.2, 0.75, 0.9, k, normalized)))
        keep, jcand = nms_rows(jnp.asarray(boxes.astype("float32")),
                               jnp.asarray(scores))
        cand = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        sb = np.take_along_axis(boxes, cand[..., None], 1)
        ss = np.take_along_axis(scores, cand, 1)
        got = kdet.greedy_nms_plain(
            torch.from_numpy(sb.astype("float32")),
            torch.from_numpy(ss > 0.2), 0.75, 0.9,
            0.0 if normalized else 1.0).numpy()
        np.testing.assert_array_equal(np.asarray(jcand), cand)
        np.testing.assert_array_equal(got, np.asarray(keep))
        assert got.any() and not got.all()


def test_det_match_plain_matches_the_jax_loop():
    """``det_match_plain`` against the true and false positives that
    ``detection_map``'s lowering computes in its ``fori_loop`` (read
    from the loop's result), on tied scores across images, with and
    without difficult ground truth."""
    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu.ops import detection_ops as j_det
    from paddle_tpu_torch.kernels import detection as kdet

    seen = []

    def fori_loop(lo, hi, body, init):
        out = jax.lax.fori_loop(lo, hi, body, init)
        seen.append(out)
        return out

    def loop_result(det, lab, box, diff, eval_diff):
        seen.clear()
        j_det._lower_detection_map(
            None, {"DetectRes": [det], "GtLabel": [lab], "GtBox": [box],
                   "GtDifficult": [diff]},
            {"overlap_threshold": 0.5, "evaluate_difficult": eval_diff,
             "class_num": 3})
        (_, tp, fp), = seen
        return tp, fp

    det, lab, box, diff = _map_inputs(9, n=4, d=10, g=5, classes=3)
    orig = j_det.lax
    j_det.lax = types.SimpleNamespace(fori_loop=fori_loop)
    try:
        results = [jax.jit(loop_result, static_argnums=4)(
            det, lab, box, diff, eval_diff) for eval_diff in (True, False)]
    finally:
        j_det.lax = orig
    for eval_diff, (want_tp, want_fp) in zip((True, False), results):
        flat = np.where(det[:, :, 0] >= 0, det[:, :, 1], -np.inf).reshape(-1)
        order = np.argsort(-flat, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        tp, fp = kdet.det_match_plain(
            torch.from_numpy(det), torch.from_numpy(rank.reshape(4, 10)),
            torch.from_numpy(lab), torch.from_numpy(box),
            torch.from_numpy(diff > 0), 0.5, eval_diff)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(want_tp))
        np.testing.assert_array_equal(fp.numpy(), np.asarray(want_fp))
        assert tp.numpy().any() and fp.numpy().any()
