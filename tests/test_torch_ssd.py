"""SSD on the port, on the CPU, against the JAX package:

- the ``ssd`` entry of ``tests/golden/`` (the dense location head of the
  pruned test clone, as ``tests/golden_models.py`` builds it: seeds 11,
  deterministic parameters by name), rtol 1e-5, atol 1e-6;
- ``models/ssd.py`` at ``tests/test_detection.py``'s size (64 x 64, 3
  classes, max_gt 2) trained 3 ``Adam`` steps from the JAX package's
  initial state (``convert.persistables_from_numpy``): losses within
  1e-5; then the eval head on the test clone: ``nmsed_out`` (labels,
  counts and rows) and the batch mAP equal to the JAX package's;
- the multibox loss of ``test_detection.py``'s synthetic-box case
  trained 3 steps the same way, and the model trained 12 steps on the
  port alone: the loss falls and no grad op reruns its forward.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.io import prune_program
from paddle_tpu_torch.models import ssd
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def test_port_reproduces_the_ssd_golden():
    golden = np.load(os.path.join(GOLDEN, "ssd.npz"))
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 11
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        _, _, outs = ssd.build(img_shape=(3, 96, 96), class_num=4)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    pruned = prune_program(main.clone(for_test=True), ["image"],
                           [outs["mbox_locs"].name])
    (out,) = exe.run(pruned, feed={"image": golden["feed_image"]},
                     fetch_list=[outs["mbox_locs"].name], scope=scope)
    np.testing.assert_allclose(out, golden["expected"], rtol=1e-5,
                               atol=1e-6)


def _ssd_model(pkg):
    from paddle_tpu.models import ssd as j_ssd

    m = ssd if pkg is tfluid else j_ssd
    loss, _, extras = m.build(img_shape=(3, 64, 64), class_num=3, max_gt=2,
                              nms_keep_top_k=10)
    return loss, extras


def _box_batch(rng, n, g, classes, size):
    xy = rng.uniform(0, 0.6, (n, g, 2))
    wh = rng.uniform(0.15, 0.35, (n, g, 2))
    return {"image": rng.rand(n, 3, size, size).astype("float32"),
            "gt_box": np.concatenate([xy, xy + wh], -1).astype("float32"),
            "gt_label": rng.randint(1, classes, (n, g)).astype("int32")}


def _multibox_loss(pkg):
    """``test_detection.py``'s synthetic-box multibox loss."""
    img = pkg.layers.data("image", [3, 32, 32], stop_gradient=False)
    gt_box = pkg.layers.data("gt_box", [2, 4])
    gt_label = pkg.layers.data("gt_label", [2], dtype="int32")
    c1 = pkg.layers.conv2d(img, 8, 3, stride=2, padding=1, act="relu")
    c2 = pkg.layers.conv2d(c1, 8, 3, stride=2, padding=1, act="relu")
    c3 = pkg.layers.conv2d(c2, 8, 3, stride=2, padding=1, act="relu")
    loc, conf, boxes, variances = pkg.layers.multi_box_head(
        inputs=[c2, c3], image=img, base_size=32, num_classes=3,
        aspect_ratios=[[1.0], [1.0]], min_sizes=[8.0, 16.0],
        max_sizes=[16.0, 24.0], flip=False)
    loss = pkg.layers.ssd_loss(loc, conf, gt_box, gt_label, boxes,
                               variances)
    return pkg.layers.mean(loss), {}


def _train_from_jax(build, lr, feeds, eval_feed=None):
    """3 ``Adam`` steps of ``build(pkg)``'s loss in both packages, the
    port from the JAX package's initial persistables; with ``eval_feed``
    also the eval head on the test clone. Returns each package's
    (losses, eval outputs) and the port's executor."""
    res = []
    state = None
    for pkg, un in ((jfluid, j_unique_name), (tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with un.guard({}), pkg.program_guard(main, startup):
            loss, extras = build(pkg)
            test_prog = main.clone(for_test=True)
            pkg.optimizer.Adam(lr).minimize(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = JScope() if pkg is jfluid else tfluid.Scope()
        exe.run(startup, scope=scope)
        if pkg is jfluid:
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            persistables_from_numpy(main, scope, state, "cpu")
        losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0])[0])
                  for f in feeds]
        evals = None
        if eval_feed is not None:
            evals = [np.asarray(v) for v in exe.run(
                test_prog, feed=eval_feed, scope=scope,
                fetch_list=[extras["nmsed_out"], extras["map_eval"]])]
        res.append((losses, evals))
    return res, exe


def test_ssd_trains_from_the_jax_state_and_evals_equal():
    rng = np.random.RandomState(0)
    feeds = [_box_batch(rng, 4, 2, 3, 64) for _ in range(3)]
    (j, t), exe = _train_from_jax(_ssd_model, 3e-3, feeds,
                                  _box_batch(rng, 4, 2, 3, 64))
    np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)
    (j_out, j_map), (t_out, t_map) = j[1], t[1]
    assert t_out.shape == j_out.shape == (4, 10, 6)
    np.testing.assert_array_equal(t_out[:, :, 0], j_out[:, :, 0])
    np.testing.assert_allclose(t_out, j_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_map, j_map, rtol=TOL, atol=TOL)
    assert 0.0 <= float(t_map) <= 1.0
    assert exe.grad_op_reruns == 0


def test_multibox_loss_trains_from_the_jax_state():
    rng = np.random.RandomState(42)
    feeds = [_box_batch(rng, 4, 2, 3, 32) for _ in range(3)]
    (j, t), exe = _train_from_jax(_multibox_loss, 5e-3, feeds)
    np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL)
    assert exe.grad_op_reruns == 0


def test_ssd_model_trains_and_evals_on_the_port():
    """``test_detection.py``'s model-zoo case on the port alone: the
    loss falls over 12 steps and the eval head runs on the test clone."""
    rng = np.random.RandomState(0)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        loss, _, extras = ssd.build(img_shape=(3, 64, 64), class_num=3,
                                    max_gt=2, nms_keep_top_k=10)
        test_prog = main.clone(for_test=True)
        tfluid.optimizer.Adam(3e-3).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    losses = [float(np.ravel(exe.run(main, feed=_box_batch(rng, 4, 2, 3, 64),
                                     fetch_list=[loss])[0])[0])
              for _ in range(12)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert exe.grad_op_reruns == 0
    out, m = exe.run(test_prog, feed=_box_batch(rng, 4, 2, 3, 64),
                     fetch_list=[extras["nmsed_out"], extras["map_eval"]])
    assert np.asarray(out).shape == (4, 10, 6)
    assert 0.0 <= float(np.ravel(np.asarray(m))[0]) <= 1.0
