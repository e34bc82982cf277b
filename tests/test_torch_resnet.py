"""batch_norm and ResNet through the port against the JAX package and
the goldens, on the CPU.

- ``tests/golden/resnet_cifar10.npz`` (the JAX package's
  ``resnet_cifar10`` depth 20 predictions with deterministic weights)
  reproduced, rtol 1e-5, atol 1e-6;
- ``batch_norm``: forward (Y and the moving statistics) and the
  gradients of X, Scale and Bias, in training, ``is_test`` and
  ``use_global_stats``, NCHW and NHWC, against the JAX package, 1e-5;
- ``resnet_cifar10`` depth 20 trained 3 ``Momentum`` steps from the JAX
  package's initial state: losses within 1e-5, every moving mean within
  1e-5;
- a saved ResNet served through ``AnalysisConfig`` (``fuse_batch_norm``
  folds every batch norm into its conv) equal to ``NativeConfig`` and to
  the JAX package's ``AnalysisConfig``, 1e-5; a conv with a bias add
  folds through the bias branch.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import resnet as j_resnet
from paddle_tpu.testing import set_deterministic_params as j_set_params
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.inference import (
    AnalysisConfig,
    NativeConfig,
    create_paddle_predictor,
)
from paddle_tpu_torch.models import resnet as t_resnet
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "resnet_cifar10.npz")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def test_port_reproduces_the_resnet_cifar10_golden():
    """As build_golden does: program seeds 11, deterministic parameters
    by name (moving variances positive), the test clone."""
    golden = np.load(GOLDEN)
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 11
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        _, _, outs = t_resnet.build(img_shape=(3, 32, 32), class_num=10,
                                    variant="cifar10", depth=20)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    feed = {"pixel": golden["feed_pixel"],
            "label": np.zeros((golden["feed_pixel"].shape[0], 1), "int64")}
    (out,) = exe.run(main.clone(for_test=True), feed=feed,
                     fetch_list=[outs["predict"]], scope=scope)
    np.testing.assert_allclose(out, golden["expected"], rtol=1e-5,
                               atol=1e-6)


def _bn_run(pkg, unique_name, xs, layout, is_test, global_stats):
    """batch_norm over ``xs``, a seeded weight on Y, gradients of X,
    Scale and Bias; returns [Y, MeanOut, VarianceOut, dX, dScale,
    dBias]."""
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=list(xs.shape[1:]),
                            stop_gradient=False)
        w = pkg.layers.data("w", shape=list(xs.shape[1:]))
        y = pkg.layers.batch_norm(x, data_layout=layout, is_test=is_test,
                                  momentum=0.8, epsilon=1e-3,
                                  use_global_stats=global_stats)
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(y, w))
        params = main.global_block().all_parameters()
        grads = pkg.backward.calc_gradient(loss, [x] + sorted(
            params, key=lambda p: p.name))
        bn = [op for op in main.global_block().ops
              if op.type == "batch_norm"][0]
    exe = pkg.Executor(pkg.CPUPlace())
    scope = JScope() if pkg is jfluid else tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(4)
    c = xs.shape[1] if layout == "NCHW" else xs.shape[-1]
    scope.set_value(bn.input("Mean")[0],
                    (0.1 * rng.randn(c)).astype("float32"))
    scope.set_value(bn.input("Variance")[0],
                    (0.5 + rng.rand(c)).astype("float32"))
    feed = {"x": xs, "w": rng.randn(*xs.shape).astype("float32")}
    fetch = [y, bn.output("MeanOut")[0], bn.output("VarianceOut")[0]]
    return [np.asarray(v) for v in exe.run(
        main, feed=feed, scope=scope, fetch_list=fetch + grads)]


BN_CASES = [("NCHW", False, False), ("NHWC", False, False),
            ("NCHW", True, False), ("NHWC", True, False),
            ("NCHW", False, True)]


@pytest.mark.parametrize("layout,is_test,global_stats", BN_CASES, ids=[
    "nchw_train", "nhwc_train", "nchw_test", "nhwc_test",
    "nchw_global_stats"])
def test_batch_norm_matches_jax(layout, is_test, global_stats):
    shape = (4, 3, 5, 6) if layout == "NCHW" else (4, 5, 6, 3)
    xs = (2.0 + 3.0 * np.random.RandomState(0).randn(*shape)).astype(
        "float32")
    want = _bn_run(jfluid, j_unique_name, xs, layout, is_test,
                   global_stats)
    got = _bn_run(tfluid, t_unique_name, xs, layout, is_test, global_stats)
    assert len(got) == len(want) == 6
    for name, g, w in zip(["Y", "MeanOut", "VarianceOut", "dX", "dScale",
                           "dBias"], got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


def _cifar_train(pkg, unique_name, state, feed, steps=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard({}), pkg.program_guard(main, startup):
        rm = t_resnet if pkg is tfluid else j_resnet
        loss, _, _ = rm.build(img_shape=(3, 32, 32), class_num=10,
                              variant="cifar10", depth=20)
        pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is jfluid:
        scope = JScope()
        exe.run(startup, scope=scope)
        j_set_params(main, scope)
        state = {v.name: np.asarray(scope.get_value(v.name))
                 for v in main.global_block().vars.values()
                 if v.persistable and scope.get_value(v.name) is not None}
    else:
        scope = tfluid.Scope()
        persistables_from_numpy(main, scope, state, "cpu")
    losses = [float(np.asarray(exe.run(main, feed=feed, scope=scope,
                                       fetch_list=[loss])[0]).reshape(-1)[0])
              for _ in range(steps)]
    means = {op.output("MeanOut")[0]: np.asarray(
        scope.get_value(op.output("MeanOut")[0]))
        for op in main.global_block().ops if op.type == "batch_norm"}
    return losses, means, state


def test_resnet_cifar10_momentum_steps_match_jax():
    rng = np.random.RandomState(6)
    feed = {"pixel": rng.rand(4, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    jl, jm, state = _cifar_train(jfluid, j_unique_name, None, feed)
    tl, tm, _ = _cifar_train(tfluid, t_unique_name, state, feed)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert len(tm) == len(jm) == 21
    for name in jm:
        np.testing.assert_allclose(tm[name], jm[name], rtol=TOL, atol=TOL,
                                   err_msg=name)
        assert not np.allclose(tm[name], state[name])


def _conv_bias_bn(pkg):
    """conv2d with a bias, then batch_norm: the fold's bias branch."""
    img = pkg.layers.data("pixel", shape=[3, 8, 8])
    conv = pkg.layers.conv2d(img, num_filters=4, filter_size=3, padding=1)
    bn = pkg.layers.batch_norm(conv, act="relu")
    return pkg.layers.fc(bn, size=5, act="softmax")


def _resnet_predict(pkg):
    rm = t_resnet if pkg is tfluid else j_resnet
    _, _, outs = rm.build(img_shape=(3, 16, 16), class_num=10,
                          variant="cifar10", depth=8)
    return outs["predict"]


@pytest.mark.parametrize("net", [_resnet_predict, _conv_bias_bn],
                         ids=["resnet_cifar10", "conv_bias_bn"])
def test_saved_resnet_folds_under_analysis_config(net, tmp_path):
    from paddle_tpu.inference import AnalysisConfig as JAnalysisConfig
    from paddle_tpu.inference import create_paddle_predictor as j_create

    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        predict = net(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    path = str(tmp_path)
    tfluid.io.save_inference_model(path, ["pixel"], [predict], exe,
                                   main_program=main, scope=scope)
    shape = [int(d) for d in main.global_block().var("pixel").shape[1:]]
    feed = {"pixel": np.random.RandomState(7).rand(2, *shape).astype(
        "float32")}
    native = create_paddle_predictor(NativeConfig(path, use_tpu=False))
    folded = create_paddle_predictor(AnalysisConfig(path, use_tpu=False))
    (want,) = native.run(feed)
    (got,) = folded.run(feed)
    types = [op.type for op in folded._program.global_block().ops]
    assert "batch_norm" not in types and "conv2d" in types
    assert "batch_norm" in [op.type
                            for op in native._program.global_block().ops]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    (jax_folded,) = j_create(JAnalysisConfig(model_dir=path,
                                             use_tpu=False)).run(feed)
    np.testing.assert_allclose(got, np.asarray(jax_folded), rtol=TOL,
                               atol=TOL)
