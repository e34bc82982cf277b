"""The conv model zoo and the Switch Transformer of the port, on the CPU:
``tests/test_models_conv.py``'s cases and the goldens.

- the ``vgg16``, ``googlenet``, ``se_resnext50``, ``alexnet`` and
  ``switch_transformer`` entries of ``tests/golden/`` reproduced as
  ``tests/golden_models.py`` builds them (program seeds 11, deterministic
  parameters by name, the test clone), rtol 1e-5, atol 1e-6;
- VGG-16, SE-ResNeXt-50 and GoogLeNet take finite steps and AlexNet
  converges on tiny synthetic data (``Adam``); ResNet-50 builds;
- AlexNet (LRN, grouped convs, dropout drawn from jax's threefry stream)
  and the Switch Transformer (``moe_ffn`` top-2 in every layer, dropout,
  a padded batch) trained 3 steps from the JAX package's initial state:
  the losses within 1e-5.
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
from paddle_tpu_torch.models import (
    alexnet,
    googlenet,
    resnet,
    se_resnext,
    switch_transformer,
    vgg,
)
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params

fluid = tfluid
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


# tests/golden_models.py's entries: builder, the fetched output
GOLDENS = {
    "vgg16": (lambda: vgg.build(img_shape=(3, 32, 32), class_num=10),
              "predict"),
    "googlenet": (lambda: googlenet.build(img_shape=(3, 96, 96),
                                          class_num=10), "predict"),
    "se_resnext50": (lambda: se_resnext.build(img_shape=(3, 64, 64),
                                              class_num=10), "predict"),
    "alexnet": (lambda: alexnet.build(img_shape=(3, 224, 224),
                                      class_num=10), "predict"),
    "switch_transformer": (lambda: switch_transformer.build(
        vocab_size=80, max_length=12, n_layer=2, n_head=2, d_model=32,
        d_inner=64, num_experts=2, moe_every=2, dropout=0.0), "logits"),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_port_reproduces_the_golden(name):
    golden = np.load(os.path.join(GOLDEN, name + ".npz"))
    build, key = GOLDENS[name]
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 11
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        _, feeds, outs = build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    feed = {k[len("feed_"):]: golden[k] for k in golden.files
            if k.startswith("feed_")}
    # the label the test clone's loss reads (not the golden's fetch)
    n = next(iter(feed.values())).shape[0]
    for f in feeds:
        feed.setdefault(f.name, np.zeros((n, 1), "int64"))
    (out,) = exe.run(main.clone(for_test=True), feed=feed,
                     fetch_list=[outs[key]], scope=scope)
    np.testing.assert_allclose(out, golden["expected"], rtol=1e-5,
                               atol=1e-6)


def _synthetic_images(n, shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n).astype("int64")
    base = rng.randn(classes, *shape).astype("float32")
    x = base[labels] + 0.25 * rng.randn(n, *shape).astype("float32")
    return x, labels.reshape(-1, 1)


def _train(build_fn, kwargs, n=64, bs=16, steps=25, lr=0.001, classes=4):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, feeds, extras = build_fn(**kwargs)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    shape = tuple(int(d) for d in feeds[0].shape[1:])
    x, y = _synthetic_images(n, shape, classes)
    losses = []
    for step in range(steps):
        i = (step * bs) % n
        (lv,) = exe.run(main, feed={feeds[0].name: x[i:i + bs],
                                    feeds[1].name: y[i:i + bs]},
                        fetch_list=[loss])
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
        assert np.isfinite(losses[-1]), "loss diverged at step %d" % step
    assert exe.grad_op_reruns == 0
    return losses


@pytest.mark.parametrize("build_fn,kwargs", [
    (vgg.build, {"img_shape": (3, 32, 32), "class_num": 4}),
    (se_resnext.build, {"img_shape": (3, 32, 32), "class_num": 4,
                        "depth": 50}),
    (googlenet.build, {"img_shape": (3, 64, 64), "class_num": 4}),
], ids=["vgg16", "se_resnext50", "googlenet"])
def test_model_builds_and_steps(build_fn, kwargs):
    losses = _train(build_fn, kwargs, n=8, bs=4, steps=3)
    assert all(np.isfinite(losses))


def test_alexnet_converges():
    losses = _train(alexnet.build, {"img_shape": (3, 63, 63),
                                    "class_num": 4}, n=32, bs=8, steps=20)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_resnet50_imagenet_builds():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss, feeds, extras = resnet.build(img_shape=(3, 64, 64),
                                           class_num=10, depth=50)
        fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    assert len(main.global_block().all_parameters()) > 100
    assert loss.shape == (1,)


def _train_from_jax(pkg, unique_name, build, feed, state, steps=3):
    """``steps`` Momentum steps of ``build``'s loss; the JAX package's
    run starts from its startup program and hands its persistables to
    the port's, which runs its own startup program first, so both
    executors draw the dropout masks of the same run count. Returns
    (losses, state)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard({}), pkg.program_guard(main, startup):
        loss = build(pkg)
        pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9).minimize(
            loss)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = JScope() if pkg is jfluid else tfluid.Scope()
    exe.run(startup, scope=scope)
    if pkg is jfluid:
        state = {v.name: np.asarray(scope.get_value(v.name))
                 for v in main.global_block().vars.values()
                 if v.persistable and scope.get_value(v.name) is not None}
    else:
        persistables_from_numpy(main, scope, state, "cpu")
    losses = [float(np.asarray(exe.run(main, feed=feed, scope=scope,
                                       fetch_list=[loss])[0]).reshape(-1)[0])
              for _ in range(steps)]
    return losses, state


def _alexnet_loss(pkg):
    from paddle_tpu.models import alexnet as j_alexnet

    m = alexnet if pkg is tfluid else j_alexnet
    return m.build(img_shape=(3, 63, 63), class_num=5)[0]


def _switch_loss(pkg):
    from paddle_tpu.models import switch_transformer as j_switch

    m = switch_transformer if pkg is tfluid else j_switch
    return m.build(vocab_size=50, max_length=10, n_layer=2, n_head=2,
                   d_model=16, d_inner=32, num_experts=4, top_k=2,
                   moe_every=1, dropout=0.1)[0]


def _alexnet_feed(rng):
    return {"pixel": rng.rand(4, 3, 63, 63).astype("float32"),
            "label": rng.randint(0, 5, (4, 1)).astype("int64")}


def _switch_feed(rng):
    return {"word": rng.randint(1, 50, (4, 10)).astype("int64"),
            "seq_len": np.array([[10], [7], [3], [10]], "int64"),
            "label": rng.randint(0, 2, (4, 1)).astype("int64")}


@pytest.mark.parametrize("build,make_feed", [
    (_alexnet_loss, _alexnet_feed), (_switch_loss, _switch_feed)],
    ids=["alexnet", "switch_transformer"])
def test_momentum_steps_match_jax(build, make_feed):
    feed = make_feed(np.random.RandomState(7))
    jl, state = _train_from_jax(jfluid, j_unique_name, build, feed, None)
    tl, _ = _train_from_jax(tfluid, t_unique_name, build, feed, state)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert jl[-1] != jl[0]
