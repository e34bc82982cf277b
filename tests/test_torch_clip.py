"""Gradient clipping and weight decay through the port against the JAX
package, on the CPU.

- each clip class (``GradientClipByValue``, ``GradientClipByNorm``,
  ``GradientClipByGlobalNorm``, two global-norm groups) set with
  ``set_gradient_clip`` or a ``ParamAttr``, and ``L1Decay`` / ``L2Decay``
  given to the optimizer or per parameter, on ``test_torch_train.py``'s
  MLP: the program's op types equal the JAX package's, 5 SGD steps'
  losses within 1e-5;
- the ``clip`` op's gradient at its bounds is 0.5, the JAX package's
  (``jnp.clip`` is ``minimum(maximum(x, lo), hi)``; ``torch.clamp`` would
  give 1), and ``elementwise_max`` / ``elementwise_min`` split a tie 0.5 /
  0.5 as ``jnp.maximum`` does.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state
from test_torch_train import MLP_TOL, _mlp, _train_both


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _feed():
    rng = np.random.RandomState(3)
    # a large input scale, so every clip and the decay terms bind
    return {"x": 4.0 * rng.randn(8, 16).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}


def _clipped(make_clip, params=None):
    def net(pkg):
        loss = _mlp(pkg)
        pkg.clip.set_gradient_clip(make_clip(pkg), param_list=params)
        return loss

    return net


def _two_groups(pkg):
    loss = _mlp(pkg)
    pkg.clip.set_gradient_clip(
        pkg.clip.GradientClipByGlobalNorm(0.5, group_name="a"),
        param_list=["fc_0.w_0", "fc_0.w_1"])
    pkg.clip.set_gradient_clip(
        pkg.clip.GradientClipByGlobalNorm(2.0, group_name="b"),
        param_list=["fc_1.w_0", "fc_1.w_1"])
    return loss


def _per_param_decay(pkg):
    """fc with a per-parameter L1Decay on the first weight and L2Decay on
    the second, beside the optimizer's own regularizer."""
    x = pkg.layers.data("x", shape=[16])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    h = pkg.layers.fc(input=x, size=32, act="relu", param_attr=pkg.ParamAttr(
        regularizer=pkg.regularizer.L1Decay(0.05)))
    logits = pkg.layers.fc(input=h, size=10, param_attr=pkg.ParamAttr(
        regularizer=pkg.regularizer.L2Decay(0.1),
        gradient_clip=pkg.clip.GradientClipByValue(0.2)))
    return pkg.layers.reduce_sum(
        pkg.layers.softmax_with_cross_entropy(logits, label))


def _sgd(regularization=None):
    def make(pkg):
        reg = None if regularization is None else regularization(pkg)
        return pkg.optimizer.SGD(learning_rate=0.01, regularization=reg)

    return make


CASES = [
    ("by_value", _clipped(lambda f: f.clip.GradientClipByValue(0.1)),
     _sgd(), "clip"),
    ("by_value_min", _clipped(
        lambda f: f.clip.GradientClipByValue(0.3, min=-0.05)), _sgd(),
     "clip"),
    ("by_norm", _clipped(lambda f: f.clip.GradientClipByNorm(0.5)), _sgd(),
     "clip_by_norm"),
    ("by_global_norm", _clipped(
        lambda f: f.clip.GradientClipByGlobalNorm(1.0)), _sgd(),
     "elementwise_max"),
    ("by_global_norm_some", _clipped(
        lambda f: f.clip.GradientClipByGlobalNorm(0.5),
        params=["fc_1.w_0"]), _sgd(), "elementwise_max"),
    ("global_norm_two_groups", _two_groups, _sgd(), "sqrt"),
    ("l2_decay", _mlp, _sgd(lambda f: f.regularizer.L2Decay(0.1)), "scale"),
    ("l1_decay", _mlp, _sgd(lambda f: f.regularizer.L1Decay(0.05)), "sign"),
    ("per_param", _per_param_decay,
     _sgd(lambda f: f.regularizer.L2Decay(0.01)), "sign"),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_clip_and_decay_train_like_jax(case):
    name, net, make_opt, op_type = case
    res = _train_both(net, make_opt, _feed(), 5, fetch_grads=False)
    (jl, _, jm), (tl, _, tm) = res["jax"], res["torch"]
    types = [op.type for op in tm.global_block().ops]
    assert types == [op.type for op in jm.global_block().ops]
    assert op_type in types
    np.testing.assert_allclose(tl, jl, rtol=MLP_TOL, atol=MLP_TOL)


def test_global_norm_group_must_agree():
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        loss = _mlp(tfluid)
        tfluid.clip.set_gradient_clip(
            tfluid.clip.GradientClipByGlobalNorm(1.0),
            param_list=["fc_0.w_0"])
        tfluid.clip.set_gradient_clip(
            tfluid.clip.GradientClipByGlobalNorm(2.0),
            param_list=["fc_1.w_0"])
        with pytest.raises(ValueError, match="must agree"):
            tfluid.optimizer.SGD(0.1).minimize(loss)


def _grad_of(pkg, unique_name, build, xs, ys=None):
    """d(sum(build(x[, y])))/d(x[, y]) through ``calc_gradient``."""
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[xs.shape[1]], stop_gradient=False)
        ins = [x]
        feed = {"x": xs}
        if ys is not None:
            y = pkg.layers.data("y", shape=[ys.shape[1]],
                                stop_gradient=False)
            ins.append(y)
            feed["y"] = ys
        out = pkg.layers.reduce_sum(build(pkg, *ins))
        grads = pkg.backward.calc_gradient(out, ins)
    exe = pkg.Executor(pkg.CPUPlace())
    return [np.asarray(g) for g in exe.run(main, feed=feed,
                                           fetch_list=grads)]


def test_clip_gradient_at_its_bounds_is_half():
    xs = np.array([[-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0]], "float32")

    def build(pkg, x):
        return pkg.layers.clip(x, min=-1.0, max=1.0)

    (jg,) = _grad_of(jfluid, j_unique_name, build, xs)
    (tg,) = _grad_of(tfluid, t_unique_name, build, xs)
    np.testing.assert_array_equal(tg, [[0, 0.5, 1, 1, 1, 0.5, 0]])
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("op", ["elementwise_max", "elementwise_min"])
def test_elementwise_tie_splits_the_gradient(op):
    xs = np.array([[1.0, 2.0, 3.0]], "float32")
    ys = np.array([[1.0, 1.0, 5.0]], "float32")

    def build(pkg, x, y):
        return getattr(pkg.layers, op)(x, y)

    want = _grad_of(jfluid, j_unique_name, build, xs, ys)
    got = _grad_of(tfluid, t_unique_name, build, xs, ys)
    assert got[0][0, 0] == got[1][0, 0] == 0.5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
