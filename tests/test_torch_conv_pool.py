"""conv2d and pool2d of the port (``paddle_tpu_torch/ops/nn_ops.py``)
against the JAX package's lowerings (XLA convolution and reduce-window),
on the CPU: forward and gradient (``torch.autograd`` against
``jax.vjp``) within 1e-5 on the same seeded inputs, over stride,
padding, dilation, groups and ``FLAGS_conv_nhwc`` for the convolution
(the JAX package then convolves in NHWC; the port reads no such flag
and convolves in NCHW either way), and max / average, ``exclusive``,
``ceil_mode`` (the reference's clamp on the last window),
``global_pooling`` and padding above half the window (which torch's own
pooling refuses) for the pooling. Then the
MNIST conv-pool stack as a program, built through both packages with the
same parameters: its output and its parameter gradients."""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.ops import nn_ops as j_nn
from paddle_tpu.testing import set_deterministic_params as j_det
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch.ops import nn_ops as t_nn
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.testing import set_deterministic_params as t_det

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _jax_fwd_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(cot)]


def _torch_fwd_grad(fn, args, cot):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.tensor(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _compare(jfn, tfn, args, seed):
    jout = np.asarray(jfn(*args))
    cot = np.random.RandomState(seed).randn(*jout.shape).astype("float32")
    jout, jgrads = _jax_fwd_vjp(jfn, args, cot)
    tout, tgrads = _torch_fwd_grad(tfn, args, cot)
    assert tout.shape == jout.shape
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg, jg, rtol=TOL, atol=TOL)


@pytest.fixture
def conv_nhwc():
    def set_both(on):
        j_flags.set_flag("conv_nhwc", on)
        t_flags.set_flag("conv_nhwc", on)

    yield set_both
    set_both(False)


# (in channels, out channels, size, kernel, strides, paddings, dilations,
#  groups)
CONV_CASES = [
    (1, 4, 9, 5, [1, 1], [0, 0], [1, 1], 1),
    (3, 6, 11, 3, [2, 2], [1, 1], [1, 1], 1),
    (4, 4, 10, 3, [1, 2], [2, 0], [2, 1], 2),
    (6, 6, 8, 3, [1, 1], [1, 1], [1, 1], 6),
    (4, 8, 12, 2, [3, 1], [0, 3], [1, 3], 4),
]


@pytest.mark.parametrize("nhwc", [False, True])
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv2d_matches_jax(conv_nhwc, case, nhwc):
    cin, cout, size, k, strides, paddings, dilations, groups = \
        CONV_CASES[case]
    conv_nhwc(nhwc)
    rng = np.random.RandomState(case)
    x = rng.randn(2, cin, size, size + 1).astype("float32")
    w = rng.randn(cout, cin // groups, k, k).astype("float32")
    attrs = {"strides": strides, "paddings": paddings,
             "dilations": dilations, "groups": groups}

    def jfn(xv, wv):
        return j_nn._lower_conv2d(None, {"Input": [xv], "Filter": [wv]},
                                  attrs)

    def tfn(xv, wv):
        return t_nn._lower_conv2d(None, {"Input": [xv], "Filter": [wv]},
                                  attrs)

    _compare(jfn, tfn, [x, w], 100 + case)


# (pooling type, ksize, strides, paddings, ceil_mode, exclusive, global)
POOL_CASES = [
    ("max", [2, 2], [2, 2], [0, 0], False, True, False),
    ("max", [3, 3], [2, 2], [1, 1], False, True, False),
    ("max", [3, 3], [2, 2], [1, 1], True, True, False),
    ("max", [2, 3], [3, 2], [0, 1], True, True, False),
    ("max", [2, 2], [1, 1], [2, 2], False, True, False),  # pad > k / 2
    ("avg", [2, 2], [2, 2], [0, 0], False, True, False),
    ("avg", [3, 3], [2, 2], [1, 1], False, True, False),
    ("avg", [3, 3], [2, 2], [1, 1], False, False, False),
    ("avg", [3, 3], [2, 2], [1, 1], True, True, False),
    ("avg", [3, 3], [2, 2], [1, 1], True, False, False),
    ("avg", [2, 3], [3, 2], [0, 1], True, False, False),
    ("avg", [2, 2], [1, 1], [2, 1], False, True, False),  # pad > k / 2
    ("avg", [2, 2], [1, 1], [2, 1], True, False, False),
    ("max", [3, 3], [1, 1], [0, 0], False, True, True),
    ("avg", [3, 3], [1, 1], [1, 1], True, False, True),
]


@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool2d_matches_jax(case):
    ptype, ksize, strides, paddings, ceil, exclusive, glob = \
        POOL_CASES[case]
    attrs = {"pooling_type": ptype, "ksize": ksize, "strides": strides,
             "paddings": paddings, "ceil_mode": ceil,
             "exclusive": exclusive, "global_pooling": glob}
    x = np.random.RandomState(case).randn(2, 3, 9, 8).astype("float32")

    def tfn(xv):
        return t_nn._lower_pool2d(None, {"X": [xv]}, attrs)

    _compare(lambda xv: j_nn._pool2d_core(xv, attrs), tfn, [x], 200 + case)


def test_pool2d_shapes_on_meta_match_the_jax_shapes():
    """Build-time shape inference runs the lowering on meta tensors."""
    for case in POOL_CASES:
        ptype, ksize, strides, paddings, ceil, exclusive, glob = case
        attrs = {"pooling_type": ptype, "ksize": ksize,
                 "strides": strides, "paddings": paddings,
                 "ceil_mode": ceil, "exclusive": exclusive,
                 "global_pooling": glob}
        x = np.zeros((2, 3, 9, 8), "float32")
        want = np.asarray(j_nn._pool2d_core(x, attrs)).shape
        got = t_nn._lower_pool2d(None, {"X": [torch.empty(
            (2, 3, 9, 8), device="meta")]}, attrs).shape
        assert tuple(got) == want, case


def _conv_pool_program(pkg):
    """The MNIST model's two conv-pool blocks, a mean as the loss, SGD;
    names reset."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    if pkg is jfluid:
        j_unique_name.switch({})
    guard = (tfluid.unique_name.guard({}) if pkg is tfluid
             else j_unique_name.guard({}))
    with guard, pkg.program_guard(main, startup):
        img = pkg.layers.data(name="pixel", shape=[1, 28, 28],
                              dtype="float32")
        h = pkg.nets.simple_img_conv_pool(
            input=img, filter_size=5, num_filters=20, pool_size=2,
            pool_stride=2, act="relu")
        h = pkg.nets.simple_img_conv_pool(
            input=h, filter_size=5, num_filters=50, pool_size=2,
            pool_stride=2, act="relu", pool_type="avg")
        loss = pkg.layers.mean(h)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, h, loss


def test_conv_pool_program_matches_jax():
    feed = {"pixel": np.random.RandomState(7).rand(3, 1, 28, 28).astype(
        "float32")}
    grads = ["conv2d_0.w_0@GRAD", "conv2d_0.w_1@GRAD", "conv2d_1.w_0@GRAD"]
    results = []
    for pkg in (jfluid, tfluid):
        main, startup, h, loss = _conv_pool_program(pkg)
        assert [op.type for op in main.global_block().ops][:8] == [
            "conv2d", "elementwise_add", "relu", "pool2d",
            "conv2d", "elementwise_add", "relu", "pool2d"]
        exe = pkg.Executor(pkg.CPUPlace())
        scope = jfluid.executor.Scope() if pkg is jfluid else tfluid.Scope()
        with pkg.scope_guard(scope):
            exe.run(startup)
            (j_det if pkg is jfluid else t_det)(main, scope)
            out = exe.run(main, feed=feed, fetch_list=[h] + grads)
        results.append([np.asarray(o) for o in out])
    assert results[1][0].shape == (3, 50, 4, 4)
    for j, t in zip(*results):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
