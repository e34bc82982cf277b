"""The rest of ``nn_ops.py`` in the PyTorch port against the JAX package, on
the CPU: ``depthwise_conv2d``, ``depthwise_conv2d_transpose``,
``conv3d``, ``conv2d_transpose`` (its ``output_size`` rule),
``conv3d_transpose``, ``pool3d``, ``group_norm``, ``im2sequence``
(``conv_general_dilated_patches``' channel-major feature order, which
``F.unfold`` shares), ``bilinear_interp`` and ``nearest_interp``
(``jax.image.resize``'s half-pixel rule, antialiased when shrinking, not
``align_corners``), and the ``nn.py`` layers over them and over op types
the port already had.

Each op case runs the JAX lowering and the port's on the same seeded
inputs: values within 1e-5, and the gradients of a random cotangent in
every float input within 1e-5 of ``jax.vjp``'s. The cases cover
``tests/test_vision_quant_ops.py``'s ``conv2d_transpose`` /
``conv3d_transpose`` rows. Each layer case builds one layer in both
packages from the JAX run's initial state (``convert.py``) and compares
its output and the gradient of its sum in the input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core import op_registry as j_registry
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.core import op_registry as t_registry
from paddle_tpu_torch.testing import fresh_state

TOL = 1e-5
rng = np.random.RandomState(41)


def f32(*shape):
    return rng.randn(*shape).astype("float32")


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


OPS = [
    ("depthwise_conv2d", {"Input": f32(2, 3, 9, 10),
                          "Filter": f32(6, 1, 3, 3)},
     {"strides": [2, 2], "paddings": [1, 1]}),
    ("depthwise_conv2d_transpose", {"Input": f32(2, 3, 5, 6),
                                    "Filter": f32(3, 2, 3, 3)},
     {"strides": [2, 2], "paddings": [1, 1]}),
    ("conv3d", {"Input": f32(2, 3, 5, 6, 7), "Filter": f32(4, 3, 3, 3, 3)},
     {"strides": [1, 2, 1], "paddings": [1, 1, 1]}),
    ("conv3d", {"Input": f32(1, 4, 6, 6, 6), "Filter": f32(2, 2, 2, 3, 2)},
     {"groups": 2, "dilations": [2, 1, 2], "paddings": [0, 1, 1]}),
    ("conv2d_transpose", {"Input": f32(1, 2, 5, 5), "Filter": f32(2, 3, 3, 3)},
     {"strides": [2, 2], "paddings": [1, 1], "output_size": [10, 10]}),
    ("conv2d_transpose", {"Input": f32(2, 4, 4, 5), "Filter": f32(4, 2, 3, 2)},
     {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1],
      "groups": 2}),
    ("conv3d_transpose", {"Input": f32(1, 2, 3, 3, 3),
                          "Filter": f32(2, 3, 2, 2, 2)},
     {"strides": [2, 2, 2], "paddings": [0, 0, 0]}),
    ("conv3d_transpose", {"Input": f32(1, 2, 3, 4, 3),
                          "Filter": f32(2, 2, 3, 3, 3)},
     {"strides": [2, 2, 2], "paddings": [1, 1, 1],
      "output_size": [6, 8, 6]}),
    ("pool3d", {"X": f32(2, 3, 5, 6, 7)},
     {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2],
      "ceil_mode": True}),
    ("pool3d", {"X": f32(2, 3, 5, 6, 7)},
     {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
      "paddings": [1, 1, 1]}),
    ("pool3d", {"X": f32(2, 3, 5, 6, 7)},
     {"pooling_type": "avg", "ksize": [3, 2, 3], "strides": [2, 2, 2],
      "paddings": [1, 0, 1], "exclusive": False, "ceil_mode": True}),
    ("pool3d", {"X": f32(2, 3, 5, 6, 7)},
     {"pooling_type": "avg", "global_pooling": True}),
    ("group_norm", {"X": f32(2, 6, 4, 5), "Scale": f32(6), "Bias": f32(6)},
     {"groups": 3, "epsilon": 1e-5}),
    ("im2sequence", {"X": f32(2, 3, 9, 10)},
     {"kernels": [3, 2], "strides": [2, 1], "paddings": [1, 0, 1, 1]}),
    ("bilinear_interp", {"X": f32(2, 3, 9, 10)}, {"out_h": 15, "out_w": 17}),
    ("bilinear_interp", {"X": f32(2, 3, 9, 10)}, {"out_h": 4, "out_w": 6}),
    ("bilinear_interp", {"X": f32(1, 2, 9, 10)}, {"out_h": 9, "out_w": 23}),
    ("nearest_interp", {"X": f32(2, 3, 9, 10)}, {"out_h": 13, "out_w": 7}),
    ("nearest_interp", {"X": f32(1, 2, 7, 5)}, {"out_h": 3, "out_w": 16}),
]


@pytest.mark.parametrize("op_type,ins,attrs", OPS,
                         ids=["%s%d" % (o[0], i) for i, o in enumerate(OPS)])
def test_op_value_and_grad_match_jax(op_type, ins, attrs):
    jdef = j_registry.get_op_def(op_type)
    tdef = t_registry.get_op_def(op_type)
    names = sorted(ins)
    out_slot = tdef.output_slots()[0]
    attrs = dict(jdef.attrs, **attrs)

    def jfn(*arrs):
        out = jdef.lower(None, {n: [a] for n, a in zip(names, arrs)}, attrs)
        return out[out_slot] if isinstance(out, dict) else out

    args = tuple(jnp.asarray(ins[n]) for n in names)
    cot = rng.randn(*jax.eval_shape(jfn, *args).shape).astype("float32")

    def run(args, cot):  # one jitted computation, not op by op
        out, vjp = jax.vjp(jfn, *args)
        return out, vjp(cot)

    want, jgrads = jax.jit(run)(args, jnp.asarray(cot))
    leaves = [torch.from_numpy(ins[n].copy()).requires_grad_(True)
              for n in names]
    got = tdef.lower(None, {n: [v] for n, v in zip(names, leaves)}, attrs)
    got = got[out_slot] if isinstance(got, dict) else got
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    for n, g, jg in zip(names, grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL, err_msg=n)


def test_im2sequence_is_unfold_order():
    """A patch's features run over channels, then kernel rows, then
    kernel columns, as ``F.unfold`` lays them out."""
    x = np.arange(2 * 3 * 4 * 4, dtype="float32").reshape(2, 3, 4, 4)
    out = t_registry.get_op_def("im2sequence").lower(
        None, {"X": [torch.from_numpy(x)]},
        {"kernels": [2, 2], "strides": [2, 2], "paddings": [0, 0, 0, 0]})
    np.testing.assert_array_equal(out[0].numpy(), [0, 1, 4, 5, 16, 17, 20,
                                                   21, 32, 33, 36, 37])
    assert tuple(out.shape) == (2 * 2 * 2, 12)


LAYERS = [
    ("conv3d", (2, 3, 5, 6, 7),
     lambda L, x: L.conv3d(x, 4, 3, padding=1, act="relu")),
    ("conv2d_transpose", (2, 2, 5, 5),
     lambda L, x: L.conv2d_transpose(x, 3, output_size=[10, 10],
                                     filter_size=3, padding=1, stride=2)),
    ("conv3d_transpose", (1, 2, 3, 3, 3),
     lambda L, x: L.conv3d_transpose(x, 2, filter_size=2, stride=2)),
    ("depthwise_conv2d", (2, 3, 8, 8),
     lambda L, x: L.depthwise_conv2d(x, 6, 3, padding=1)),
    ("pool3d", (2, 3, 5, 6, 7),
     lambda L, x: L.pool3d(x, 2, "avg", 2, ceil_mode=True)),
    ("group_norm", (2, 6, 4, 5), lambda L, x: L.group_norm(x, 2)),
    ("image_resize", (2, 3, 6, 8),
     lambda L, x: L.image_resize(x, scale=1.5, resample="NEAREST")),
    ("resize_bilinear", (2, 3, 6, 8),
     lambda L, x: L.resize_bilinear(x, out_shape=[9, 5])),
    ("image_resize_short", (2, 3, 6, 9),
     lambda L, x: L.image_resize_short(x, 4)),
    ("im2sequence", (2, 3, 6, 6),
     lambda L, x: L.im2sequence(x, filter_size=[3, 2], stride=2,
                                padding=1)),
    ("cos_sim", (4, 6), lambda L, x: L.cos_sim(x, L.scale(x, 0.5, 1.0))),
    ("prelu", (2, 3, 4), lambda L, x: L.prelu(x, "channel")),
    ("l2_normalize", (3, 5), lambda L, x: L.l2_normalize(x, axis=1)),
    ("bilinear_tensor_product", (4, 3),
     lambda L, x: L.bilinear_tensor_product(x, L.scale(x, 2.0), 5,
                                            act="tanh")),
    ("dice_loss", (4, 5), lambda L, x: L.dice_loss(
        L.softmax(x), L.softmax(L.scale(x, 2.0)))),
]


def _layer_run(pkg, unique_name, shape, build, x, state):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard({}), pkg.program_guard(main, startup):
        xv = pkg.layers.data("x", list(shape[1:]), stop_gradient=False)
        out = build(pkg.layers, xv)
        (gx,) = pkg.backward.calc_gradient(pkg.layers.reduce_sum(out), [xv])
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is jfluid:
        scope = JScope()
        exe.run(startup, scope=scope)
        state.update({v.name: np.asarray(scope.get_value(v.name))
                      for v in main.global_block().vars.values()
                      if v.persistable
                      and scope.get_value(v.name) is not None})
    else:
        scope = tfluid.Scope()
        persistables_from_numpy(main, scope, state, "cpu")
    return [np.asarray(v) for v in exe.run(main, feed={"x": x},
                                           fetch_list=[out, gx],
                                           scope=scope)]


@pytest.mark.parametrize("name,shape,build", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_layer_matches_jax(name, shape, build):
    x = f32(*shape)
    state = {}
    want = _layer_run(jfluid, j_unique_name, shape, build, x, state)
    got = _layer_run(tfluid, t_unique_name, shape, build, x, state)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_multiplex_and_mean_iou_layers_match_jax():
    a, b = f32(4, 3), f32(4, 3)
    idx = np.array([[1], [0], [1], [1]], "int32")
    pred = rng.randint(0, 3, (4, 5)).astype("int32")
    lab = rng.randint(0, 3, (4, 5)).astype("int32")
    res = {}
    for pkg, un in ((jfluid, j_unique_name), (tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard({}), pkg.program_guard(main, startup):
            L = pkg.layers
            m = L.multiplex([L.data("a", [3]), L.data("b", [3])],
                            L.data("i", [1], dtype="int32"))
            iou = list(L.mean_iou(L.data("p", [5], dtype="int32"),
                                  L.data("l", [5], dtype="int32"), 3))
        res[pkg] = [np.asarray(v) for v in pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"a": a, "b": b, "i": idx, "p": pred, "l": lab},
            fetch_list=[m] + iou)]
    for g, w in zip(res[tfluid], res[jfluid]):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
