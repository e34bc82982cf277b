"""The vision ops of the PyTorch port against the JAX package, on the CPU:
``affine_channel``, ``affine_grid``, ``grid_sampler``,
``max_pool2d_with_index``, ``max_pool3d_with_index``, ``unpool`` and
``spp``, and the ``nn.py`` layers over them.

Each op case runs the JAX lowering and the port's on the same seeded
inputs (``test_torch_sequence.op_twin``): outputs within 1e-5, masks
equal, and the gradients of a random cotangent within 1e-5 of
``jax.vjp``'s. They are the twins of ``tests/test_vision_quant_ops.py``'s
vision rows, with cases the JAX tests leave out: tied maxima (after a
relu, or rounded values), where ``max_pool2d_with_index`` splits the
gradient among the ties and ``spp`` gives it to the first in row-major
order; overlapping windows whose argmaxes ``unpool`` writes twice; and
the identity ``affine_grid`` fed to ``grid_sampler``, whose samples land
on integer coordinates, where the gradient in the grid is that of
``|.|`` at 0 (+1 in JAX, 0 in ``torch.abs``). ``affine_grid``'s
linspace is ``jnp.linspace``'s expression, so the identity grid is
bit-equal to the JAX package's under ``jax.jit``, as its executor runs
it (eager ``jnp.linspace`` rounds one value an ulp apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import op_registry as j_registry
from paddle_tpu_torch.core import op_registry as t_registry
from paddle_tpu_torch.testing import fresh_state
from test_torch_sequence import _both, op_twin

rng = np.random.RandomState(61)


def f32(*shape):
    return rng.randn(*shape).astype("float32")


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


IDENTITY = np.tile(np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                              "float32"), (2, 1, 1))


def _jax_grid(theta, shape):
    return np.asarray(jax.jit(lambda t: j_registry.get_op_def(
        "affine_grid").lower(None, {"Theta": [t]}, {"output_shape": shape}))(
            jnp.asarray(theta)))


def _tied(*shape):
    """Relu'd values rounded to halves: most windows hold tied maxima."""
    return np.maximum(np.round(f32(*shape) * 2) / 2, 0).astype("float32")


def _pool_mask(x, k, s, p):
    out = j_registry.get_op_def("max_pool2d_with_index").lower(
        None, {"X": [jnp.asarray(x)]},
        {"ksize": k, "strides": s, "paddings": p})
    return np.asarray(out["Out"]), np.asarray(out["Mask"])


P1, M1 = _pool_mask(f32(1, 2, 4, 4), [2, 2], [2, 2], [0, 0])
P2, M2 = _pool_mask(_tied(2, 3, 7, 7), [3, 3], [2, 2], [1, 1])
# an even map: the unpooled size (7) is smaller than the pooled map (8),
# and the indices past it are dropped
P3, M3 = _pool_mask(_tied(2, 3, 8, 8), [3, 3], [2, 2], [1, 1])

OPS = [
    # tests/test_vision_quant_ops.py:44-240
    ("affine_channel", {"X": f32(2, 3, 4, 5), "Scale": f32(3),
                        "Bias": f32(3)}, {}),
    ("affine_channel", {"X": f32(2, 4, 5, 3), "Scale": f32(3),
                        "Bias": f32(3)}, {"data_layout": "NHWC"}),
    ("affine_grid", {"Theta": f32(2, 2, 3)},
     {"output_shape": [2, 3, 4, 5]}),
    ("affine_grid", {"Theta": f32(1, 2, 3)},
     {"output_shape": [1, 1, 1, 6]}),
    ("grid_sampler", {"X": f32(1, 2, 4, 4), "Grid": rng.uniform(
        -0.85, 0.85, (1, 3, 3, 2)).astype("float32")}, {}),
    ("grid_sampler", {"X": f32(2, 3, 5, 6), "Grid": rng.uniform(
        -1.2, 1.2, (2, 4, 7, 2)).astype("float32")}, {}),
    # the identity grid: every sample on an integer coordinate
    ("grid_sampler", {"X": f32(2, 3, 5, 6),
                      "Grid": _jax_grid(IDENTITY, [2, 3, 5, 6])}, {}),
    ("max_pool2d_with_index", {"X": f32(2, 3, 6, 8)},
     {"ksize": [2, 3], "strides": [2, 2], "paddings": [1, 1]}),
    ("max_pool2d_with_index", {"X": (np.arange(16, dtype="float32")
                                     .reshape(1, 1, 4, 4) * 7.3) % 11.0},
     {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}),
    ("max_pool2d_with_index", {"X": _tied(2, 3, 7, 7)},
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    ("max_pool2d_with_index", {"X": _tied(1, 2, 5, 4)},
     {"ksize": [2, 2], "strides": [1, 1], "global_pooling": True}),
    ("max_pool3d_with_index", {"X": f32(1, 2, 4, 4, 4)},
     {"ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 0, 0]}),
    ("max_pool3d_with_index", {"X": _tied(1, 2, 5, 4, 5)},
     {"ksize": [3, 2, 3], "strides": [2, 2, 2], "paddings": [1, 0, 1]}),
    ("unpool", {"X": P1, "Indices": M1},
     {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}),
    # overlapping windows: one argmax written by several of them
    ("unpool", {"X": P2, "Indices": M2},
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    ("unpool", {"X": P3, "Indices": M3},
     {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    ("spp", {"X": f32(2, 3, 4, 4)}, {"pyramid_height": 2,
                                     "pooling_type": "max"}),
    ("spp", {"X": f32(2, 3, 4, 4)}, {"pyramid_height": 2,
                                     "pooling_type": "avg"}),
    # :613, non-divisible: exclusive averages, padded max windows
    ("spp", {"X": f32(1, 2, 5, 5)}, {"pyramid_height": 3,
                                     "pooling_type": "avg"}),
    ("spp", {"X": f32(1, 2, 5, 7)}, {"pyramid_height": 3,
                                     "pooling_type": "max"}),
    ("spp", {"X": _tied(2, 2, 6, 5)}, {"pyramid_height": 3,
                                       "pooling_type": "max"}),
]


@pytest.mark.parametrize("op_type,ins,attrs", OPS,
                         ids=["%s%d" % (o[0], i) for i, o in enumerate(OPS)])
def test_op_value_and_grad_match_jax(op_type, ins, attrs):
    op_twin(op_type, ins, attrs)


def test_identity_affine_grid_is_bit_equal():
    got = t_registry.get_op_def("affine_grid").lower(
        None, {"Theta": [torch.from_numpy(IDENTITY)]},
        {"output_shape": [2, 3, 5, 6]}).numpy()
    np.testing.assert_array_equal(got, _jax_grid(IDENTITY, [2, 3, 5, 6]))


def test_abs_derivative_at_zero_is_jax_s():
    """The identity grid's samples sit on integer coordinates, where a
    bilinear weight's |g - c| is 0: JAX differentiates |u| there as +1."""
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    op_twin("grid_sampler", {"X": f32(1, 1, 3, 3), "Grid": np.array(
        [[[[0.0, 0.0], [1.0, -1.0]]]], "float32")}, {})


def test_tied_max_pool_splits_the_gradient():
    """Ties share the gradient equally (jnp.max's rule), unlike
    F.max_pool2d, which sends it to one element."""
    x = torch.zeros(1, 1, 2, 2, requires_grad=True)
    out = t_registry.get_op_def("max_pool2d_with_index").lower(
        None, {"X": [x]}, {"ksize": [2, 2], "strides": [2, 2],
                           "paddings": [0, 0]})
    (g,) = torch.autograd.grad(out["Out"].sum(), [x])
    np.testing.assert_allclose(g.numpy(), np.full((1, 1, 2, 2), 0.25))
    assert int(out["Mask"].reshape(-1)[0]) == 0   # the first argmax


def test_unpool_refuses_other_types():
    with pytest.raises(ValueError, match="only max unpooling"):
        op_twin("unpool", {"X": P1, "Indices": M1},
                {"ksize": [2, 2], "strides": [2, 2],
                 "unpooling_type": "avg"})


def _transformer(L, v):
    grid = L.affine_grid(v["theta"], out_shape=[2, 3, 5, 6])
    return [L.grid_sampler(v["x"], grid), grid]


def _channel(L, v):
    return [L.affine_channel(v["x"]),
            L.affine_channel(v["y"], data_layout="NHWC")]


LAYER_CASES = [
    # :90, the identity roundtrip, gradients in theta and x
    ("affine_grid_grid_sampler", _transformer,
     {"x": f32(2, 3, 5, 6), "theta": IDENTITY}, ("theta", "x")),
    ("affine_grid_grid_sampler_rotated", _transformer,
     {"x": f32(2, 3, 5, 6), "theta": (IDENTITY + 0.2 * f32(2, 2, 3))
      .astype("float32")}, ("theta", "x")),
    # :575, default parameters (the identity until trained)
    ("affine_channel", _channel, {"x": f32(2, 3, 4, 4),
                                  "y": f32(2, 4, 4, 3)}, ("x",)),
]


@pytest.mark.parametrize("name,build,feed,grads", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, build, feed, grads):
    res = _both(build, feed, grads)
    for g, w in zip(res["torch"], res["jax"]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    if name == "affine_grid_grid_sampler":
        np.testing.assert_allclose(res["torch"][0], feed["x"], rtol=1e-6,
                                   atol=1e-6)


def test_vision_layers_in_both_packages():
    for name in ("affine_channel", "affine_grid", "grid_sampler"):
        assert name in tfluid.layers.nn.__all__
        assert callable(getattr(jfluid.layers, name))
