"""The loss ops of the port against the JAX package's lowerings, on the
CPU: every op type of ``paddle_tpu/ops/loss_ops.py`` the port added with
the detection set (``sigmoid_cross_entropy_with_logits``, ``bce_loss``,
``squared_l2_distance``, ``squared_l2_norm``, ``smooth_l1_loss``,
``huber_loss``, ``log_loss``, ``hinge_loss``, ``rank_loss``,
``margin_rank_loss``, ``kldiv_loss`` in its four reductions,
``modified_huber_loss``) at the inputs of the loss rows of
``test_op_breadth.py``, ``test_check_grad_sweep.py`` and
``test_vision_quant_ops.py::test_modified_huber_loss``, and the nine
layers of ``paddle_tpu/layers/loss.py`` that build them.

The harness is ``test_torch_tensor_ops.py``'s: the same program in both
packages (ops, attrs and names equal), equal forward outputs, then equal
gradients of ``sum_i reduce_sum(Out_i * W_i)`` with respect to every
floating input, rtol 1e-5, atol 1e-6. An op's intermediate output
(``Diff``, ``Residual``, ``Activated``, ``sub_result``,
``IntermediateVal``) is compared in the forward and left out of the
loss.
"""

import inspect

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.testing import fresh_state
from test_torch_tensor_ops import L, case, check_case


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def op(op_type, slots, out_slots, **attrs):
    """A build that appends ``op_type`` itself: the case's inputs, in
    order, under ``slots``."""
    def build(pkg, vs):
        blk = pkg.default_main_program().global_block()
        outs = [blk.create_var(name="out_" + s.lower()) for s in out_slots]
        blk.append_op(type=op_type,
                      inputs={s: [v.name] for s, v in zip(slots, vs.values())},
                      outputs={s: [v.name] for s, v in zip(out_slots, outs)},
                      attrs=attrs)
        return outs
    return build


def _rng(seed):
    return np.random.RandomState(seed)


def _smooth_l1_inputs():
    rng = _rng(33)
    x = rng.randn(4, 3).astype("float32")
    # |x - y| away from the switch at 1 / sigma^2
    d = np.where(rng.rand(4, 3) > 0.5, rng.uniform(0.2, 0.8, (4, 3)),
                 rng.uniform(1.2, 1.8, (4, 3))).astype("float32")
    y = (x + d * np.where(rng.rand(4, 3) > 0.5, 1, -1)).astype("float32")
    return x, y


_x30 = _rng(30).uniform(0.05, 0.95, (4, 3)).astype("float32")
_l30 = (_rng(130).rand(4, 3) > 0.5).astype("float32")
_p31 = _rng(31).uniform(0.1, 0.9, (6, 1)).astype("float32")
_l31 = (_rng(131).rand(6, 1) > 0.5).astype("float32")
_kx = np.log(_rng(32).dirichlet(np.ones(5), 4)).astype("float32")
_kt = _rng(132).dirichlet(np.ones(5), 4).astype("float32")
_sx, _sy = _smooth_l1_inputs()
_ones43 = np.ones((4, 3), "float32")
_iw = _rng(133).uniform(0.5, 1.5, (4, 3)).astype("float32")
_x34 = _rng(34).randn(4, 5).astype("float32")
_l34 = _rng(134).uniform(0, 1, (4, 5)).astype("float32")
_x35 = _rng(35).randn(3, 4).astype("float32")
_hx = np.asarray([[0.0], [0.0], [1.0]], "float32")
_hy = np.asarray([[0.3], [2.0], [-0.8]], "float32")
_dx = _rng(13).randn(3, 4).astype("float32")
_dy = _rng(113).randn(3, 4).astype("float32")
_rl = np.asarray([[1.0], [0.0], [1.0]], "float32")
_left = _rng(14).randn(3, 1).astype("float32")
_right = _rng(114).randn(3, 1).astype("float32")
_ml = np.asarray([[1.0], [1.0], [-1.0]], "float32")
_m1 = np.asarray([[0.8], [-0.5], [0.6]], "float32")
_m2 = np.asarray([[0.1], [0.4], [1.5]], "float32")
_hl = np.asarray([[0.3], [1.6], [-0.4]], "float32")
_hlab = np.asarray([[1.0], [1.0], [0.0]], "float32")
_mhx = np.asarray([[0.3], [-1.8], [0.6]], "float32")
_mhy = np.asarray([[1.0], [1.0], [0.0]], "float32")
_mhx2 = np.asarray([[2.2], [0.4], [-0.3], [-3.1]], "float32")
_mhy2 = np.ones((4, 1), "float32")

CASES = {
    # test_op_breadth.py's loss rows
    "bce_loss": case(op("bce_loss", ["X", "Label"], ["Out"]),
                     {"x": _x30, "label": _l30}),
    "log_loss": case(op("log_loss", ["Predicted", "Labels"], ["Loss"],
                        epsilon=1e-4), {"p": _p31, "label": _l31}),
    "kldiv_loss_mean": case(op("kldiv_loss", ["X", "Target"], ["Loss"],
                               reduction="mean"), {"x": _kx, "t": _kt}),
    "kldiv_loss_sum": case(op("kldiv_loss", ["X", "Target"], ["Loss"],
                              reduction="sum"), {"x": _kx, "t": _kt}),
    "kldiv_loss_batchmean": case(op("kldiv_loss", ["X", "Target"], ["Loss"],
                                    reduction="batchmean"),
                                 {"x": _kx, "t": _kt}),
    "kldiv_loss_none": case(op("kldiv_loss", ["X", "Target"], ["Loss"],
                               reduction="none"), {"x": _kx, "t": _kt}),
    "smooth_l1_loss": case(op("smooth_l1_loss",
                              ["X", "Y", "InsideWeight", "OutsideWeight"],
                              ["Diff", "Out"], sigma=1.0),
                           {"x": _sx, "y": _sy, "iw": _ones43,
                            "ow": _ones43}, weighted=[1]),
    "smooth_l1_loss_weighted_sigma": case(
        op("smooth_l1_loss", ["X", "Y", "InsideWeight", "OutsideWeight"],
           ["Diff", "Out"], sigma=2.0),
        {"x": _sx, "y": _sy, "iw": _iw, "ow": _iw[::-1].copy()},
        weighted=[1]),
    "smooth_l1_loss_no_weights": case(
        op("smooth_l1_loss", ["X", "Y"], ["Diff", "Out"], sigma=1.0),
        {"x": _sx, "y": _sy}, weighted=[1]),
    "sigmoid_cross_entropy_with_logits": case(
        op("sigmoid_cross_entropy_with_logits", ["X", "Label"], ["Out"],
           ignore_index=-100), {"x": _x34, "label": _l34}),
    "squared_l2_norm": case(op("squared_l2_norm", ["X"], ["Out"]),
                            {"x": _x35}),
    # test_check_grad_sweep.py's piecewise losses
    "huber_loss": case(op("huber_loss", ["X", "Y"], ["Residual", "Out"],
                          delta=1.0), {"x": _hx, "y": _hy}, weighted=[1]),
    "squared_l2_distance": case(op("squared_l2_distance", ["X", "Y"],
                                   ["sub_result", "Out"]),
                                {"x": _dx, "y": _dy}, weighted=[1]),
    "squared_l2_distance_broadcast": case(
        op("squared_l2_distance", ["X", "Y"], ["sub_result", "Out"]),
        {"x": _dx, "y": _dy[:1].copy()}, weighted=[1]),
    "rank_loss": case(op("rank_loss", ["Label", "Left", "Right"], ["Out"]),
                      {"label": _rl, "left": _left, "right": _right}),
    "margin_rank_loss": case(op("margin_rank_loss", ["Label", "X1", "X2"],
                                ["Activated", "Out"], margin=0.1),
                             {"label": _ml, "x1": _m1, "x2": _m2},
                             weighted=[1]),
    "hinge_loss": case(op("hinge_loss", ["Logits", "Labels"], ["Loss"]),
                       {"logits": _hl, "labels": _hlab}),
    "modified_huber_loss": case(op("modified_huber_loss", ["X", "Y"],
                                   ["Out", "IntermediateVal"]),
                                {"x": _mhx, "y": _mhy}, weighted=[0]),
    # test_vision_quant_ops.py::test_modified_huber_loss
    "modified_huber_loss_kinks": case(
        op("modified_huber_loss", ["X", "Y"], ["Out", "IntermediateVal"]),
        {"x": _mhx2, "y": _mhy2}, weighted=[0]),
    # the layers
    "layer_sigmoid_cross_entropy_with_logits": case(
        L(lambda l, x, y: l.sigmoid_cross_entropy_with_logits(x, y)),
        {"x": _x34, "label": _l34}),
    "layer_square_error_cost": case(
        L(lambda l, x, y: l.square_error_cost(x, y)), {"x": _dx, "y": _dy}),
    "layer_smooth_l1": case(
        L(lambda l, x, y, iw, ow: l.smooth_l1(x, y, iw, ow, sigma=1.5)),
        {"x": _sx, "y": _sy, "iw": _iw, "ow": _ones43}),
    "layer_huber_loss": case(L(lambda l, x, y: l.huber_loss(x, y, 1.0)),
                             {"x": _hx, "y": _hy}),
    "layer_log_loss": case(L(lambda l, p, y: l.log_loss(p, y)),
                           {"p": _p31, "label": _l31}),
    "layer_hinge_loss": case(L(lambda l, x, y: l.hinge_loss(x, y)),
                             {"logits": _hl, "labels": _hlab}),
    "layer_rank_loss": case(L(lambda l, y, a, b: l.rank_loss(y, a, b)),
                            {"label": _rl, "left": _left,
                             "right": _right}),
    "layer_margin_rank_loss": case(
        L(lambda l, y, a, b: l.margin_rank_loss(y, a, b, margin=0.1)),
        {"label": _ml, "x1": _m1, "x2": _m2}),
    "layer_kldiv_loss": case(
        L(lambda l, x, t: l.kldiv_loss(x, t, reduction="batchmean")),
        {"x": _kx, "t": _kt}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_op_matches_jax_forward_and_gradient(name):
    check_case(CASES[name])


def test_every_reference_loss_op_is_registered():
    """The JAX package's loss_ops.py table, whole: schema, attrs and
    grad settings equal."""
    from paddle_tpu.core import op_registry as j_registry
    from paddle_tpu_torch.core import op_registry as t_registry

    import paddle_tpu.ops.loss_ops as j_loss

    want = {t for t in j_registry.registered_ops()
            if not t.endswith("_grad")
            and j_registry.get_op_def(t).lower.__module__
            == j_loss.__name__}
    assert len(want) == 15
    for t in sorted(want):
        assert t_registry.has_op(t), t
        jd, td = j_registry.get_op_def(t), t_registry.get_op_def(t)
        assert (td.inputs, td.outputs, td.attrs) == \
            (jd.inputs, jd.outputs, jd.attrs), t
        assert (td.grad is None) == (jd.grad is None), t
        assert td.intermediate_outputs == jd.intermediate_outputs, t
        assert td.no_grad_inputs == jd.no_grad_inputs, t


def test_loss_layers_are_exported_with_their_signatures():
    import paddle_tpu.layers.loss as j_loss_layers

    for name in j_loss_layers.__all__:
        assert hasattr(tfluid.layers, name), name
        assert inspect.signature(getattr(tfluid.layers, name)) == \
            inspect.signature(getattr(jfluid.layers, name)), name
