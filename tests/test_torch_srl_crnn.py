"""The role labeller (PaddlePaddle book ch. 7) and CRNN-CTC
(PaddlePaddle/models ocr_recognition) through both packages, on the CPU.

Each network is built by the port's model module
(``paddle_tpu_torch/models/label_semantic_roles.py``,
``paddle_tpu_torch/models/crnn_ctc.py``) once with the JAX package and
once with the port, at a small size: the role labeller at depth 2,
hidden 32 and 9 labels (SGD on ``exponential_decay``), CRNN at 2 conv
groups, 16 x 64 images and GRU width 16 (Momentum with L2 decay). The
JAX run's initial state is carried over with ``convert.py``; 3 optimizer
steps give losses within 1e-5, and the decodes (the Viterbi paths and
chunk counts; the greedy CTC paths and edit distances) equal the JAX
package's.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.models import crnn_ctc
from paddle_tpu_torch.models import label_semantic_roles as srl
from paddle_tpu_torch.testing import fresh_state

LOSS_TOL = 1e-5
SRL = dict(max_len=10, word_dict_len=50, pred_dict_len=12, label_dict_len=9,
           word_dim=8, mark_dim=5, hidden_dim=32, depth=2)
CRNN = dict(batch_size=4, img_shape=(1, 16, 64), num_classes=10, max_label=6,
            channels=(8, 16), rnn_hidden=16)


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _srl_net(pkg):
    avg_cost, _, extras = srl.build(pkg, **SRL)
    lr = pkg.layers.exponential_decay(0.01, 100000, 0.5, staircase=True)
    pkg.optimizer.SGD(learning_rate=lr).minimize(avg_cost)
    return avg_cost, [extras["decode"]] + list(extras["chunk"][3:])


def _crnn_net(pkg):
    sum_cost, extras = crnn_ctc.build(pkg, **CRNN)
    pkg.optimizer.Momentum(
        learning_rate=1e-3, momentum=0.9,
        regularization=pkg.regularizer.L2Decay(4e-4)).minimize(sum_cost)
    return sum_cost, [extras["decoded"], extras["decoded_len"],
                      extras["edit_distance"]]


def _train_both(net, feeds):
    """Build ``net`` in both packages, initialise the JAX scope, carry
    its whole state into the port, run one step a feed in each; returns
    {package: [(loss, decodes)]}."""
    out, state = {}, None
    for name, pkg, unique_name in (("jax", jfluid, j_unique_name),
                                   ("torch", tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with unique_name.guard({}), pkg.program_guard(main, startup):
            loss, decodes = net(pkg)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            scope = tfluid.Scope()
            persistables_from_numpy(main, scope, state, "cpu")
        runs = []
        for f in feeds:
            vals = exe.run(main, feed=f, fetch_list=[loss] + decodes,
                           scope=scope)
            runs.append((float(np.asarray(vals[0]).reshape(-1)[0]),
                         [np.asarray(v) for v in vals[1:]]))
        out[name] = runs
        if pkg is tfluid:
            assert exe.grad_op_reruns == 0
    return out


def test_role_labeller_three_steps_match_jax():
    rng = np.random.RandomState(0)
    feeds = [srl.iob_batch(np, rng, 4, SRL["max_len"], 3,
                           SRL["word_dict_len"], SRL["pred_dict_len"],
                           SRL["label_dict_len"]) for _ in range(3)]
    res = _train_both(_srl_net, feeds)
    jl = [r[0] for r in res["jax"]]
    tl = [r[0] for r in res["torch"]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert np.isfinite(tl).all()
    for (_, jd), (_, td), f in zip(res["jax"], res["torch"], feeds):
        np.testing.assert_array_equal(td[0], jd[0])  # the Viterbi paths
        live = np.arange(SRL["max_len"])[None, :] < f["length"]
        assert (td[0][~live] == 0).all()
        for a, b in zip(td[1:], jd[1:]):   # chunk counts
            np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))


def test_crnn_ctc_three_steps_match_jax():
    rng = np.random.RandomState(1)
    feeds = [crnn_ctc.batch(np, rng, CRNN["batch_size"], CRNN["img_shape"],
                            CRNN["num_classes"], CRNN["max_label"], 2)
             for _ in range(3)]
    res = _train_both(_crnn_net, feeds)
    jl = [r[0] for r in res["jax"]]
    tl = [r[0] for r in res["torch"]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL, atol=LOSS_TOL)
    assert np.isfinite(tl).all()
    for (_, jd), (_, td) in zip(res["jax"], res["torch"]):
        np.testing.assert_array_equal(td[0], jd[0])   # greedy paths
        np.testing.assert_array_equal(td[1].reshape(-1), jd[1].reshape(-1))
        np.testing.assert_allclose(td[2], jd[2], rtol=0, atol=0)


def test_crnn_shapes_at_the_published_width():
    """The published input [1, 48, 512] gives T 64 frames of 768
    features (a [128, 6, 64] map), GRUs of width 200 and 96 classes;
    built only (shape inference, no data)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        _, extras = crnn_ctc.build(tfluid)
    assert tuple(extras["logits"].shape) == (32, 64, 96)
    shapes = {tuple(p.shape) for p in main.global_block().all_parameters()}
    assert (768, 600) in shapes and (200, 600) in shapes
