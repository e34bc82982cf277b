"""Graph-level autodiff of the PyTorch port against the JAX package.

The same small programs are built in both packages (same layer calls,
fresh name counters): a 2-layer MLP, a variable read twice by one op and
by two ops (which forces ``@GRAD@RENAME_n`` names and a ``sum`` op), the
MLP with an L2Decay regularizer, and the small Transformer with dropout
and label smoothing. ``append_backward`` (through ``minimize``, or
``calc_gradient``) must emit the same ops, with the same inputs, outputs
and attributes, and the same (param, grad) names.
"""

import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.testing import fresh_state


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _mlp(fluid, _):
    x = fluid.layers.data("x", shape=[16])
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    h = fluid.layers.fc(input=x, size=32, act="relu")
    logits = fluid.layers.fc(input=h, size=10)
    return fluid.layers.reduce_sum(
        fluid.layers.softmax_with_cross_entropy(logits, label))


def _reuse(fluid, _):
    """h feeds both slots of one elementwise_mul and two other ops."""
    x = fluid.layers.data("x", shape=[8])
    h = fluid.layers.fc(input=x, size=8)
    sq = fluid.layers.elementwise_mul(h, h)
    y = fluid.layers.elementwise_add(sq, fluid.layers.scale(h, scale=3.0))
    return fluid.layers.reduce_sum(fluid.layers.elementwise_sub(y, h))


def _transformer(fluid, tr):
    loss, _, _ = tr.build(src_vocab_size=60, trg_vocab_size=60,
                          max_length=8, n_layer=2, n_head=2, d_model=32,
                          d_inner=64, dropout=0.1, label_smooth_eps=0.1)
    return loss


PROGRAMS = {
    "mlp_sgd": (_mlp, lambda f: f.optimizer.SGD(learning_rate=0.1)),
    "mlp_adam_l2decay": (_mlp, lambda f: f.optimizer.Adam(
        learning_rate=1e-3,
        regularization=f.regularizer.L2Decay(1e-4))),
    "reuse_adam": (_reuse, lambda f: f.optimizer.Adam(learning_rate=1e-3)),
    "transformer_adam": (_transformer,
                         lambda f: f.optimizer.Adam(learning_rate=1e-3)),
}


def _build(fluid, unique_name, tr, net, make_opt):
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard({}), fluid.program_guard(main, startup):
        loss = net(fluid, tr)
        _, params_grads = make_opt(fluid).minimize(loss)
    return main, startup, params_grads


def _ops(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_minimize_emits_the_reference_graph(name):
    net, make_opt = PROGRAMS[name]
    jm, js, jpg = _build(jfluid, j_unique_name, j_transformer, net, make_opt)
    tm, ts, tpg = _build(tfluid, t_unique_name, t_transformer, net,
                         make_opt)
    j_ops, t_ops = _ops(jm), _ops(tm)
    assert [o[0] for o in t_ops] == [o[0] for o in j_ops]
    assert t_ops == j_ops
    assert _ops(ts) == _ops(js)
    assert [(p.name, g.name) for p, g in tpg] == \
        [(p.name, g.name) for p, g in jpg]

    def var_table(program):
        return {n: (None if v.shape is None else tuple(v.shape),
                    v.persistable)
                for n, v in program.global_block().vars.items()}

    assert var_table(tm) == var_table(jm)
    if name == "reuse_adam":
        types = [o[0] for o in t_ops]
        assert "sum" in types
        assert any("@RENAME_" in n for o in t_ops
                   for names in o[1].values() for n in names)


def test_calc_gradient_matches():
    def build(fluid, unique_name):
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard({}), fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8], stop_gradient=False)
            y = fluid.layers.reduce_sum(
                fluid.layers.elementwise_mul(x, fluid.layers.relu(x)))
            (gx,) = fluid.backward.calc_gradient(y, [x])
        return main, gx

    jm, jg = build(jfluid, j_unique_name)
    tm, tg = build(tfluid, t_unique_name)
    assert _ops(tm) == _ops(jm)
    assert tg.name == jg.name == "x@GRAD"
