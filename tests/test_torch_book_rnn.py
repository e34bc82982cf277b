"""The book's DynamicRNN sentiment LSTM and RNN encoder-decoder through
both packages, on the CPU.

``dyn_rnn_lstm`` (``paddle_tpu_torch/models/understand_sentiment.py``:
four ``fc``-sum gates inside a ``DynamicRNN`` step) and the machine
translation test's ``encoder`` / ``decoder_train``
(``paddle_tpu_torch/models/rnn_encoder_decoder.py``: a tanh ``fc``,
``dynamic_lstm``, the last step; a ``DynamicRNN`` decoder whose memory
starts at the encoder's output) are built by the port's model modules
once with the JAX package and once with the port, at widths 8-16 and
T <= 6. The JAX run's initial state is carried over with ``convert.py``;
two optimizer steps (Adagrad, the encoder-decoder's with L2 decay) give
losses within 1e-5 and every parameter's gradient within 1e-5 of the
largest entry, with no grad op rerunning its forward. The encoder's
``dynamic_lstm`` on the port's CPU path equals B6's plain version
(``kernels/lstm_cell.py`` ``lstm_reference``) on its own inputs.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.kernels.lstm_cell import lstm_reference
from paddle_tpu_torch.models import rnn_encoder_decoder as encdec
from paddle_tpu_torch.models import understand_sentiment as sentiment
from paddle_tpu_torch.testing import fresh_state

TOL = 1e-5
SENT = dict(max_len=6, input_dim=40, class_dim=2, emb_dim=8, lstm_size=16)
ED = dict(max_src_len=6, max_trg_len=6, dict_size=30, word_dim=8,
          hidden_dim=8)


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _sentiment(pkg):
    loss, _, _ = sentiment.build_lstm(pkg, **SENT)
    _, pg = pkg.optimizer.Adagrad(
        learning_rate=sentiment.LEARNING_RATE * 50).minimize(loss)
    return loss, pg


def _encdec(pkg):
    loss, _ = encdec.build(pkg, **ED)
    _, pg = pkg.optimizer.Adagrad(
        learning_rate=0.05,
        regularization=pkg.regularizer.L2Decay(encdec.L2_COEFF)
    ).minimize(loss)
    return loss, pg


def _train_both(net, feeds):
    """Build ``net`` in both packages, run both startup programs, carry
    the JAX state into the port, run one step a feed in each; returns
    {package: [(loss, {param: grad})]} and the port's program, scope and
    executor."""
    out, state, port = {}, None, None
    for name, pkg, unique_name in (("jax", jfluid, j_unique_name),
                                   ("torch", tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with unique_name.guard({}), pkg.program_guard(main, startup):
            loss, pg = net(pkg)
        grads = [(p.name, g.name) for p, g in pg]
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            scope = tfluid.Scope()
            exe.run(startup, scope=scope)
            persistables_from_numpy(main, scope, state, "cpu")
            port = (main, scope, exe)
        runs = []
        for f in feeds:
            vals = exe.run(main, feed=f, scope=scope,
                           fetch_list=[loss] + [g for _, g in grads])
            runs.append((float(np.asarray(vals[0]).reshape(-1)[0]),
                         {p: np.asarray(v) for (p, _), v in
                          zip(grads, vals[1:])}))
        out[name] = runs
    assert port[2].grad_op_reruns == 0
    return out, port


def _assert_same(res):
    assert len(res["jax"]) == len(res["torch"]) == 2
    for (jl, jg), (tl, tg) in zip(res["jax"], res["torch"]):
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
        assert sorted(tg) == sorted(jg)
        for name in jg:
            scale = max(1.0, float(np.abs(jg[name]).max()))
            np.testing.assert_allclose(tg[name], jg[name], rtol=0,
                                       atol=TOL * scale, err_msg=name)


def test_dyn_rnn_lstm_two_steps_match_jax():
    rng = np.random.RandomState(0)
    feeds = [sentiment.batch(np, rng, 4, SENT["max_len"], 2,
                             SENT["input_dim"]) for _ in range(2)]
    res, (main, _, _) = _train_both(_sentiment, feeds)
    _assert_same(res)
    types = [op.type for op in main.global_block().ops]
    assert types.count("recurrent") == 1 and "recurrent_grad" in types
    step = main.block(1)
    assert [op.type for op in step.ops].count("mul") == 8   # 4 gates x 2


def test_encoder_decoder_two_steps_match_jax():
    rng = np.random.RandomState(1)
    feeds = [encdec.batch(np, rng, 3, ED["max_src_len"], 2, ED["dict_size"])
             for _ in range(2)]
    res, (main, scope, exe) = _train_both(_encdec, feeds)
    _assert_same(res)
    params = [p.name for p in main.global_block().all_parameters()]
    assert params.count("vemb") == 1   # source and target share it
    # the encoder's dynamic_lstm against B6's plain version
    (op,) = [o for o in main.global_block().ops if o.type == "dynamic_lstm"]
    xw, hid, w, b = (op.input("Input")[0], op.output("Hidden")[0],
                     op.input("Weight")[0], op.input("Bias")[0])
    d = ED["hidden_dim"]
    w_h = torch.as_tensor(np.array(scope.get_value(w)))
    bias = torch.as_tensor(np.array(scope.get_value(b)).reshape(-1))
    got_x, got_h = exe.run(main, feed=feeds[0], fetch_list=[xw, hid],
                           scope=scope)
    lens = feeds[0]["src_length"].reshape(-1)
    mask = torch.as_tensor(
        (np.arange(ED["max_src_len"])[None, :] < lens[:, None]).astype(
            "float32"))
    want, _ = lstm_reference(
        torch.as_tensor(got_x), w_h, bias[:4 * d],
        (bias[4 * d:5 * d], bias[5 * d:6 * d], bias[6 * d:7 * d]),
        mask=mask)
    np.testing.assert_allclose(got_h, want.numpy(), rtol=0, atol=1e-6)


def test_book_models_at_their_published_widths_build():
    """Built only (shape inference, no data; short sentences, the
    widths are what count): dyn_rnn_lstm's embedding 32 and LSTM 128
    over the IMDB dictionary; the encoder-decoder's dictionary 30,000,
    words 16 and hidden 32 (B6 at D 32)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        _, _, pred = sentiment.build_lstm(tfluid, max_len=8)
    shapes = {tuple(p.shape) for p in main.global_block().all_parameters()}
    assert (5148, 32) in shapes and (32, 128) in shapes \
        and (128, 128) in shapes
    assert tuple(pred.shape) == (-1, 2)
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        _, out = encdec.build(tfluid, max_src_len=8, max_trg_len=8)
    assert tuple(out.shape) == (-1, 8, 30000)
    (op,) = [o for o in main.global_block().ops if o.type == "dynamic_lstm"]
    assert tuple(main.global_block().var(op.input("Weight")[0]).shape) == \
        (32, 128)
