"""The RNN models of the PyTorch port against the JAX package, on the CPU.

- the committed goldens ``tests/golden/stacked_lstm.npz`` and
  ``tests/golden/machine_translation.npz`` reproduced (rtol 1e-5), the
  programs built as ``tests/golden_models.py`` ``build_golden`` builds
  them (deterministic parameters seeded by name, the test clone);
- a 5-step Adam trajectory of a small stacked LSTM (2 layers, width 16,
  sequence length 16) and a 3-step one of a small machine-translation
  graph, the JAX run's whole state carried across with
  ``convert.persistables_from_numpy`` (the LSTM weights and biases keep
  their names and layouts, ``[D, 4D]`` and ``[1, 7D]`` / ``[1, 4D]``):
  losses within 1e-4, with the fused-route flag off and on;
- the twin of ``tests/test_models_rnn.py``: the port's stacked LSTM
  converges on the synthetic separable sentiment data.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import machine_translation as j_mt
from paddle_tpu.models import stacked_lstm as j_stacked
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.models import machine_translation as t_mt
from paddle_tpu_torch.models import stacked_lstm as t_stacked
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _golden_stacked_lstm():
    _, _, outs = t_stacked.build()
    return outs["predict"]


def _golden_machine_translation():
    avg_cost, _, _ = t_mt.build(src_vocab=40, tgt_vocab=30, src_seq_len=6,
                                tgt_seq_len=5, emb_dim=8, encoder_size=8,
                                decoder_size=8)
    return avg_cost


@pytest.mark.parametrize("name,build", [
    ("stacked_lstm", _golden_stacked_lstm),
    ("machine_translation", _golden_machine_translation)])
def test_port_reproduces_the_rnn_goldens(name, build):
    """As build_golden does: program seeds 11, deterministic parameters
    by name, the test clone. The stacked LSTM's label feeds only the
    loss and the accuracy, not the fetched predictions."""
    golden = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 11
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        fetch = build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    feed = {k[len("feed_"):]: golden[k] for k in golden.files
            if k.startswith("feed_")}
    if name == "stacked_lstm":
        feed["label"] = np.zeros((feed["words"].shape[0], 1), "int64")
    (out,) = exe.run(main.clone(for_test=True), feed=feed,
                     fetch_list=[fetch], scope=scope)
    np.testing.assert_allclose(out, golden["expected"], rtol=1e-5,
                               atol=1e-6)


def _sentiment(n, seq_len, dict_size, rng):
    """tests/test_models_rnn.py's synthetic separable sentiment data:
    class 0 draws from the low half of the vocabulary, class 1 from the
    high half."""
    words = np.zeros((n, seq_len), "int64")
    lens = rng.randint(seq_len // 2, seq_len + 1, size=n).astype("int64")
    labels = rng.randint(0, 2, size=(n, 1)).astype("int64")
    for i in range(n):
        lo, hi = ((2, dict_size // 2) if labels[i, 0] == 0
                  else (dict_size // 2, dict_size - 1))
        words[i, :lens[i]] = rng.randint(lo, hi, size=lens[i])
    return {"words": words, "length": lens.reshape(-1, 1), "label": labels}


def _mt_feed(batch=4, src_len=7, tgt_len=6, vocab=40, seed=0):
    rng = np.random.RandomState(seed)
    mask = (np.arange(tgt_len)[None, :]
            < rng.randint(2, tgt_len + 1, (batch, 1))).astype("float32")
    return {
        "source_sequence": rng.randint(1, vocab, (batch, src_len)).astype(
            "int64"),
        "source_length": rng.randint(1, src_len + 1, (batch, 1)).astype(
            "int64"),
        "target_sequence": rng.randint(1, vocab, (batch, tgt_len)).astype(
            "int64"),
        "label": rng.randint(1, vocab, (batch, tgt_len)).astype("int64"),
        "label_mask": mask,
    }


def _stacked(pkg):
    m = j_stacked if pkg is jfluid else t_stacked
    return m.build(seq_len=16, dict_size=200, emb_dim=16, hid_dim=16,
                   stacked_num=2)[0]


def _mt(pkg):
    m = j_mt if pkg is jfluid else t_mt
    return m.build(src_vocab=40, tgt_vocab=40, src_seq_len=7, tgt_seq_len=6,
                   emb_dim=8, encoder_size=8, decoder_size=8)[0]


def _train_both(net, feeds, lr):
    """Build ``net`` with Adam in both packages, initialise the JAX
    scope, carry its whole state into the port, run one step per feed in
    each; returns (JAX losses, port losses, the port's program)."""
    losses, state = {}, None
    for name, pkg, unique_name in (("jax", jfluid, j_unique_name),
                                   ("torch", tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with unique_name.guard({}), pkg.program_guard(main, startup):
            loss = net(pkg)
            pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
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
        losses[name] = [float(np.asarray(exe.run(
            main, feed=f, fetch_list=[loss.name], scope=scope)[0])
            .reshape(-1)[0]) for f in feeds]
    return losses["jax"], losses["torch"], main


@pytest.mark.parametrize("fused", [False, True])
def test_stacked_lstm_trajectory_matches_jax(fused):
    rng = np.random.RandomState(0)
    feeds = [_sentiment(8, 16, 200, rng) for _ in range(5)]
    t_flags.set_flag("use_pallas_lstm", fused)
    try:
        jl, tl, main = _train_both(_stacked, feeds, 0.01)
    finally:
        t_flags.set_flag("use_pallas_lstm", False)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert np.isfinite(tl).all()
    shapes = {p.name: tuple(p.shape)
              for p in main.global_block().all_parameters()}
    assert shapes["lstm_0.w_0"] == (16, 64)
    assert shapes["lstm_0.w_1"] == (1, 112)   # 4D gate bias + 3 peepholes


def test_machine_translation_trajectory_matches_jax():
    jl, tl, main = _train_both(_mt, [_mt_feed(seed=s) for s in range(3)],
                               0.01)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    shapes = {p.name: tuple(p.shape)
              for p in main.global_block().all_parameters()}
    assert shapes["mt_enc_rev_w"] == (8, 32)
    assert shapes["mt_enc_rev_b"] == (1, 32)  # no peepholes


def test_stacked_lstm_converges():
    """The port's twin of tests/test_models_rnn.py:24."""
    seq_len, dict_size = 16, 200
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        loss, _, extras = t_stacked.build(seq_len=seq_len,
                                          dict_size=dict_size, emb_dim=16,
                                          hid_dim=16, stacked_num=2)
        tfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    losses, accs = [], []
    for _ in range(30):
        lv, acc = exe.run(main, feed=_sentiment(32, seq_len, dict_size, rng),
                          fetch_list=[loss, extras["accuracy"]], scope=scope)
        losses.append(float(np.asarray(lv).ravel()[0]))
        accs.append(float(np.asarray(acc).ravel()[0]))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])
    assert np.mean(accs[-5:]) > 0.8, accs
