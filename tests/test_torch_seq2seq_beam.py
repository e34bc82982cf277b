"""The dense beam ops, the RNN family's remaining ops and the two RNN
beam generators of the PyTorch port against the JAX package, on the CPU.

- ``beam_search`` (per-step probabilities and accumulated scores) and
  ``beam_search_decode`` through both packages' programs, and against a
  per-row priority-queue reference (the twins of
  ``tests/test_seq2seq.py``'s op cases);
- ties: ``beam_step`` keeps ``jax.lax.top_k``'s lowest-index-first order
  on lattices whose result depends on it;
- ``lstm_unit``, ``gru_unit`` (integer activation codes and names),
  ``dynamic_lstmp`` (with and without peepholes and lengths),
  ``row_conv`` and ``attention_lstm_beam_decode``: equal programs,
  forward within rtol 1e-5 / atol 1e-6, and the gradients of a weighted
  sum of the outputs (the twins of ``tests/test_op_breadth_misc.py``'s
  cases and ``tests/test_check_grad_sweep.py::test_row_conv_grad``);
- ``machine_translation.build_generator`` on a JAX model trained on a
  copy task and carried across: equal programs, equal ids, scores within
  1e-5;
- the book's ``rnn_encoder_decoder.decoder_decode`` built through both
  packages on ``set_deterministic_params`` weights: equal programs, equal
  ids, scores within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.ops import beam_search_ops as j_beam
from paddle_tpu.testing import set_deterministic_params as j_set_params
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.models import rnn_encoder_decoder as red
from paddle_tpu_torch.ops import beam_search_ops as t_beam
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.testing import set_deterministic_params as t_set_params
from test_torch_tensor_ops import case, check_case, run_case


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _rng(seed):
    return np.random.RandomState(seed)


def _op(op_type, slots, out_slots, **attrs):
    """A build that appends ``op_type`` with each input slot bound to the
    data var of the same name (lower-cased)."""
    def build(pkg, vs):
        blk = pkg.default_main_program().global_block()
        outs = [blk.create_var(name="out_" + s.lower()) for s in out_slots]
        blk.append_op(type=op_type,
                      inputs={s: [s.lower()] for s in slots},
                      outputs={s: [v.name] for s, v in zip(out_slots, outs)},
                      attrs=attrs)
        return outs
    return build


def _feeds(**arrays):
    return {k.lower(): v for k, v in arrays.items()}


# -- the dense beam step ------------------------------------------------------

def _numpy_beam_step(pre_ids, pre_scores, logp, end_id):
    """A per-row priority-queue reference (stable: ties keep the
    candidate order, i.e. the lowest flat index first)."""
    B, K = pre_ids.shape
    V = logp.shape[2]
    sel_ids = np.zeros((B, K), np.int64)
    sel_scores = np.zeros((B, K), np.float32)
    parents = np.zeros((B, K), np.int64)
    for b in range(B):
        cands = []
        for k in range(K):
            if pre_ids[b, k] == end_id:
                cands.append((pre_scores[b, k], k, end_id))
            else:
                for v in range(V):
                    cands.append((pre_scores[b, k] + logp[b, k, v], k, v))
        cands.sort(key=lambda t: -t[0])
        for k, (s, p, v) in enumerate(cands[:K]):
            sel_scores[b, k], parents[b, k], sel_ids[b, k] = s, p, v
    return sel_ids, sel_scores, parents


def _beam_search_case(accumulated):
    rng = _rng(0 if not accumulated else 1)
    B, K, V, end_id = 3, 4, 11, 0
    pre_ids = rng.randint(0 if not accumulated else 1, V,
                          (B, K)).astype(np.int64)
    if not accumulated:
        pre_ids[0, 1] = end_id  # one finished beam
    pre_scores = rng.randn(B, K).astype(np.float32)
    logp = np.log(rng.dirichlet(np.ones(V), size=(B, K)).astype(np.float32))
    scores = (pre_scores[:, :, None] + logp if accumulated
              else np.exp(logp)).astype(np.float32)
    build = (lambda pkg, vs: list(pkg.layers.beam_search(
        vs["pi"], vs["ps"], vs["sc"], beam_size=K, end_id=end_id,
        is_accumulated=accumulated)))
    return (case(build, {"pi": pre_ids, "ps": pre_scores, "sc": scores},
                 grad=False),
            _numpy_beam_step(pre_ids, pre_scores, logp, end_id))


@pytest.mark.parametrize("accumulated", [False, True])
def test_beam_search_op_matches_jax_and_numpy(accumulated):
    c, want = _beam_search_case(accumulated)
    check_case(c)
    (_, _), (_, got) = run_case(c)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=2e-5, atol=2e-5)
    if not accumulated:
        np.testing.assert_array_equal(got[2], want[2])


def test_beam_search_decode_backtrack():
    """The hand-built ``[T=3, B=1, K=2]`` lattice of test_seq2seq.py."""
    ids = np.array([[[5, 6]], [[7, 8]], [[9, 3]]], np.int64)
    parents = np.array([[[0, 1]], [[1, 0]], [[0, 0]]], np.int64)
    step_scores = np.array([[[0.5, 0.6]], [[0.7, 0.8]], [[0.9, 0.3]]],
                           np.float32)
    c = case(lambda pkg, vs: list(pkg.layers.beam_search_decode(
        vs["ids"], vs["par"], scores=vs["sc"], beam_size=2)),
        {"ids": ids, "par": parents, "sc": step_scores}, grad=False)
    check_case(c)
    (_, _), (_, (sent, sent_scores)) = run_case(c)
    np.testing.assert_array_equal(sent[0], [[6, 7, 9], [6, 7, 3]])
    np.testing.assert_allclose(sent_scores[0], [[0.6, 0.7, 0.9],
                                                [0.6, 0.7, 0.3]], rtol=1e-6)
    c0 = case(lambda pkg, vs: list(pkg.layers.beam_search_decode(
        vs["ids"], vs["par"], beam_size=2)),
        {"ids": ids, "par": parents}, grad=False)
    check_case(c0)


def _tie_lattices():
    """(pre_ids, pre_scores, scores [B, K, V], end_id) whose top-K cuts
    through runs of equal candidates."""
    K, V, end = 3, 6, 2
    flat = np.zeros((1, K, V), np.float32)  # every candidate equal
    finished = np.full((1, K), end, np.int64)  # every beam finished
    fin_scores = np.array([[-1e9, -1e9, -1e9]], np.float32)
    mixed = np.round(_rng(3).randn(2, K, V), 0).astype(np.float32)
    mixed_ids = np.array([[1, 2, 4], [2, 2, 0]], np.int64)
    mixed_pre = np.array([[0.0, 0.0, -1e9], [-1e9, -1e9, 0.0]], np.float32)
    wide = np.full((2, 4, 500), -3.0, np.float32)  # long equal rows
    wide[:, :, 7] = -1.0
    return [
        (np.ones((1, K), np.int64), np.zeros((1, K), np.float32), flat, end),
        (finished, fin_scores, flat, end),
        (mixed_ids, mixed_pre, mixed, end),
        (np.ones((2, 4), np.int64), np.zeros((2, 4), np.float32), wide, end),
    ]


def test_beam_step_breaks_ties_lowest_index_first():
    """``torch.topk`` promises no order among equal values; ``beam_step``
    must return ``jax.lax.top_k``'s (lowest flat index first) wherever
    the lattice ties, finished beams' -1e9 rows included."""
    for pre_ids, pre_scores, scores, end in _tie_lattices():
        got = t_beam.beam_step(torch.from_numpy(pre_ids),
                               torch.from_numpy(pre_scores),
                               torch.from_numpy(scores), end)
        want = j_beam.beam_step(jnp.asarray(pre_ids, jnp.int32),
                                jnp.asarray(pre_scores),
                                jnp.asarray(scores), end)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # all equal: the first K flat indices, all from beam 0
    tok, _, parent = t_beam.beam_step(
        torch.ones((1, 3), dtype=torch.int64), torch.zeros((1, 3)),
        torch.zeros((1, 3, 6)), 2)
    assert tok.tolist() == [[0, 1, 2]] and parent.tolist() == [[0, 0, 0]]
    # every beam finished: each keeps its own (eos, score), in beam order
    tok, sc, parent = t_beam.beam_step(
        torch.full((1, 3), 2, dtype=torch.int64), torch.zeros((1, 3)),
        torch.zeros((1, 3, 6)), 2)
    assert tok.tolist() == [[2, 2, 2]] and parent.tolist() == [[0, 1, 2]]
    # ... unless their scores are the -1e9 fill itself: then every
    # candidate ties and the lowest flat indices win
    tok, sc, parent = t_beam.beam_step(
        torch.full((1, 3), 2, dtype=torch.int64),
        torch.full((1, 3), -1e9), torch.zeros((1, 3, 6)), 2)
    assert tok.tolist() == [[0, 1, 2]] and parent.tolist() == [[0, 0, 0]]


# -- the RNN family's remaining ops -------------------------------------------

def _lstmp_case(peepholes, lengths):
    rng = _rng(62)
    B, T, D, P = 2, 5, 4, 3
    ins = _feeds(
        Input=(0.5 * rng.randn(B, T, 4 * D)).astype("float32"),
        Weight=(0.3 * rng.randn(P, 4 * D)).astype("float32"),
        ProjWeight=(0.5 * rng.randn(D, P)).astype("float32"),
        Bias=(0.1 * rng.randn(1, (7 if peepholes else 4) * D)).astype(
            "float32"))
    slots = ["Input", "Weight", "ProjWeight", "Bias"]
    if lengths:
        ins["length"] = np.asarray([T, T - 2], "int64")
        slots.append("Length")
    return case(_op("dynamic_lstmp", slots, ("Projection", "Cell"),
                    use_peepholes=peepholes, proj_activation="tanh"), ins)


def _gru_unit_case(**attrs):
    rng = _rng(61)
    B, D = 3, 4
    return case(_op("gru_unit", ["Input", "HiddenPrev", "Weight", "Bias"],
                    ("Gate", "ResetHiddenPrev", "Hidden"), **attrs),
                _feeds(Input=rng.randn(B, 3 * D).astype("float32"),
                       HiddenPrev=rng.randn(B, D).astype("float32"),
                       Weight=(0.5 * rng.randn(D, 3 * D)).astype("float32"),
                       Bias=(0.1 * rng.randn(1, 3 * D)).astype("float32")))


def _beam_decode_case():
    rng = _rng(75)
    B, S, D, C, V, M = 2, 5, 3, 5, 11, 4
    ins = _feeds(
        EncoderVec=rng.randn(B, S, C).astype("float32"),
        EncoderProj=rng.randn(B, S, D).astype("float32"),
        H0=np.zeros((B, D), "float32"),
        StateProjW=(0.3 * rng.randn(D, D)).astype("float32"),
        AttnW=(0.3 * rng.randn(2 * D, 1)).astype("float32"),
        CellW=(0.3 * rng.randn(D + C + M, 4 * D)).astype("float32"),
        CellB=np.zeros((1, 4 * D), "float32"),
        Embedding=rng.randn(V, M).astype("float32"),
        OutW=(0.3 * rng.randn(D, V)).astype("float32"),
        OutB=np.zeros((1, V), "float32"),
        EncoderLen=np.asarray([S, S - 2], "int64"))
    return case(_op("attention_lstm_beam_decode", [
        "EncoderVec", "EncoderProj", "H0", "StateProjW", "AttnW", "CellW",
        "CellB", "Embedding", "OutW", "OutB", "EncoderLen"],
        ("SentenceIds", "SentenceScores"), beam_size=3, max_len=6,
        start_id=1, end_id=2), ins, grad=False)


RNN_CASES = {
    "lstm_unit": case(lambda pkg, vs: list(pkg.layers.lstm_unit(
        vs["x"], vs["c"], forget_bias=1.0)),
        {"x": _rng(60).randn(3, 16).astype("float32"),
         "c": _rng(160).randn(3, 4).astype("float32")}),
    "gru_unit_codes": _gru_unit_case(),
    "gru_unit_relu_identity": _gru_unit_case(activation=3,
                                             gate_activation=0),
    "gru_unit_names": _gru_unit_case(activation="relu",
                                     gate_activation="sigmoid"),
    "dynamic_lstmp": _lstmp_case(True, True),
    "dynamic_lstmp_no_peepholes": _lstmp_case(False, True),
    "dynamic_lstmp_full_length": _lstmp_case(True, False),
    "row_conv": case(_op("row_conv", ["X", "Filter"], ("Out",)),
                     _feeds(X=_rng(10).randn(2, 5, 3).astype("float32"),
                            Filter=_rng(11).randn(3, 3).astype("float32"))),
    "attention_lstm_beam_decode": _beam_decode_case(),
}


@pytest.mark.parametrize("name", sorted(RNN_CASES))
def test_rnn_op_matches_jax_forward_and_gradient(name):
    check_case(RNN_CASES[name])


def test_lstmp_padded_steps_carry_state_and_decode_sorts():
    (_, _), (_, (proj, _cell)) = run_case(_lstmp_case(False, True))
    np.testing.assert_array_equal(proj[1, 3], proj[1, 4])
    (_, _), (_, (ids, scores)) = run_case(_beam_decode_case())
    assert ids.shape == (2, 3, 6) and scores.shape == (2, 3)
    assert (np.diff(scores, axis=1) <= 0).all()


def test_rnn_layers_build_the_jax_programs():
    """The layers mint the JAX package's parameters and ops."""
    def build(pkg):
        L = pkg.layers
        x = L.data("x", shape=[5, 8])
        h = L.data("h", shape=[4])
        L.dynamic_lstmp(L.fc(x, 16, num_flatten_dims=2), 16, 3)
        L.gru_unit(L.fc(h, 12), h, 12)
        L.lstm_unit(L.fc(h, 16), h, forget_bias=0.5)
        L.row_conv(x, 2, act="relu")

    progs = []
    for pkg, un in ((jfluid, j_unique_name), (tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard({}), pkg.program_guard(main, startup):
            build(pkg)
        progs.append(main)
    ops = [[(op.type, op.inputs, op.outputs, dict(op.attrs))
            for op in p.global_block().ops] for p in progs]
    assert ops[1] == ops[0]
    params = [{p.name: tuple(p.shape)
               for p in m.global_block().all_parameters()} for m in progs]
    assert params[1] == params[0]


# -- the MT attention-LSTM generator ------------------------------------------

VOCAB, SEQ, WIDTH = 24, 8, 32
MT = dict(emb_dim=WIDTH, encoder_size=WIDTH, decoder_size=WIDTH)


def _mt_batch(rng, batch):
    """The copy task of test_seq2seq.py: target = source, lengths 2..6."""
    lens = rng.randint(2, SEQ - 1, (batch,))
    src = np.zeros((batch, SEQ), np.int64)
    tgt_in = np.zeros((batch, SEQ), np.int64)
    label = np.full((batch, SEQ), 2, np.int64)
    mask = np.zeros((batch, SEQ), np.float32)
    for i, ln in enumerate(lens):
        toks = rng.randint(3, VOCAB, (ln,))
        src[i, :ln] = toks
        tgt_in[i, 0] = 1
        tgt_in[i, 1:ln + 1] = toks[:SEQ - 1]
        label[i, :ln] = toks
        mask[i, :ln + 1] = 1.0
    return {"source_sequence": src,
            "source_length": lens.reshape(-1, 1).astype(np.int64),
            "target_sequence": tgt_in, "label": label, "label_mask": mask}


def _generator(pkg, unique_name, mt):
    prog, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(prog, startup):
        ids, scores, _ = mt.build_generator(
            src_vocab=VOCAB, tgt_vocab=VOCAB, src_seq_len=SEQ, beam_size=3,
            max_len=SEQ, start_id=1, end_id=2, **MT)
    return prog, ids, scores


def test_mt_beam_generation_equals_jax():
    from paddle_tpu.models import machine_translation as j_mt
    from paddle_tpu_torch.models import machine_translation as t_mt

    main, startup = jfluid.Program(), jfluid.Program()
    with j_unique_name.guard({}), jfluid.program_guard(main, startup):
        loss, _, _ = j_mt.build(src_vocab=VOCAB, tgt_vocab=VOCAB,
                                src_seq_len=SEQ, tgt_seq_len=SEQ, **MT)
        jfluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    rng = _rng(7)
    for p in main.global_block().all_parameters():  # moments untouched
        jscope.set_value(p.name, (0.1 * rng.randn(*np.shape(
            jscope.get_value(p.name)))).astype("float32"))
    for _ in range(20):
        jexe.run(main, feed=_mt_batch(rng, 16), fetch_list=[loss],
                 scope=jscope)
    batch = _mt_batch(_rng(11), 4)
    feed = {k: batch[k] for k in ("source_sequence", "source_length")}
    jprog, jids, jscores = _generator(jfluid, j_unique_name, j_mt)
    want = jexe.run(jprog, feed=feed, fetch_list=[jids, jscores],
                    scope=jscope)
    tprog, tids, tscores = _generator(tfluid, t_unique_name, t_mt)
    assert ([(op.type, op.inputs, op.outputs, dict(op.attrs))
             for op in tprog.global_block().ops]
            == [(op.type, op.inputs, op.outputs, dict(op.attrs))
                for op in jprog.global_block().ops])
    tscope = TScope()
    params_from_numpy(tprog, tscope, {
        p.name: np.asarray(jscope.get_value(p.name))
        for p in tprog.global_block().all_parameters()}, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tprog, feed=feed, fetch_list=[tids, tscores], scope=tscope)
    assert got[0].shape == (4, 3, SEQ) and got[1].shape == (4, 3)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    assert (np.diff(got[1], axis=1) <= 1e-5).all()


# -- the book's While beam decoder --------------------------------------------

def test_book_decoder_decode_equals_jax():
    B, K, T, V, S = 3, 2, 5, 40, 6
    rng = _rng(0)
    feed = {"src_word_id": rng.randint(1, V, (B, S)).astype("int64"),
            "src_length": np.array([[S], [3], [5]], "int64")}
    feed.update(red.init_beams(np, B, K, start_id=0))
    outs = []
    for pkg, un, scope_cls, set_params in (
            (jfluid, j_unique_name, JScope, j_set_params),
            (tfluid, t_unique_name, TScope, t_set_params)):
        main, startup = pkg.Program(), pkg.Program()
        with un.guard({}), pkg.program_guard(main, startup):
            ids, scores = red.build_decode(pkg, batch_size=B, max_src_len=S,
                                           dict_size=V, beam_size=K,
                                           max_length=T)
        scope = scope_cls()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, scope=scope)
        set_params(main, scope)
        vals = exe.run(main, feed=feed, fetch_list=[ids, scores],
                       scope=scope)
        outs.append(([(op.type, op.inputs, op.outputs, dict(op.attrs))
                      for op in main.global_block().ops],
                     [np.asarray(v) for v in vals]))
    (j_ops, (j_ids, j_sc)), (t_ops, (t_ids, t_sc)) = outs
    assert t_ops == j_ops
    assert [t for t, _, _, _ in t_ops].count("while") == 1
    assert t_ids.shape == (B, K, T + 1)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-5)
    assert (t_ids[:, :, 0] == 0).all()
