"""Beam decode in the PyTorch port against the JAX package, on the CPU.

- the programs of ``build_paged_slot_decoder(beam_width=4)`` equal the
  JAX package's op for op (types, slots, variable names, attrs), with the
  same fetch dict, and the builder refuses what the JAX one refuses;
- on a tiny Transformer trained in the JAX package on a copy task and
  carried across with ``convert.params_from_numpy``:
  - each dispatch's in-graph ``slot_beam_search`` selection equals the
    port's ``beam_step`` replayed offline on the step's own fetched
    logits, bit for bit;
  - the rebind reorder equals the ``FLAGS_beam_reorder=reference`` copy
    oracle bit for bit at staggered admissions, moving 0 pages;
  - both packages' beam sessions give the same n-best tokens, scores
    within 1e-5, at staggered admissions and with ``len_penalty``;
  - copy-on-write pairs coalesce into one dispatch a step window, a
    cancel of any hypothesis frees the whole lane, the typed rejects are
    the JAX package's, and a forced prefix's pages are stored once;
  - ``beam_generate``, ``cached_greedy_generate`` and
    ``cached_beam_generate`` equal the JAX package's (the twins of
    ``tests/test_attention.py``'s cached-decode cases).

The decode snapshot and ``ckpt_inspect`` cases of
``tests/test_beam_decode.py`` wait for the port's snapshots (ROADMAP A).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.ops.beam_search_ops import beam_step
from paddle_tpu_torch.serving.generation import (
    NoFreeSlotError,
    Sampler,
)
from paddle_tpu_torch.serving.generation import SlotDecodeSession as TSession
from paddle_tpu_torch.testing import fresh_state

VOCAB, SEQ, D, S, BW = 26, 12, 32, 8, 4
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=2,
           n_head=2, d_inner=64)
# the copy oracle's fresh page lists need free-page headroom
PAGES = 1 + 2 * S * (SEQ // 4 + 1)


def _signature(prog):
    return [(op.type,
             {k: list(v) for k, v in op.inputs.items() if v},
             {k: list(v) for k, v in op.outputs.items() if v},
             dict(op.attrs)) for op in prog.global_block().ops]


def _persistables(prog):
    return sorted(v.name for v in prog.global_block().vars.values()
                  if v.persistable)


@pytest.fixture(autouse=True)
def _fresh_state_and_flags():
    old_j, old_t = j_flags.get("beam_reorder"), t_flags.get("beam_reorder")
    with fresh_state():
        yield
    j_flags.set_flag("beam_reorder", old_j)
    t_flags.set_flag("beam_reorder", old_t)


def _copy_batch(rng, bs):
    src = rng.randint(3, VOCAB, (bs, SEQ)).astype("int64")
    trg = np.full_like(src, 1)
    trg[:, 1:] = src[:, :-1]
    lens = np.full((bs, 1), SEQ, "int64")
    return {"src_word": src, "src_len": lens, "trg_word": trg,
            "trg_len": lens, "label": src}


@pytest.fixture(scope="module")
def trained():
    """A 2-layer JAX Transformer trained 24 Adam steps on a copy task
    from seeded weights, its parameters carried into a port scope, and
    the inference programs of both packages."""
    jmain, jstart = jfluid.Program(), jfluid.Program()
    with j_unique_name.guard({}), jfluid.program_guard(jmain, jstart):
        jloss, _, jextras = j_transformer.build(
            dropout=0.0, label_smooth_eps=0.0, max_length=SEQ, d_model=D,
            **CFG)
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(jloss)
    jinfer = j_transformer.build_inference(jmain, jextras["logits"])
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    params = [p.name for p in jmain.global_block().all_parameters()]
    rng = np.random.RandomState(44)
    for name in params:  # seeded weights, moments untouched
        jscope.set_value(name, (0.1 * rng.randn(*np.shape(
            jscope.get_value(name)))).astype("float32"))
    for _ in range(24):
        jexe.run(jmain, feed=_copy_batch(rng, 16), fetch_list=[jloss],
                 scope=jscope)
    with fresh_state():
        tmain, tstart = tfluid.Program(), tfluid.Program()
        with t_unique_name.guard({}), tfluid.program_guard(tmain, tstart):
            _, _, textras = t_transformer.build(
                dropout=0.0, label_smooth_eps=0.0, max_length=SEQ,
                d_model=D, **CFG)
        tinfer = t_transformer.build_inference(tmain, textras["logits"])
        tscope = TScope()
        params_from_numpy(tmain, tscope, {
            n: np.asarray(jscope.get_value(n)) for n in params}, "cpu")
    src = rng.randint(3, VOCAB, (4, SEQ)).astype("int64")
    # one JAX beam session for the tests that compare with it (each
    # leaves it drained)
    jsess = _beam(JSession, jexe, jscope)
    return {"jexe": jexe, "jscope": jscope, "jinfer": jinfer, "jsess": jsess,
            "jlogits": jextras["logits"].name,
            "texe": tfluid.Executor(tfluid.CPUPlace()), "tscope": tscope,
            "tinfer": tinfer, "tlogits": textras["logits"].name,
            "src": src}


def _beam(cls, exe, scope, **kw):
    args = dict(num_slots=S, max_length=SEQ, d_model=D, paged=True,
                page_size=4, beam_width=BW, num_pages=PAGES,
                scope=scope.new_scope())
    args.update(CFG)
    args.update(kw)
    return cls(exe, **args)


def _tbeam(trained, **kw):
    return _beam(TSession, trained["texe"], trained["tscope"], **kw)


def _staggered(sess, src):
    """Two beams admitted 3 dispatches apart, then a third on its own:
    the reorder, COW and release paths at mixed lane ages."""
    a = sess.admit_beam(src[0], SEQ)
    ra = sess.register_beam_owner(a)
    for _ in range(3):
        sess.step()
    b = sess.admit_beam(src[1], SEQ - 2)
    rb = sess.register_beam_owner(b)
    while sess.active_beams:
        sess.step()
    out = [sess.take_beam_result(ra), sess.take_beam_result(rb)]
    out.append(dict(zip(("tokens", "scores"),
                        sess.generate_beam(src[2], SEQ))))
    return out


# -- programs -----------------------------------------------------------------

def test_beam_programs_equal_jax():
    kw = dict(max_length=SEQ, d_model=D, page_size=4, beam_width=BW, **CFG)
    with j_unique_name.guard({}):
        jb = j_transformer.build_paged_slot_decoder(S, **kw)
    with t_unique_name.guard({}):
        tb = t_transformer.build_paged_slot_decoder(S, **kw)
    assert len(tb) == len(jb) == 7 and tb[6] == jb[6]
    assert sorted(tb[6]) == ["logits", "parent", "score", "token"]
    names = ("init", "admit", "join", "prefill", "table", "step")
    for name, jp, tp in zip(names, jb, tb):
        assert _signature(tp) == _signature(jp), name
        assert _persistables(tp) == _persistables(jp), name
    step_types = [op.type for op in tb[5].global_block().ops]
    assert step_types.count("slot_beam_search") == 1
    assert "slot_decode_sample" not in step_types
    assert "pgd_score" in _persistables(tb[5])


@pytest.mark.parametrize("kw,match", [
    (dict(beam_width=3), "tile"),
    (dict(beam_width=2, sampler={"strategy": "temperature",
                                 "temperature": 0.8}), "sampler"),
    (dict(beam_width=2, speculative=2), "compose"),
    (dict(beam_width=0), ">= 1"),
])
def test_beam_build_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        t_transformer.build_paged_slot_decoder(8, **kw)
    with pytest.raises(ValueError, match=match):
        j_transformer.build_paged_slot_decoder(8, **kw)


# -- the lattice --------------------------------------------------------------

def test_in_graph_selection_matches_offline_lattice(trained):
    """Each dispatch's fetched (token, parent, score) equals ``beam_step``
    run offline on the dispatch's own logits and the lane's pre-step
    state, bit for bit."""
    sess = _tbeam(trained)
    scope = sess._scope
    lane = sess.admit_beam(trained["src"][0], SEQ)
    slots = sess.beam_slots(lane)
    sess._extra_step_fetches = [sess._beam_fetches["logits"]]
    checked = 0
    for _ in range(SEQ):
        if lane not in sess._beam_live:
            break
        pre_tok = np.asarray(scope.get_value("pgd_tok")).reshape(-1)
        pre_done = np.asarray(scope.get_value("pgd_done")).reshape(-1)
        pre_score = np.asarray(scope.get_value("pgd_score")).reshape(-1)
        sess.step()
        logits = torch.from_numpy(
            sess.last_extra_fetches[0][:, 0, :].astype(np.float32))
        forced = np.where(pre_done > 0, sess._eos, pre_tok)
        logp = torch.log_softmax(logits[slots], dim=-1)
        tok, sel, parent = beam_step(
            torch.from_numpy(forced[slots].reshape(1, BW)),
            torch.from_numpy(pre_score[slots].reshape(1, BW)),
            logp.reshape(1, BW, -1), sess._eos, is_accumulated=False)
        ev = sess.last_beam_events.get(lane)
        if ev is None:  # the finishing step: its final chunk
            fin = sess.last_finished_beams[lane]
            got = (fin["step_tokens"], fin["parents"], fin["step_scores"])
        else:
            got = (ev["tokens"], ev["parents"], ev["scores"])
        np.testing.assert_array_equal(tok.numpy().reshape(-1), got[0])
        np.testing.assert_array_equal(parent.numpy().reshape(-1), got[1])
        np.testing.assert_array_equal(sel.numpy().reshape(-1),
                                      np.asarray(got[2], np.float32))
        checked += 1
    assert checked >= 3, "the lattice was never compared over a decode"


# -- the reorder --------------------------------------------------------------

def test_rebind_matches_copy_oracle_and_moves_zero_pages(trained):
    src = trained["src"]
    swap = _tbeam(trained)
    got = _staggered(swap, src)
    assert swap.beam_reorder_pages == 0
    assert swap.pool_conserved and swap.pages_in_use == 0
    t_flags.set_flag("beam_reorder", "reference")
    copy_sess = _tbeam(trained)
    ref = _staggered(copy_sess, src)
    assert copy_sess.beam_reorder_pages > 0, "the oracle copied no page"
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["tokens"], r["tokens"])
        np.testing.assert_array_equal(g["scores"], r["scores"])
    assert copy_sess.pool_conserved and copy_sess.pages_in_use == 0


def test_beam_sessions_equal_jax(trained):
    """The port's and the JAX package's beam sessions on the same weights:
    equal n-best tokens, scores within 1e-5, staggered admissions."""
    src = trained["src"]
    got = _staggered(_tbeam(trained), src)
    want = _staggered(trained["jsess"], src)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5,
                                   rtol=0)
    assert len({tuple(row) for row in got[0]["tokens"]}) > 1, \
        "the hypotheses never diverged"


def test_len_penalty_rescoring_equals_jax(trained):
    src = trained["src"]
    ts, js = _tbeam(trained), trained["jsess"]
    tt, tsc = ts.generate_beam(src[3], SEQ, len_penalty=0.6)
    jt, jsc = js.generate_beam(src[3], SEQ, len_penalty=0.6)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_allclose(tsc, jsc, atol=1e-5, rtol=0)
    raw_t, raw_s = ts.generate_beam(src[3], SEQ)
    order, toks, pen = t_transformer.gnmt_rescore_nbest(raw_t, raw_s, 2, 0.6)
    np.testing.assert_array_equal(toks, tt)
    np.testing.assert_array_equal(pen, tsc)
    jorder = j_transformer.gnmt_rescore_nbest(raw_t, raw_s, 2, 0.6)[0]
    np.testing.assert_array_equal(order, jorder)


def test_cow_dispatches_coalesce_per_step_window(trained):
    """Copy-on-write pairs multiply per beam step, dispatches do not: at
    most one coalesced dispatch a step window, with the JAX session's
    counts on the same weights."""
    sess = _tbeam(trained)
    jsess = trained["jsess"]
    before = (jsess.cow_pairs, jsess.cow_dispatches, jsess.steps_done)
    _staggered(sess, trained["src"])
    _staggered(jsess, trained["src"])
    assert (sess.cow_pairs, sess.cow_dispatches, sess.steps_done) == tuple(
        a - b for a, b in zip((jsess.cow_pairs, jsess.cow_dispatches,
                               jsess.steps_done), before))
    assert sess.cow_pairs > sess.cow_dispatches, (
        "no coalescing: %d pairs took %d dispatches"
        % (sess.cow_pairs, sess.cow_dispatches))
    assert sess.cow_dispatches <= sess.steps_done
    assert sess.beam_cow_copies == sess.cow_pairs


def test_cancel_releases_whole_beam_and_conserves(trained):
    sess = _tbeam(trained)
    lane = sess.admit_beam(trained["src"][0], SEQ)
    for _ in range(3):
        sess.step()
    slots = sess.beam_slots(lane)
    assert sess.cancel(slots[2])  # any member tears the whole beam down
    assert not sess.cancel(slots[0])
    assert not sess.active_beams and sess.free_beams == S // BW
    assert sess.free_slots == S and not sess.active_slots
    assert sess.pool_conserved and sess.pages_in_use == 0
    t1, s1 = sess.generate_beam(trained["src"][0], SEQ)
    t2, s2 = sess.generate_beam(trained["src"][0], SEQ)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(s1, s2)


def test_beam_admission_rejects_are_typed(trained):
    sess = _tbeam(trained)
    lanes = [sess.admit_beam(trained["src"][i % 4], SEQ)
             for i in range(S // BW)]
    with pytest.raises(NoFreeSlotError):
        sess.admit_beam(trained["src"][0], SEQ)
    for lane in lanes:
        sess.cancel(sess.beam_slots(lane)[0])
    assert sess.pool_conserved and sess.free_beams == S // BW
    with pytest.raises(ValueError, match="admit-or-reject"):
        sess.enqueue(trained["src"][0], SEQ)
    with pytest.raises(ValueError, match="admit_beam"):
        sess.admit_group(trained["src"][0], n=2)
    for kw in (dict(steps=2), dict(beam_width=3),
               dict(sampler=Sampler(strategy="temperature",
                                    temperature=0.8)),
               dict(paged=False), dict(speculative=2)):
        with pytest.raises(ValueError):
            _tbeam(trained, **kw)
    greedy = _tbeam(trained, beam_width=1)
    with pytest.raises(ValueError, match="beam session"):
        greedy.admit_beam(trained["src"][0], SEQ)
    assert greedy.take_beam_result(0) is None and greedy.free_beams == 0


def test_beam_shared_prefix_pages_count_once(trained):
    """A beam over a forced prefix references the prefix pages from every
    hypothesis: they are stored once."""
    sess = _tbeam(trained)
    pfx = [int(t) for t in trained["src"][0][:7]]
    lane = sess.admit_beam(trained["src"][0], SEQ, prefix_tokens=pfx)
    assert sess.shared_pages >= 1
    full_prefix_pages = len(pfx) // 4
    assert sess.pages_in_use < BW * (full_prefix_pages + 1) + 2
    while lane in sess.active_beams:
        sess.step()
    assert sess.pool_conserved and sess.pages_in_use == 0


# -- the offline beam API -----------------------------------------------------

def test_beam_generate_equals_jax(trained):
    src = trained["src"]
    src_len = np.asarray([[SEQ], [SEQ - 3], [SEQ - 1], [2]], "int64")
    got = t_transformer.beam_generate(
        trained["texe"], trained["tinfer"], trained["tlogits"], src,
        src_len, SEQ, beam_size=3, scope=trained["tscope"])
    with jfluid.scope_guard(trained["jscope"]):
        want = j_transformer.beam_generate(
            trained["jexe"], trained["jinfer"], trained["jlogits"], src,
            src_len, SEQ, beam_size=3)
    np.testing.assert_array_equal(got, want)


def test_cached_greedy_and_beam_equal_full_and_jax(trained):
    """``cached_greedy_generate`` equals ``greedy_generate`` and
    ``cached_beam_generate`` equals ``beam_generate`` (the port's own
    full-prefix loops), and both equal the JAX package's cached runs."""
    K = 3
    src = trained["src"]
    src_len = np.asarray([[SEQ], [SEQ - 3], [SEQ - 1], [2]], "int64")
    cfg = dict(max_length=SEQ, d_model=D, **CFG)
    texe, tscope = trained["texe"], trained["tscope"]
    tprep, tstep, tlog = t_transformer.build_cached_decoder(4, **cfg)
    full = t_transformer.greedy_generate(
        texe, trained["tinfer"], trained["tlogits"], src, src_len, SEQ,
        scope=tscope)
    cached = t_transformer.cached_greedy_generate(
        texe, tprep, tstep, tlog, src, src_len, SEQ, D,
        scope=tscope.new_scope())
    np.testing.assert_array_equal(cached, full)
    bprep, bstep, blog = t_transformer.build_cached_decoder(4 * K, **cfg)
    reorder = t_transformer.build_cache_reorder(4 * K, SEQ, 2, 2, D)
    bscope = tscope.new_scope()
    tbeam = t_transformer.cached_beam_generate(
        texe, bprep, bstep, reorder, blog, src, src_len, SEQ, D,
        beam_size=K, scope=bscope)
    np.testing.assert_array_equal(tbeam, t_transformer.beam_generate(
        texe, trained["tinfer"], trained["tlogits"], src, src_len, SEQ,
        beam_size=K, scope=tscope))
    jexe = trained["jexe"]
    with jfluid.scope_guard(trained["jscope"].new_scope()):
        jprep, jstep, jlog = j_transformer.build_cached_decoder(4, **cfg)
        jgreedy = j_transformer.cached_greedy_generate(
            jexe, jprep, jstep, jlog, src, src_len, SEQ, D)
    with jfluid.scope_guard(trained["jscope"].new_scope()):
        jprep, jstep, jlog = j_transformer.build_cached_decoder(4 * K, **cfg)
        jreorder = j_transformer.build_cache_reorder(4 * K, SEQ, 2, 2, D)
        jbeam = j_transformer.cached_beam_generate(
            jexe, jprep, jstep, jreorder, jlog, src, src_len, SEQ, D,
            beam_size=K)
    np.testing.assert_array_equal(cached, jgreedy)
    np.testing.assert_array_equal(tbeam, jbeam)
    with j_unique_name.guard({}):
        jp = j_transformer.build_cached_decoder(4, **cfg)
    with t_unique_name.guard({}):
        tp = t_transformer.build_cached_decoder(4, **cfg)
    for a, b in zip(jp[:2], tp[:2]):
        assert _signature(b) == _signature(a)
