"""Speculative decode as a whole: the PyTorch port's draft-then-verify
``SlotDecodeSession`` against the JAX package's, on the CPU.

- ``chain_tree``, ``tree_from_parents`` and ``NgramDrafter`` equal the JAX
  package's on the same inputs;
- the verify program, the draft decoder's programs and every other
  program of ``build_paged_slot_decoder(speculative=3)`` equal the JAX
  ones op for op (types, slots, variable names, attrs);
- on a tiny Transformer trained in the JAX package on a copy task (so the
  drafters get acceptances) and carried across with ``convert``: the
  port's speculative session (k = 3, n-gram and model drafters) streams
  tokens EQUAL to its own ``FLAGS_speculative=off`` run and to the JAX
  speculative session's, with equal ``spec_dispatches``,
  ``spec_proposed`` and ``spec_accepted``, and leaves the pool drained;
- a fork group under speculation decodes what solo admissions decode,
  with real copy-on-write pairs dispatched and every page recycled, and a
  failed ``admit_group`` leaves the pool and the slot order unchanged.

Token streams and counters are integers and compared exactly: on the CPU
both of the port's paths run the kernels' plain versions.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import flags as j_flags
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.serving import speculative as j_spec
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu.testing import set_deterministic_params as j_set_params
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import (
    draft_params_from_numpy,
    params_from_numpy,
)
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.serving import speculative as t_spec
from paddle_tpu_torch.serving.generation import (
    NoFreeGroupError,
    NoFreePageError,
    NoFreeSlotError,
)
from paddle_tpu_torch.serving.generation import SlotDecodeSession as TSession
from paddle_tpu_torch.testing import fresh_state

VOCAB, SEQ, D, K = 24, 8, 32, 3
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=1,
           n_head=2, d_inner=64)


@pytest.fixture(autouse=True)
def _fresh_state_and_flags():
    old_j, old_t = j_flags.get("speculative"), t_flags.get("speculative")
    with fresh_state():
        yield
    j_flags.set_flag("speculative", old_j)
    t_flags.set_flag("speculative", old_t)


# -- trees and drafters -------------------------------------------------------

def test_trees_equal_jax():
    for k in (1, 3, 5):
        for got, want in zip(t_spec.chain_tree(k), j_spec.chain_tree(k)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    for parents in ([-1], [-1, 0, 0, 1], [-1, 0, 1, 1, 0, 4]):
        np.testing.assert_array_equal(t_spec.tree_from_parents(parents),
                                      j_spec.tree_from_parents(parents))
    with pytest.raises(ValueError, match="anchor"):
        t_spec.tree_from_parents([0, 0])
    with pytest.raises(ValueError, match="precede"):
        t_spec.tree_from_parents([-1, 2, 1])


@pytest.mark.parametrize("order", [1, 3])
def test_ngram_drafter_equals_jax(order):
    rng = np.random.RandomState(order)
    states = {s: {"trg": rng.randint(3, 7, 16).astype("int64"),
                  "pos": int(rng.randint(0, 15))} for s in (0, 2, 3, 5)}
    states[2] = {"trg": np.array([1, 5, 6, 5, 6, 0, 0, 0]), "pos": 4}
    tdr = t_spec.NgramDrafter(num_slots=6, k=K, eos_id=2, order=order)
    jdr = j_spec.NgramDrafter(num_slots=6, k=K, eos_id=2, order=order)
    got = tdr.propose(states)
    np.testing.assert_array_equal(got, jdr.propose(states))
    if order == 3:
        np.testing.assert_array_equal(got[2], [5, 6, 2])
    assert (got[1] == 2).all() and (got[4] == 2).all()
    assert tdr.state_dict() == jdr.state_dict()
    tdr.forget(0)
    np.testing.assert_array_equal(tdr.propose(states), got)


# -- programs -----------------------------------------------------------------

def _signature(prog):
    return [(op.type,
             {k: list(v) for k, v in op.inputs.items() if v},
             {k: list(v) for k, v in op.outputs.items() if v},
             dict(op.attrs)) for op in prog.global_block().ops]


def _persistables(prog):
    return sorted(v.name for v in prog.global_block().vars.values()
                  if v.persistable)


def test_verify_and_draft_programs_equal_jax_op_for_op():
    kw = dict(max_length=SEQ, d_model=D, page_size=4, num_groups=2,
              speculative=K, **dict(CFG, n_layer=2))
    with j_unique_name.guard({}):
        jb = j_transformer.build_paged_slot_decoder(3, **kw)
    with t_unique_name.guard({}):
        tb = t_transformer.build_paged_slot_decoder(3, **kw)
    assert len(tb) == len(jb) == 8 and tb[7] == jb[7]
    names = ("init", "admit", "join", "prefill", "table", "step", "verify")
    for name, jp, tp in zip(names, jb, tb):
        assert _signature(tp) == _signature(jp), name
        assert _persistables(tp) == _persistables(jp), name
    verify = [op.type for op in tb[6].global_block().ops]
    assert verify.count("paged_tree_attention") == 2
    assert verify.count("paged_spec_kv_write") == 2
    assert verify.count("paged_spec_kv_compact") == 2
    assert verify.count("slot_speculative_accept") == 1
    dkw = dict(trg_vocab_size=VOCAB, max_length=SEQ, n_head=2, d_model=D,
               page_size=4)
    with j_unique_name.guard({}):
        jd = j_transformer.build_draft_decoder(3, **dkw)
    with t_unique_name.guard({}):
        td = t_transformer.build_draft_decoder(3, **dkw)
    assert td[3] == jd[3]
    for name, jp, tp in zip(("init", "step", "startup"), jd, td):
        assert _signature(tp) == _signature(jp), "draft " + name
    params = {p.name: tuple(p.shape)
              for p in td[1].global_block().all_parameters()}
    assert params == {p.name: tuple(p.shape)
                      for p in jd[1].global_block().all_parameters()}
    assert "trg_emb" in params and "draft_proj_logits.w_0" in params


def test_build_rejects_what_is_not_ported():
    # a beam build is ported: its step program equals the JAX package's
    # op for op; speculation with a beam is refused as the JAX package
    # refuses it
    with j_unique_name.guard({}):
        jbeam = j_transformer.build_paged_slot_decoder(2, beam_width=2)
    with t_unique_name.guard({}):
        tbeam = t_transformer.build_paged_slot_decoder(2, beam_width=2)
    assert tbeam[6] == jbeam[6]
    assert _signature(tbeam[5]) == _signature(jbeam[5])
    with pytest.raises(ValueError, match="compose"):
        t_transformer.build_paged_slot_decoder(2, beam_width=2,
                                               speculative=2)
    # a sampled speculative build is ported: its step and verify programs
    # equal the JAX package's op for op, the sampler's attrs included
    samp = {"strategy": "top_k", "top_k": 3, "temperature": 0.7, "seed": 4}
    with j_unique_name.guard({}):
        jb = j_transformer.build_paged_slot_decoder(2, speculative=2,
                                                    sampler=samp)
    with t_unique_name.guard({}):
        tb = t_transformer.build_paged_slot_decoder(2, speculative=2,
                                                    sampler=samp)
    for jp, tp in ((jb[5], tb[5]), (jb[6], tb[6])):
        assert _signature(tp) == _signature(jp)
    accept = [op for op in tb[6].global_block().ops
              if op.type == "slot_speculative_accept"][0]
    assert (accept.attrs["strategy"], accept.attrs["top_k"],
            accept.attrs["base_seed"]) == ("top_k", 3, 4)
    with pytest.raises(ValueError, match="top_k >= 1"):
        t_transformer.build_paged_slot_decoder(
            2, speculative=2, sampler={"strategy": "top_k"})
    with pytest.raises(ValueError, match=">= 0"):
        t_transformer.build_paged_slot_decoder(2, speculative=-1)


# -- sessions -----------------------------------------------------------------

def _build(pkg, unique_name, transformer):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        transformer.build(dropout=0.0, label_smooth_eps=0.0, max_length=SEQ,
                          d_model=D, **CFG)
    return main


@pytest.fixture(scope="module")
def models():
    """The JAX model trained 80 Adam steps on a copy task from
    ``set_deterministic_params`` weights (as tests/test_torch_serving.py
    does), plus the JAX model drafter's own parameters, all carried into
    the port's scope."""
    jmain = _build(jfluid, j_unique_name, j_transformer)
    train, train_startup = jfluid.Program(), jfluid.Program()
    with j_unique_name.guard({}), jfluid.program_guard(train, train_startup):
        loss, _, _ = j_transformer.build(
            dropout=0.0, label_smooth_eps=0.0, max_length=SEQ, d_model=D,
            **CFG)
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(train_startup, scope=jscope)
    j_set_params(jmain, jscope)
    rng = np.random.RandomState(22)
    for _ in range(80):
        src = rng.randint(3, VOCAB, (16, SEQ)).astype("int64")
        trg = np.full_like(src, 1)
        trg[:, 1:] = src[:, :-1]
        jexe.run(train, feed={
            "src_word": src, "src_len": np.full((16, 1), SEQ, "int64"),
            "trg_word": trg, "trg_len": np.full((16, 1), SEQ, "int64"),
            "label": src}, fetch_list=[loss], scope=jscope)
    # a JAX model-drafter session leaves the draft's parameters in jscope
    _session(JSession, jexe, jscope, "model")
    with fresh_state():
        tmain = _build(tfluid, t_unique_name, t_transformer)
        tscope = TScope()
        params_from_numpy(tmain, tscope, {
            p.name: np.asarray(jscope.get_value(p.name))
            for p in jmain.global_block().all_parameters()}, "cpu")
        draft = {n: np.asarray(jscope.get_value(n))
                 for n in jscope.local_var_names() if n.startswith("draft_")}
        assert len(draft) == 16
        draft_params_from_numpy(
            tscope, draft, "cpu", num_slots=3, trg_vocab_size=VOCAB,
            max_length=SEQ, n_head=2, d_model=D, page_size=4)
    src = rng.randint(3, VOCAB, (5, SEQ)).astype("int64")
    src[1, 3:] = src[1, :5]  # repeats inside a source: n-gram matches
    src_len = np.asarray([[SEQ], [SEQ - 3], [SEQ - 1], [2], [SEQ]], "int64")
    return {"jexe": jexe, "jscope": jscope,
            "texe": tfluid.Executor(tfluid.CPUPlace()), "tscope": tscope,
            "src": src, "src_len": src_len}


def _session(cls, exe, scope, drafter="ngram", **kw):
    args = dict(num_slots=3, max_length=SEQ, d_model=D, paged=True,
                page_size=4, steps=1, scope=scope,
                speculative={"k": K, "drafter": drafter})
    args.update(CFG)
    args.update(kw)
    return cls(exe, **args)


def _counters(sess):
    return (sess.spec_dispatches, sess.spec_proposed, sess.spec_accepted)


def _record_proposals(sess):
    """Every ``[S, k]`` draft the session's drafter proposes from now on."""
    drafts, propose = [], sess._spec_drafter.propose

    def recording(states):
        drafts.append(propose(states))
        return drafts[-1]

    sess._spec_drafter.propose = recording
    return drafts


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_speculative_streams_equal_off_oracle_and_jax(models, drafter):
    m = models
    t_flags.set_flag("speculative", "on")
    j_flags.set_flag("speculative", "on")
    tsess = _session(TSession, m["texe"], m["tscope"], drafter)
    t_drafts = _record_proposals(tsess)
    on = tsess.generate(m["src"], m["src_len"])
    counters = _counters(tsess)
    assert counters[0] > 0 and counters[1] > 0
    if drafter == "ngram":
        # the draft transformer is untrained (random weights carried from
        # the JAX scope) and sees no source: it may land nothing
        assert tsess.spec_accepted > 0, "the drafter never landed a token"
    assert tsess.pages_in_use == 0 and tsess.pool_conserved
    assert tsess.free_slots == 3
    # the same session, sequential: FLAGS_speculative flips mid-session
    t_flags.set_flag("speculative", "off")
    off = tsess.generate(m["src"], m["src_len"])
    assert _counters(tsess) == counters  # no verify dispatch ran
    np.testing.assert_array_equal(on, off)
    assert (on[:, 0] == 1).all()
    jsess = _session(JSession, m["jexe"], m["jscope"], drafter)
    j_drafts = _record_proposals(jsess)
    want = jsess.generate(m["src"], m["src_len"])
    np.testing.assert_array_equal(on, want)
    assert counters == _counters(jsess)
    # both packages' drafters proposed the same tokens at every dispatch
    assert len(t_drafts) >= len(j_drafts) == counters[0]
    for got, ref in zip(t_drafts, j_drafts):
        np.testing.assert_array_equal(got, ref)


def test_int_speculative_means_the_ngram_drafter(models):
    m = models
    sess = _session(TSession, m["texe"], m["tscope"], speculative=2)
    assert sess._spec_drafter.kind == "ngram" and sess._spec_drafter.k == 2
    out = sess.generate(m["src"][:2], m["src_len"][:2])
    plain = TSession(m["texe"], num_slots=3, max_length=SEQ, d_model=D,
                     paged=True, page_size=4, scope=m["tscope"], **CFG)
    np.testing.assert_array_equal(
        out, plain.generate(m["src"][:2], m["src_len"][:2]))
    # each dispatch commits 1 to k + 1 tokens per live slot
    tokens = sum(int((row[1:] != 2).sum()) + 1 for row in out)
    assert sess.spec_dispatches <= tokens


def test_speculative_argument_checks(models):
    m = models
    with pytest.raises(ValueError, match="steps=1"):
        _session(TSession, m["texe"], m["tscope"], steps=2)
    with pytest.raises(ValueError, match="'ngram' or 'model'"):
        _session(TSession, m["texe"], m["tscope"], "oracle")
    with pytest.raises(ValueError, match=">= 0"):
        _session(TSession, m["texe"], m["tscope"], speculative=-2)
    # the prefix cache composes with speculative decode, as in the JAX
    # package
    sess = _session(TSession, m["texe"], m["tscope"], prefix_cache_pages=4)
    assert sess.prefix_cache_stats() == {
        "lookups": 0, "hits": 0, "hit_rate": 0.0, "tokens_saved": 0,
        "pages": 0}


def test_model_drafter_keeps_trained_params_and_copies_its_own(models):
    m = models
    before = m["tscope"].get_value("trg_emb").clone()
    sess = _session(TSession, m["texe"], m["tscope"], "model")
    drafter = sess._spec_drafter
    assert (m["tscope"].get_value("trg_emb") == before).all()
    arrays = drafter.param_arrays()
    assert sorted(arrays) == drafter._param_names and len(arrays) == 16
    name = "draft_proj_logits.w_1"
    np.testing.assert_array_equal(
        arrays[name], np.asarray(m["jscope"].get_value(name)))
    # host COPIES: an in-place update of the tensor leaves the array alone
    m["tscope"].get_value(name).add_(1.0)
    assert not np.array_equal(arrays[name],
                              m["tscope"].get_value(name).numpy())
    drafter.load_param_arrays(arrays)
    np.testing.assert_array_equal(m["tscope"].get_value(name), arrays[name])


def _drain(sess, slots):
    done = {}
    for _ in range(40):
        done.update(sess.step())
        if len(done) >= len(slots):
            return done
    raise AssertionError("the slots did not finish")


@pytest.mark.parametrize("spec", ["on", "off"])
def test_fork_group_equals_solo_admissions(models, spec):
    """Two forks of one source and one forced prefix share the prefix's
    page until the first write splits it: real (src, dst) pairs ride the
    COW dispatch, both members decode what a solo admission decodes, in
    both packages, and every page is recycled."""
    m = models
    t_flags.set_flag("speculative", spec)
    j_flags.set_flag("speculative", spec)
    prefix = [5, 9]
    out = {}
    for name, cls, exe, scope in (("jax", JSession, m["jexe"], m["jscope"]),
                                  ("torch", TSession, m["texe"],
                                   m["tscope"])):
        sess = _session(cls, exe, scope, num_groups=2)
        slots = sess.admit_group(m["src"][0], n=2, src_len=SEQ,
                                 prefix_tokens=prefix)
        assert slots == [0, 1] and sess.shared_pages == 1
        done = _drain(sess, slots)
        assert sess.cow_pairs == 1  # N sharers cost N - 1 copies
        assert sess.pages_in_use == 0 and sess.pool_conserved
        assert sess.free_slots == 3
        solo = _session(cls, exe, scope)
        s = solo.admit(m["src"][0], SEQ, prefix_tokens=prefix)
        want = _drain(solo, [s])[s]
        for slot in slots:
            np.testing.assert_array_equal(done[slot], want)
        out[name] = want
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_fork_group_without_prefix_shares_only_the_cross_group(models):
    m = models
    sess = _session(TSession, m["texe"], m["tscope"], num_groups=2)
    slots = sess.admit_group(m["src"][2], n=3, src_len=SEQ - 1)
    assert sess.shared_pages == 0 and len(sess._free_groups) == 1
    done = _drain(sess, slots)
    want = _session(TSession, m["texe"], m["tscope"]).generate(
        m["src"][2:3], m["src_len"][2:3])[0]
    for slot in slots:
        np.testing.assert_array_equal(done[slot], want)
    assert sess.cow_pairs == 0 and len(sess._free_groups) == 2
    assert sess.pages_in_use == 0 and sess.pool_conserved


def test_failed_admit_group_rolls_back(models):
    """A join dispatch that raises after member 0 was admitted: the table
    rows go back to the trash page, every page and the group are free
    again, and the next admission takes the same slots."""
    m = models
    sess = _session(TSession, m["texe"], m["tscope"], num_groups=2)
    first = sess.admit(m["src"][1], m["src_len"][1])
    state = (sess.pages_in_use, sess.free_pages, sess.free_slots,
             list(sess._free_groups), sess._reserved_pages)
    real_run = sess._run

    def failing_run(prog, feed, fetch_list):
        if prog is sess._join_prog:
            raise RuntimeError("join dispatch failed")
        return real_run(prog, feed, fetch_list)

    sess._run = failing_run
    with pytest.raises(RuntimeError, match="join dispatch failed"):
        sess.admit_group(m["src"][0], n=2, src_len=SEQ, prefix_tokens=[5, 9])
    sess._run = real_run
    assert state == (sess.pages_in_use, sess.free_pages, sess.free_slots,
                     list(sess._free_groups), sess._reserved_pages)
    assert sess.pool_conserved and sess.active_slots == [first]
    table = m["tscope"].get_value("pgd_table").numpy()
    assert (table[1:] == 0).all()
    assert sess.admit_group(m["src"][0], n=2, src_len=SEQ) == [1, 2]
    # typed rejects leave the session as it was, too
    with pytest.raises(NoFreeSlotError):
        sess.admit(m["src"][3], m["src_len"][3])
    done = _drain(sess, [0, 1, 2])
    assert sorted(done) == [0, 1, 2] and sess.pages_in_use == 0
    small = _session(TSession, m["texe"], m["tscope"], num_groups=1,
                     num_pages=3)
    small.admit(m["src"][0], SEQ)
    with pytest.raises(NoFreeGroupError):
        small.admit(m["src"][1], SEQ)
    two = _session(TSession, m["texe"], m["tscope"], num_pages=5)
    with pytest.raises(NoFreePageError):
        two.admit_group(m["src"][0], n=3, src_len=SEQ)
    assert two.free_slots == 3 and two.pages_in_use == 0
