"""The port's prefix cache (``SlotDecodeSession(prefix_cache_pages=...)``)
against the JAX package's, on the same weights: the twins of
``tests/test_kv_reuse.py``'s ``test_prefix_cache_hit_bit_identical_and_skips_prefill``
and ``test_prefix_fork_shares_pages_until_cow_and_conserves`` (greedy:
the port's sampled decode waits for ROADMAP.md A6).

The model is the one ``tests/test_kv_reuse.py`` trains (2 layers, so
prefill writes and cached pages are exercised past layer 0; 25 Adam steps
on a copy task), carried into the port with ``convert.params_from_numpy``.
Tokens must be EQUAL: between a hit and the cold run of one session (the
same ops over the same K/V bits), and between the two packages (greedy
argmax of fp32 logits that agree to about 1e-6). Stats must equal the
JAX session's after the same calls.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu_torch import Executor, CPUPlace, Program, program_guard
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.serving.generation import SlotDecodeSession as TSession
from paddle_tpu_torch.testing import fresh_state

VOCAB, SEQ, D = 24, 8, 32
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=2,
           n_head=2, d_inner=64)


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


@pytest.fixture(scope="module")
def trained():
    """tests/test_kv_reuse.py's model (seed 31, 25 Adam steps) and the
    port's copy of it."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 31
    with j_unique_name.guard({}), jfluid.program_guard(main, startup):
        loss, _, _ = j_transformer.build(
            dropout=0.0, label_smooth_eps=0.0, max_length=SEQ, d_model=D,
            **CFG)
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    rng = np.random.RandomState(32)
    for _ in range(25):
        src = rng.randint(3, VOCAB, (16, SEQ)).astype("int64")
        trg = np.full_like(src, 1)
        trg[:, 1:] = src[:, :-1]
        jexe.run(main, feed={
            "src_word": src, "src_len": np.full((16, 1), SEQ, "int64"),
            "trg_word": trg, "trg_len": np.full((16, 1), SEQ, "int64"),
            "label": src}, fetch_list=[loss], scope=jscope)
    src = rng.randint(3, VOCAB, (4, SEQ)).astype("int64")
    with fresh_state():
        tmain = Program()
        with t_unique_name.guard({}), program_guard(tmain, Program()):
            t_transformer.build(dropout=0.0, label_smooth_eps=0.0,
                                max_length=SEQ, d_model=D, **CFG)
    tscope = TScope()
    params_from_numpy(tmain, tscope, {
        p.name: np.asarray(jscope.get_value(p.name))
        for p in main.global_block().all_parameters()}, "cpu")
    return {"jexe": jexe, "jscope": jscope, "texe": Executor(CPUPlace()),
            "tscope": tscope, "src": src}


def _paged(cls, exe, scope, **kw):
    args = dict(num_slots=4, max_length=SEQ, d_model=D, paged=True,
                page_size=4, steps=2, scope=scope)
    args.update(CFG)
    args.update(kw)
    return cls(exe, **args)


def _both(trained, **kw):
    return (_paged(JSession, trained["jexe"], trained["jscope"], **kw),
            _paged(TSession, trained["texe"], trained["tscope"], **kw))


def _prefills(sess):
    """Spy on the session's runs: the ``write_from`` of every prefill."""
    seen = []
    run = sess._run

    def spy(prog, feed, fetch_list):
        if prog is sess._prefill_prog:
            seen.append(int(np.ravel(feed["write_from"])[0]))
        return run(prog, feed, fetch_list)

    sess._run = spy
    return seen


def test_prefix_cache_hit_bit_identical_and_skips_prefill(trained):
    """A hit provisions the full pages by reference and decodes exactly
    the cold run's tokens; stats, the longer prefix reusing the page,
    another source's miss and clear_prefix_cache() draining the pool all
    behave as in the JAX session, call for call."""
    src = trained["src"]
    jsess, sess = _both(trained, prefix_cache_pages=8)
    writes = _prefills(sess)
    pfx = [int(t) for t in src[0][:5]]  # 5 forced + bos = 6
    pfx2 = pfx + [int(src[0][5])]
    calls = [(src[0], pfx), (src[0], pfx), (src[0], pfx2), (src[2], pfx)]
    outs = []
    for s, p in calls:
        want = jsess.generate_best_of(s, 1, src_len=SEQ, prefix_tokens=p)
        got = sess.generate_best_of(s, 1, src_len=SEQ, prefix_tokens=p)
        np.testing.assert_array_equal(got, want)
        assert sess.prefix_cache_stats() == jsess.prefix_cache_stats()
        assert sess.cached_pages == jsess.cached_pages
        outs.append(got)
    cold, hit = outs[0], outs[1]
    np.testing.assert_array_equal(hit, cold)
    assert (cold[0][:6] == [1] + pfx).all()
    st = sess.prefix_cache_stats()
    assert st["lookups"] == 4 and st["hits"] == 2
    assert st["tokens_saved"] == 8 and st["hit_rate"] == 0.5
    # the cold runs prefill from 0; the hits from past the cached page
    assert writes == [0, 4, 4, 0]
    # cached pages outlive the slots; clear() frees them
    assert sess.free_slots == 4 and sess.pages_in_use > 0
    assert sess.pages_in_use == sess.cached_pages
    sess.clear_prefix_cache()
    jsess.clear_prefix_cache()
    assert sess.pages_in_use == 0 and sess.pool_conserved
    assert sess.prefix_cache_stats() == jsess.prefix_cache_stats()


def test_prefix_of_full_pages_hit_runs_no_prefill(trained):
    """A forced prefix that ends on a page boundary (bos + 4 forced
    tokens: positions 0..3, one full page): a hit covers every prefix
    position, so no prefill runs at all."""
    src = trained["src"]
    sess = _paged(TSession, trained["texe"], trained["tscope"],
                  prefix_cache_pages=8)
    writes = _prefills(sess)
    prefix = [int(t) for t in src[1][:4]]
    first = sess.generate_best_of(src[1], 1, src_len=SEQ,
                                  prefix_tokens=prefix)
    again = sess.generate_best_of(src[1], 1, src_len=SEQ,
                                  prefix_tokens=prefix)
    np.testing.assert_array_equal(again, first)
    assert writes == [0]
    assert sess.prefix_cache_stats()["tokens_saved"] == 4


def test_prefix_fork_shares_pages_until_cow_and_conserves(trained):
    """A best-of-3 fork over a forced prefix: members share the prefix
    pages, equal the unshared replay (cache off: three cold prefills) and
    the JAX session's fork, and the drained pool holds only the cache's
    references, then none."""
    src = trained["src"]
    jsess, sess = _both(trained, prefix_cache_pages=8)
    pfx = [int(t) for t in src[0][:5]]
    shared_seen = []
    run = sess._run

    def spy(prog, feed, fetch_list):
        shared_seen.append(sess.shared_pages)
        return run(prog, feed, fetch_list)

    sess._run = spy
    got = sess.generate_best_of(src[0], 3, src_len=SEQ, prefix_tokens=pfx)
    want = jsess.generate_best_of(src[0], 3, src_len=SEQ,
                                  prefix_tokens=pfx)
    np.testing.assert_array_equal(got, want)
    assert max(shared_seen) > 0, "the fork never shared a page"
    assert sess.cow_pairs > 0
    solo = _paged(TSession, trained["texe"], trained["tscope"])
    slots = [solo.admit(src[0], SEQ, prefix_tokens=pfx) for _ in range(3)]
    outs = {}
    while len(outs) < 3:
        outs.update(solo.step())
    np.testing.assert_array_equal(got, np.stack([outs[s] for s in slots]))
    assert sess.pages_in_use == sess.cached_pages
    assert sess.shared_pages == 0
    # a second wave hits the cache and decodes the same members
    again = sess.generate_best_of(src[0], 3, src_len=SEQ,
                                  prefix_tokens=pfx)
    np.testing.assert_array_equal(again, got)
    assert sess.prefix_cache_stats()["hits"] == 1
    sess.clear_prefix_cache()
    assert sess.pages_in_use == 0 and sess.free_pages == sess._P - 1


def test_failed_admission_drops_the_cached_pages_refs(trained):
    """An admission that fails after the lookup referenced cached pages
    rolls back: the slot's references drop (the cache keeps its own), so
    the pool holds only the cache's pages and conserves."""
    src = trained["src"]
    sess = _paged(TSession, trained["texe"], trained["tscope"],
                  prefix_cache_pages=8)
    pfx = [int(t) for t in src[0][:5]]
    sess.generate_best_of(src[0], 1, src_len=SEQ, prefix_tokens=pfx)
    cached = sess.cached_pages
    assert cached == 1
    run = sess._run

    def failing(prog, feed, fetch_list):
        if prog is sess._prefill_prog:
            raise RuntimeError("injected prefill fault")
        return run(prog, feed, fetch_list)

    sess._run = failing
    with pytest.raises(RuntimeError, match="injected"):
        sess.admit(src[0], SEQ, prefix_tokens=pfx)
    assert sess.prefix_cache_stats()["hits"] == 1
    assert sess.pages_in_use == cached and sess.shared_pages == 0
    assert sess.free_slots == 4 and sess.pool_conserved
    sess._run = run
    hit = sess.generate_best_of(src[0], 1, src_len=SEQ, prefix_tokens=pfx)
    assert (hit[0][:6] == [1] + pfx).all()
    sess.clear_prefix_cache()
    assert sess.pages_in_use == 0


def test_cached_pages_are_reclaimed_under_pool_pressure(trained):
    """Pages only the cache holds do not count against reservations: a
    pool of exactly two sequences still admits two after the cache took
    pages, evicting them as the pool runs dry, and decodes what a
    session without the cache decodes."""
    src = trained["src"]
    npp = 2  # SEQ / page_size
    kw = dict(num_pages=1 + 2 * npp, num_slots=2)
    sess = _paged(TSession, trained["texe"], trained["tscope"],
                  prefix_cache_pages=8, **kw)
    plain = _paged(TSession, trained["texe"], trained["tscope"], **kw)
    pfx = [int(t) for t in src[3][:5]]
    sess.generate_best_of(src[3], 1, src_len=SEQ, prefix_tokens=pfx)
    assert sess.cached_pages == 1
    got = sess.generate(src[:2], np.full(2, SEQ))
    np.testing.assert_array_equal(got, plain.generate(src[:2],
                                                      np.full(2, SEQ)))
    assert sess.cached_pages == 0 and sess.pool_conserved
