"""The serving slice as a whole: the PyTorch port's paged greedy
SlotDecodeSession against the JAX package's, on the same weights.

The JAX model starts from ``set_deterministic_params`` weights, is
trained briefly on a copy task (so that tokens follow the source), and
is carried into the port with ``convert.params_from_numpy``. Both packages
then serve the same requests (the tests/test_paged_attention.py config:
3 slots, page size 4, 5 requests admitted staggered, so that admissions
land mid-flight) and the token matrices must be EQUAL. The cross-K/V
state the admissions write must agree within 1e-5 (fp32 through one
encoder layer). The port alone must also reproduce the committed golden
``tests/golden/transformer_greedy.npz``, and raise the typed admission
rejects.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu.testing import set_deterministic_params as j_set_params
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.serving.generation import (
    NoFreePageError,
    NoFreeSlotError,
    Sampler,
)
from paddle_tpu_torch.serving.generation import SlotDecodeSession as TSession
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.testing import (
    set_deterministic_params as t_set_params,
)

VOCAB, SEQ, D = 24, 8, 32
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=1,
           n_head=2, d_inner=64)
STATE_TOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "transformer_greedy.npz")


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _build(pkg, unique_name, transformer, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        transformer.build(dropout=0.0, label_smooth_eps=0.0, **kw)
    return main, startup


@pytest.fixture(scope="module")
def models():
    """The JAX model, started from ``set_deterministic_params`` weights
    and trained for 80 Adam steps on a copy task (as the reference's
    tests/test_paged_attention.py does, so that decoded tokens follow
    the source through cross attention), and the port's copy of it,
    each in its own scope."""
    jmain, jstartup = _build(jfluid, j_unique_name, j_transformer,
                             max_length=SEQ, d_model=D, **CFG)
    train, train_startup = jfluid.Program(), jfluid.Program()
    with j_unique_name.guard({}), \
            jfluid.program_guard(train, train_startup):
        loss, _, _ = j_transformer.build(
            dropout=0.0, label_smooth_eps=0.0, max_length=SEQ, d_model=D,
            **CFG)
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(train_startup, scope=jscope)
    j_set_params(jmain, jscope)  # the parameters, not Adam's moments
    rng = np.random.RandomState(22)
    for _ in range(80):
        src = rng.randint(3, VOCAB, (16, SEQ)).astype("int64")
        trg = np.full_like(src, 1)
        trg[:, 1:] = src[:, :-1]
        jexe.run(train, feed={
            "src_word": src, "src_len": np.full((16, 1), SEQ, "int64"),
            "trg_word": trg, "trg_len": np.full((16, 1), SEQ, "int64"),
            "label": src}, fetch_list=[loss], scope=jscope)
    with fresh_state():
        tmain, _ = _build(tfluid, t_unique_name, t_transformer,
                          max_length=SEQ, d_model=D, **CFG)
    tscope = TScope()
    params_from_numpy(tmain, tscope, {
        p.name: np.asarray(jscope.get_value(p.name))
        for p in jmain.global_block().all_parameters()}, "cpu")
    src = rng.randint(3, VOCAB, (5, SEQ)).astype("int64")
    src_len = np.asarray([[SEQ], [SEQ - 3], [SEQ - 1], [2], [SEQ]],
                         "int64")
    return {"jexe": jexe, "jscope": jscope,
            "texe": tfluid.Executor(tfluid.CPUPlace()), "tscope": tscope,
            "src": src, "src_len": src_len}


def _session(cls, exe, scope, **kw):
    args = dict(num_slots=3, max_length=SEQ, d_model=D, paged=True,
                page_size=4, scope=scope)
    args.update(CFG)
    args.update(kw)
    return cls(exe, **args)


def _staggered(sess, src, src_len, after_first_admissions=None):
    """Admit 3, check the 4th is rejected, then admit the rest as slots
    free (the reference test's staggered loop)."""
    got = np.zeros((len(src), SEQ), "int64")
    owner = {sess.admit(src[i], src_len[i]): i for i in range(3)}
    if after_first_admissions is not None:
        after_first_admissions()
    with pytest.raises(Exception) as err:
        sess.admit(src[3], src_len[3])
    assert type(err.value).__name__ == "NoFreeSlotError"
    pending = list(range(3, len(src)))
    rounds = 0
    while owner or pending:
        while pending and sess.free_slots:
            i = pending.pop(0)
            owner[sess.admit(src[i], src_len[i])] = i
        for slot, tokens in sess.step().items():
            got[owner.pop(slot)] = tokens
        rounds += 1
        assert rounds < 100
    return got


def test_parameter_names_and_shapes_match():
    """Name parity: the port's build mints the reference's parameter
    names, with the same shapes (weights carry across by name)."""
    kw = dict(src_vocab_size=40, trg_vocab_size=30, max_length=12,
              n_layer=2, n_head=4, d_model=32, d_inner=48)
    jmain, jstartup = _build(jfluid, j_unique_name, j_transformer, **kw)
    tmain, tstartup = _build(tfluid, t_unique_name, t_transformer, **kw)

    def table(prog):
        return {p.name: tuple(p.shape)
                for p in prog.global_block().all_parameters()}

    assert table(tmain) == table(jmain)
    assert len(table(tmain)) > 30
    assert table(tstartup) == table(jstartup)


def test_paged_greedy_tokens_equal_jax_staggered(models):
    """The oracle: staggered mid-flight admissions produce EQUAL greedy
    token matrices in both packages, the cross-K/V state written by the
    first admissions agrees, and every page is recycled."""
    m = models
    jsess = _session(JSession, m["jexe"], m["jscope"], steps=1)
    tsess = _session(TSession, m["texe"], m["tscope"], steps=1)
    want = _staggered(jsess, m["src"], m["src_len"])

    def compare_state():
        for name in ("pgd_kcross_0", "pgd_vcross_0", "pgd_src_mask"):
            np.testing.assert_allclose(
                m["tscope"].get_value(name).numpy(),
                np.asarray(m["jscope"].get_value(name)),
                rtol=STATE_TOL, atol=STATE_TOL, err_msg=name)

    # the JAX session has drained, so its scope holds the cross state
    # of its LAST admissions; compare against a fresh JAX admission set
    jsess2 = _session(JSession, m["jexe"], m["jscope"], steps=1)
    for i in range(3):
        jsess2.admit(m["src"][i], m["src_len"][i])
    got = _staggered(tsess, m["src"], m["src_len"],
                     after_first_admissions=compare_state)
    np.testing.assert_array_equal(got, want)
    assert tsess.pages_in_use == 0 and tsess.pool_conserved
    assert tsess.free_slots == 3


def test_multi_step_dispatch_gives_the_same_tokens(models):
    """steps=4 (four tokens per run_multi_step call) equals steps=1."""
    m = models
    one = _session(TSession, m["texe"], m["tscope"], steps=1).generate(
        m["src"], m["src_len"])
    sess4 = _session(TSession, m["texe"], m["tscope"], steps=4)
    four = sess4.generate(m["src"], m["src_len"])
    np.testing.assert_array_equal(four, one)
    assert sess4.pages_in_use == 0 and sess4.pool_conserved


def test_forced_prefix_matches_jax(models):
    """admit(..., prefix_tokens=...) runs the causal prefill program (the
    flash kernel's causal path) and decodes the same tokens as JAX."""
    m = models
    prefixes = [[5, 9, 11], [7], [4, 4, 6, 3, 8]]
    out = {}
    for name, cls, exe, scope in (("jax", JSession, m["jexe"], m["jscope"]),
                                  ("torch", TSession, m["texe"],
                                   m["tscope"])):
        sess = _session(cls, exe, scope, steps=2)
        owner = {sess.admit(m["src"][i], m["src_len"][i],
                            prefix_tokens=prefixes[i]): i
                 for i in range(3)}
        got = np.zeros((3, SEQ), "int64")
        while owner:
            for slot, tokens in sess.step().items():
                got[owner.pop(slot)] = tokens
        assert sess.pages_in_use == 0
        out[name] = got
    np.testing.assert_array_equal(out["torch"], out["jax"])
    for i, prefix in enumerate(prefixes):
        np.testing.assert_array_equal(out["torch"][i, 1:1 + len(prefix)],
                                      prefix)


def test_no_free_slot_is_a_typed_reject(models):
    m = models
    sess = _session(TSession, m["texe"], m["tscope"], steps=1)
    for i in range(3):
        sess.admit(m["src"][i], m["src_len"][i])
    pages = sess.pages_in_use
    with pytest.raises(NoFreeSlotError):
        sess.admit(m["src"][3], m["src_len"][3])
    assert sess.free_slots == 0 and sess.pages_in_use == pages


def test_pool_exhaustion_is_a_typed_admission_reject(models):
    """An undersized pool rejects the admission whose worst-case pages
    cannot be reserved, rolls it back, never fails mid-flight, and
    admits again once a sequence completes."""
    m = models
    # worst case is 2 pages per sequence; the pool holds exactly 2
    sess = _session(TSession, m["texe"], m["tscope"], steps=1,
                    num_pages=3)
    want = _session(TSession, m["texe"], m["tscope"], steps=1).generate(
        m["src"][:2], m["src_len"][:2])
    slot = sess.admit(m["src"][0], m["src_len"][0])
    free_before = sess.free_slots
    with pytest.raises(NoFreePageError):
        sess.admit(m["src"][1], m["src_len"][1])
    assert sess.free_slots == free_before
    out = {}
    while not out:
        out = sess.step()
    np.testing.assert_array_equal(out[slot], want[0])
    assert sess.free_pages == 2
    slot2 = sess.admit(m["src"][1], m["src_len"][1])
    out = {}
    while not out:
        out = sess.step()
    np.testing.assert_array_equal(out[slot2], want[1])
    with pytest.raises(ValueError, match="cannot cover"):
        _session(TSession, m["texe"], m["tscope"], num_pages=2)


def test_sampled_decode_points_to_rng_parity():
    """Every strategy is a Sampler now (its draws are held against the
    JAX package's in ``test_torch_sampled_decode.py``); the port's
    refusals are the JAX package's, message for message."""
    from paddle_tpu.serving.generation import Sampler as JSampler

    for kw in ({"strategy": "greedy"},
               {"strategy": "temperature", "temperature": 0.7, "seed": 3},
               {"strategy": "top_k", "top_k": 3, "seed": 9}):
        got, want = Sampler(**kw), JSampler(**kw)
        assert ((got.strategy, got.temperature, got.top_k, got.seed)
                == (want.strategy, want.temperature, want.top_k, want.seed))
    for kw in ({"strategy": "top_k"}, {"strategy": "beam"}):
        with pytest.raises(ValueError) as want:
            JSampler(**kw)
        with pytest.raises(ValueError) as got:
            Sampler(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("steps", [1, 4])
def test_port_reproduces_committed_golden(steps):
    """tests/golden/transformer_greedy.npz (the JAX package's greedy
    decode of the n_layer 1 / d_model 32 / vocab 50 transformer over
    set_deterministic_params weights) from the port's own build, weights
    and paged session (eos_id=0, so every step of the budget runs)."""
    golden = np.load(GOLDEN)
    vocab, seq = 50, 10
    main, startup = _build(tfluid, t_unique_name, t_transformer,
                           src_vocab_size=vocab, trg_vocab_size=vocab,
                           max_length=seq, n_layer=1, n_head=2,
                           d_model=32, d_inner=64)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = TScope()
    exe.run(startup, scope=scope)
    t_set_params(main, scope)
    sess = TSession(exe, num_slots=2, max_length=seq, d_model=32,
                    paged=True, page_size=4, steps=steps, eos_id=0,
                    scope=scope, src_vocab_size=vocab,
                    trg_vocab_size=vocab, n_layer=1, n_head=2, d_inner=64)
    tokens = sess.generate(golden["src"], golden["src_len"])
    np.testing.assert_array_equal(tokens, golden["tokens"])
    assert sess.pages_in_use == 0
