"""The dense slot layout (``SlotDecodeSession(paged=False)``,
``models.transformer.build_slot_decoder``) of the port against the JAX
package's, on the same weights.

The JAX model is trained 50 Adam steps on a copy task (the config of
``tests/test_serving.py``'s slot-decoder test: 1 layer, d_model 32,
vocab 24, length 8), carried into the port with
``convert.params_from_numpy``, and served by both packages. Token
matrices must be EQUAL: greedy argmax over fp32 logits that agree to
about 1e-6 on this model, whose top-2 margins are far wider. Also held:
the twin of ``test_slot_decoder_staggered_admissions_match_dedicated_decode``
(staggered admissions equal the dedicated greedy decoder), dense equal to
paged on the CPU, the dense refusals with the JAX package's messages, the
parameter names the builder mints, and the ``one_hot`` op against the
JAX op (exact: 0/1 values).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.serving.generation import NoFreeSlotError
from paddle_tpu_torch.serving.generation import SlotDecodeSession as TSession
from paddle_tpu_torch.testing import fresh_state

VOCAB, SEQ, D = 24, 8, 32
CFG = dict(src_vocab_size=VOCAB, trg_vocab_size=VOCAB, n_layer=1,
           n_head=2, d_inner=64)


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _copy_batch(rng, bs):
    src = rng.randint(3, VOCAB, (bs, SEQ)).astype("int64")
    trg = np.full_like(src, 1)
    trg[:, 1:] = src[:, :-1]
    return {"src_word": src, "src_len": np.full((bs, 1), SEQ, "int64"),
            "trg_word": trg, "trg_len": np.full((bs, 1), SEQ, "int64"),
            "label": src}


@pytest.fixture(scope="module")
def models():
    """The JAX model as tests/test_serving.py trains it (seed 21, 50
    Adam steps) with its inference program, and the port's copy: the
    port's training build (for the names) and inference program."""
    jmain, jstartup = jfluid.Program(), jfluid.Program()
    jmain.random_seed = jstartup.random_seed = 21
    with j_unique_name.guard({}), jfluid.program_guard(jmain, jstartup):
        loss, _, extras = j_transformer.build(
            dropout=0.0, label_smooth_eps=0.0, max_length=SEQ, d_model=D,
            **CFG)
        jfluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    jinfer = j_transformer.build_inference(jmain, extras["logits"])
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    rng = np.random.RandomState(22)
    for _ in range(50):
        jexe.run(jmain, feed=_copy_batch(rng, 16), fetch_list=[loss],
                 scope=jscope)
    src = rng.randint(3, VOCAB, (5, SEQ)).astype("int64")
    src_len = np.asarray([[SEQ], [SEQ - 3], [SEQ - 1], [2], [SEQ]],
                         "int64")
    with fresh_state():
        tmain, tstartup = tfluid.Program(), tfluid.Program()
        with t_unique_name.guard({}), \
                tfluid.program_guard(tmain, tstartup):
            _, _, textras = t_transformer.build(
                dropout=0.0, label_smooth_eps=0.0, max_length=SEQ,
                d_model=D, **CFG)
        tinfer = t_transformer.build_inference(tmain, textras["logits"])
    tscope = TScope()
    params_from_numpy(tmain, tscope, {
        p.name: np.asarray(jscope.get_value(p.name))
        for p in jmain.global_block().all_parameters()}, "cpu")
    return {"jexe": jexe, "jscope": jscope, "jinfer": jinfer,
            "jlogits": extras["logits"].name,
            "texe": tfluid.Executor(tfluid.CPUPlace()), "tscope": tscope,
            "tinfer": tinfer, "tlogits": textras["logits"].name,
            "src": src, "src_len": src_len}


def _session(cls, exe, scope, **kw):
    args = dict(num_slots=3, max_length=SEQ, d_model=D, scope=scope)
    args.update(CFG)
    args.update(kw)
    return cls(exe, **args)


def _port(models, **kw):
    return _session(TSession, models["texe"], models["tscope"], **kw)


def test_dense_staggered_admissions_match_dedicated_decode(models):
    """Twin of tests/test_serving.py's: sequences admitted into the dense
    slot pool mid-flight (3 slots, 5 sequences, ragged lengths) give
    exactly the tokens of the dedicated greedy decoder, the port's and
    the JAX package's; a second full batch through ``generate`` too."""
    src, src_len = models["src"], models["src_len"]
    want = t_transformer.greedy_generate(
        models["texe"], models["tinfer"], models["tlogits"], src, src_len,
        SEQ, scope=models["tscope"])
    with jfluid.scope_guard(models["jscope"]):
        jax_want = j_transformer.greedy_generate(
            models["jexe"], models["jinfer"], models["jlogits"], src,
            src_len, SEQ)
    np.testing.assert_array_equal(want, jax_want)
    sess = _port(models)
    got = np.zeros_like(want)
    owner = {sess.admit(src[i], src_len[i]): i for i in range(3)}
    with pytest.raises(NoFreeSlotError):
        sess.admit(src[3], src_len[3])
    pending = [3, 4]
    steps = 0
    while owner or pending:
        while pending and sess.free_slots:
            i = pending.pop(0)
            owner[sess.admit(src[i], src_len[i])] = i
        for slot, tokens in sess.step().items():
            got[owner.pop(slot)] = tokens
        steps += 1
        assert steps < 100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sess.generate(src, src_len), want)
    assert sess.decode_steps == sess.steps_done
    assert sess.pool_conserved and sess.pages_in_use == 0
    assert sess.free_pages == 0 and sess.free_groups == 0
    assert sess.prefix_cache_stats()["lookups"] == 0


def test_dense_tokens_equal_the_jax_dense_session(models):
    src, src_len = models["src"], models["src_len"]
    jsess = _session(JSession, models["jexe"], models["jscope"])
    tsess = _port(models)
    want = jsess.generate(src, src_len)
    np.testing.assert_array_equal(tsess.generate(src, src_len), want)
    assert tsess.steps_done == jsess.steps_done


@pytest.mark.parametrize("steps", [1, 2])
def test_dense_equals_paged_on_the_cpu(models, steps):
    src, src_len = models["src"], models["src_len"]
    dense = _port(models).generate(src, src_len)
    paged = _port(models, paged=True, page_size=4, steps=steps)
    np.testing.assert_array_equal(paged.generate(src, src_len), dense)


def test_dense_parameter_names_equal_the_jax_builder():
    """Every parameter binds by name: the three programs read exactly
    the JAX builder's parameter and state names."""
    def names(fluid, transformer):
        progs = transformer.build_slot_decoder(3, max_length=SEQ,
                                               d_model=D, **CFG)
        assert progs[3].startswith("slot_decode_sample")
        return [sorted(n for n, v in p.global_block().vars.items()
                       if v.persistable) for p in progs[:3]]

    assert names(tfluid, t_transformer) == names(jfluid, j_transformer)


REFUSALS = {
    "steps": (dict(steps=2), None),
    "prefix_cache": (dict(prefix_cache_pages=4), None),
    "num_groups": (dict(num_groups=2), None),
    "speculative": (dict(speculative=2), None),
    "admit_prefix": ({}, lambda s, src: s.admit(src, prefix_tokens=[5])),
    "admit_group": ({}, lambda s, src: s.admit_group(src, n=2)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_dense_refusals_carry_the_jax_messages(models, case):
    kw, call = REFUSALS[case]

    def refusal(cls, exe, scope):
        with pytest.raises(ValueError) as err:
            sess = _session(cls, exe, scope, **kw)
            call(sess, models["src"][0])
        return str(err.value)

    want = refusal(JSession, models["jexe"], models["jscope"])
    assert refusal(TSession, models["texe"], models["tscope"]) == want


def test_one_hot_matches_the_jax_op():
    """ids in range, at the edges and outside [0, depth) (a zero row),
    as [N, 1] and as [N]."""
    ids = np.array([0, 4, 6, 7, -1, 3, 9], "int64")
    for shape in ([7, 1], [7]):
        outs = []
        for fluid in (jfluid, tfluid):
            prog = fluid.Program()
            with fluid.program_guard(prog, fluid.Program()):
                x = fluid.layers.data("ids", shape=shape, dtype="int64",
                                      append_batch_size=False)
                y = fluid.layers.one_hot(x, depth=7)
            (out,) = fluid.Executor(fluid.CPUPlace()).run(
                prog, feed={"ids": ids.reshape(shape)}, fetch_list=[y])
            outs.append(np.asarray(out))
        assert outs[1].dtype == np.float32 and outs[1].shape == (7, 7)
        np.testing.assert_array_equal(outs[1], outs[0])
