"""Sampled decode (temperature and top-k) in the port against the JAX
package, on the same weights.

The model is ``test_torch_serving.py``'s (the JAX package's copy-task
Transformer, trained 80 Adam steps and carried into the port). Each
sampled position draws ``categorical`` with the key
``fold_in(fold_in(PRNGKey(seed), slot), position)`` from jax's threefry
stream, so the port's sessions stream the JAX sessions' tokens. Twins
of:

- ``test_paged_attention.py::test_seeded_sampler_replay_is_bit_identical``
  (a rebuilt session replays its tokens; ``steps`` 1 and 4 give equal
  streams), paged and dense;
- ``test_kv_reuse.py::test_group_sampled_members_match_unshared_replay``
  (sampled fork-group members equal an unshared replay), with and
  without the prefix cache;
- ``test_speculative.py::test_sampled_stream_is_bit_identical_to_off_oracle``
  (a sampled speculative stream equals the ``FLAGS_speculative=off``
  stream).

Every stream is compared with the JAX session's exactly. The logits of
the two packages agree to about 1e-6 (fp32 sums in another order), so a
position could in principle sample another token where the top two
Gumbel-perturbed logits lie within that of each other; on these seeds no
position does, and the streams are equal token for token.
"""

import numpy as np
import pytest

from paddle_tpu import flags as j_flags
from paddle_tpu.serving.generation import Sampler as JSampler
from paddle_tpu.serving.generation import SlotDecodeSession as JSession
from paddle_tpu_torch import flags as t_flags
from paddle_tpu_torch.serving.generation import Sampler as TSampler
from paddle_tpu_torch.serving.generation import SlotDecodeSession as TSession
from paddle_tpu_torch.testing import fresh_state
from test_torch_serving import _session, models  # noqa: F401

SAMPLERS = {
    "top_k": dict(strategy="top_k", top_k=3, temperature=0.8, seed=11),
    "temperature": dict(strategy="temperature", temperature=1.2, seed=5),
}


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield
    j_flags.set_flag("speculative", "on")
    t_flags.set_flag("speculative", "on")


def _both(m, sampler, **kw):
    """The JAX session and the port's, each with its own Sampler."""
    jsess = _session(JSession, m["jexe"], m["jscope"],
                     sampler=JSampler(**sampler), **kw)
    tsess = _session(TSession, m["texe"], m["tscope"],
                     sampler=TSampler(**sampler), **kw)
    return jsess, tsess


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_seeded_sampler_replay_is_bit_identical(models, name, paged):
    m = models
    steps = (1, 4) if paged else (1, 1)
    streams = {}
    for which, cls, exe, scope, Sampler in (
            ("jax", JSession, m["jexe"], m["jscope"], JSampler),
            ("torch", TSession, m["texe"], m["tscope"], TSampler)):
        for k in steps:
            sess = _session(cls, exe, scope, paged=paged, steps=k,
                            sampler=Sampler(**SAMPLERS[name]))
            streams[which, k] = sess.generate(m["src"], m["src_len"])
    a, b = streams["torch", steps[0]], streams["torch", steps[1]]
    np.testing.assert_array_equal(a, b)
    for k in steps:
        np.testing.assert_array_equal(streams["torch", k],
                                      streams["jax", k])
    greedy = _session(TSession, m["texe"], m["tscope"], paged=paged)
    # sampling actually happened, and every row is bos-led
    assert not np.array_equal(a, greedy.generate(m["src"], m["src_len"]))
    assert (a[:, 0] == 1).all()


@pytest.mark.parametrize("cache_pages", [0, 8], ids=["plain", "cached"])
def test_group_sampled_members_match_unshared_replay(models, cache_pages):
    m = models
    smp = dict(strategy="top_k", top_k=4, temperature=0.9, seed=7)
    jsess, tsess = _both(m, smp, prefix_cache_pages=cache_pages)
    pfx = [int(t) for t in m["src"][0][:5]] if cache_pages else None
    got = tsess.generate_best_of(m["src"][0], 3, src_len=m["src_len"][0],
                                 prefix_tokens=pfx)
    want = jsess.generate_best_of(m["src"][0], 3, src_len=m["src_len"][0],
                                  prefix_tokens=pfx)
    np.testing.assert_array_equal(got, want)
    # members diverge (the sampler is per slot), else the test is vacuous
    assert not (np.array_equal(got[0], got[1])
                and np.array_equal(got[1], got[2]))
    if cache_pages:
        again = tsess.generate_best_of(m["src"][0], 3,
                                       src_len=m["src_len"][0],
                                       prefix_tokens=pfx)
        assert tsess.prefix_cache_stats()["hits"] >= 1
        np.testing.assert_array_equal(again, got)
        return
    unshared = _session(TSession, m["texe"], m["tscope"],
                        sampler=TSampler(**smp))
    slots = [unshared.admit(m["src"][0], m["src_len"][0]) for _ in range(3)]
    outs = {}
    while len(outs) < 3:
        outs.update(unshared.step())
    np.testing.assert_array_equal(got, np.stack([outs[s] for s in slots]))
    assert tsess.pages_in_use == 0


# the twin's own sampler for top-k. A key names its slot, and with 5
# requests on 3 slots a staggered admission takes the slot that frees
# first; under speculation two slots may finish in one dispatch that the
# sequential path spreads over two, and a later request then lands in
# another slot and samples another stream (in the JAX package too: with
# top_k=3 rows 3 and 4 differ between on and off in both packages).
SPEC_SAMPLERS = {
    "top_k": dict(strategy="top_k", top_k=4, temperature=0.8, seed=11),
    "temperature": SAMPLERS["temperature"],
}


@pytest.mark.parametrize("name", sorted(SPEC_SAMPLERS))
def test_sampled_stream_is_bit_identical_to_off_oracle(models, name):
    m = models
    jsess, tsess = _both(m, SPEC_SAMPLERS[name], steps=1, speculative=3)
    t_flags.set_flag("speculative", "on")
    on = tsess.generate(m["src"], m["src_len"])
    assert tsess.spec_dispatches > 0 and tsess.spec_proposed > 0
    t_flags.set_flag("speculative", "off")
    off = tsess.generate(m["src"], m["src_len"])
    np.testing.assert_array_equal(on, off)
    j_flags.set_flag("speculative", "on")
    want = jsess.generate(m["src"], m["src_len"])
    np.testing.assert_array_equal(on, want)
    assert (tsess.spec_dispatches, tsess.spec_proposed,
            tsess.spec_accepted) == (jsess.spec_dispatches,
                                     jsess.spec_proposed,
                                     jsess.spec_accepted)
    assert (on[:, 0] == 1).all()
    assert tsess.pages_in_use == 0
