"""``paddle_tpu_torch/core/prng.py`` against ``jax.random`` (jax 0.9,
``jax_threefry_partitionable=True``, threefry2x32), on the same seeds.

- ``PRNGKey``, ``fold_in``, ``split`` and ``random_bits`` are bit-equal:
  1-D and 3-D shapes, a size that is a multiple of nothing (1001 and
  4099), and batched keys ``[K, 2]`` against ``jax.vmap``;
- ``uniform`` (float32) is bit-equal: XLA on the CPU contracts
  ``u * (max - min) + min`` into a fused multiply-add, and so does the
  port (a ``fmaf`` on the card);
- ``bernoulli`` and ``randint`` are bit-equal (randint's uint32
  arithmetic included: the span's square wraps);
- ``normal`` and ``truncated_normal`` are within ``NORMAL_TOL`` = 2e-6
  absolute: both go through XLA's float32 ``erf_inv`` polynomial, whose
  ``log1p`` and ``sqrt`` round an ulp apart in XLA and torch (measured
  at most 4.8e-7 over 2**20 normals, 99 % of them bit-equal);
- ``categorical`` equals jax's on this file's fixed cases and agrees on
  at least 99.9 % of 10,000 draws over a vocabulary of 1,000 (``log``
  may round an ulp apart; 100 % measured);
- a ``KeyChain`` (integer folds, then per-row data) draws what the
  nested ``fold_in``s draw, the threefry kernel's wrapper runs the plain
  version for a CPU tensor, and a draw from a key known on the host
  lands on the device it is asked for.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.kernels import threefry as kthreefry

NORMAL_TOL = 2e-6
SEEDS = [0, 1, 7, 123456, 2 ** 31 - 1]
SHAPES = [(5,), (3, 4, 5), (1001,), (4099,)]


def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [-5, 2 ** 32 + 5])
def test_prngkey_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tkey.numpy(), _u32(key))
    for d in (0, 1, 5, 1000, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tkey, d).numpy(),
                                      _u32(jax.random.fold_in(key, d)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_random_bits(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for num in (1, 2, 7):
        np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                      _u32(jax.random.split(key, num)))
    for shape in SHAPES:
        np.testing.assert_array_equal(
            prng.random_bits(tkey, shape).numpy(),
            _u32(jax.random.bits(key, shape)))


def test_batched_keys_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    tkeys = torch.from_numpy(_u32(keys))
    data = np.asarray([0, 3, 9, 2 ** 31, 17, 5], np.uint32)
    np.testing.assert_array_equal(
        prng.fold_in(tkeys, torch.from_numpy(data.astype(np.int64))).numpy(),
        _u32(jax.vmap(jax.random.fold_in)(keys, data)))
    np.testing.assert_array_equal(
        prng.split(tkeys, 3).numpy(),
        _u32(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
    np.testing.assert_array_equal(
        prng.random_bits(tkeys, (2, 7)).numpy(),
        _u32(jax.vmap(lambda k: jax.random.bits(k, (2, 7)))(keys)))
    np.testing.assert_array_equal(
        prng.uniform(tkeys, (33,), -1.0, 3.0).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (33,), minval=-1.0, maxval=3.0))(keys)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.0123, 0.0123),
                                    (-2.0, 4.0), (1e-30, 1.0)])
def test_uniform_bit_equal(seed, bounds):
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    lo, hi = bounds
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=hi))
        got = prng.uniform(tkey, shape, lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_uniform_large_draw_bit_equal():
    key, tkey = jax.random.PRNGKey(11), prng.PRNGKey(11)
    shape = (1 << 18,)
    want = np.asarray(jax.random.uniform(key, shape, minval=-0.0123,
                                         maxval=0.0123))
    np.testing.assert_array_equal(
        prng.uniform(tkey, shape, -0.0123, 0.0123).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_and_randint_bit_equal(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in SHAPES:
        for p in (0.1, 0.5, 0.9):
            np.testing.assert_array_equal(
                prng.bernoulli(tkey, p, shape).numpy(),
                np.asarray(jax.random.bernoulli(key, p, shape)))
        for lo, hi in ((-3, 1000), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
                       (0, 1), (5, 5), (7, 3)):
            np.testing.assert_array_equal(
                prng.randint(tkey, shape, lo, hi).numpy(),
                np.asarray(jax.random.randint(key, shape, lo, hi)),
                err_msg=str((lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_family_within_tolerance(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in SHAPES:
        np.testing.assert_allclose(
            prng.normal(tkey, shape).numpy(),
            np.asarray(jax.random.normal(key, shape)), rtol=0,
            atol=NORMAL_TOL)
        got = prng.truncated_normal(tkey, -2.0, 2.0, shape).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax.random.truncated_normal(key, -2.0, 2.0,
                                                        shape)),
            rtol=0, atol=NORMAL_TOL)
        assert np.abs(got).max() < 2.0


def test_normal_large_draw():
    key, tkey = jax.random.PRNGKey(11), prng.PRNGKey(11)
    want = np.asarray(jax.random.normal(key, (1 << 18,)))
    got = prng.normal(tkey, (1 << 18,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)
    assert (got == want).mean() > 0.95


def test_categorical_fixed_cases_equal():
    rng = np.random.RandomState(0)
    for seed, shape in ((0, (7,)), (1, (3, 11)), (2, (5, 50)),
                        (3, (2, 3, 9))):
        logits = rng.randn(*shape).astype(np.float32)
        key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for axis in (-1, 0):
            np.testing.assert_array_equal(
                prng.categorical(tkey, torch.from_numpy(logits),
                                 axis=axis).numpy(),
                np.asarray(jax.random.categorical(key, logits, axis=axis)))


def test_categorical_agreement_rate():
    """10,000 draws over a vocabulary of 1,000, one key per row (as the
    sampler keys each slot), against ``vmap(jax.random.categorical)``."""
    logits = np.random.RandomState(0).randn(10000, 1000).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), 10000)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = prng.categorical(torch.from_numpy(_u32(keys)),
                           torch.from_numpy(logits)).numpy()
    assert (got == want).mean() >= 0.999


def test_key_chain_matches_nested_fold_in():
    """A chain's integer folds, then its per-row data, draw what the
    nested ``fold_in``s draw (the sampler's key rule)."""
    seed, S = 9, 5
    pos = np.asarray([0, 3, 17, 255, 4], np.int32)
    base = jax.random.PRNGKey(seed)
    keys = jax.vmap(lambda i, p: jax.random.fold_in(
        jax.random.fold_in(base, i), p))(jnp.arange(S), pos)
    want = jax.vmap(lambda k: jax.random.uniform(k, (40,)))(keys)
    chain = prng.KeyChain(prng.PRNGKey_pair(seed)).fold_in(
        torch.arange(S)).fold_in(torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_array_equal(prng.key_data(chain).numpy(), _u32(keys))
    np.testing.assert_array_equal(prng.uniform(chain, (40,)).numpy(),
                                  np.asarray(want))
    # integer folds on a tensor base stay lazy and fold in the draw
    tbase = prng.PRNGKey(seed)
    chain = prng.KeyChain(tbase).fold_in(3).fold_in(2 ** 32 - 2).fold_in(7)
    assert chain.folds == (3, 2 ** 32 - 2, 7)
    nested = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        base, 3), 2 ** 32 - 2), 7)
    np.testing.assert_array_equal(
        prng.random_bits(chain, (6, 5)).numpy(),
        _u32(jax.random.bits(nested, (6, 5))))
    # past MAX_FOLDS the chain folds what it holds and goes on
    long = prng.KeyChain(tbase)
    want_key = base
    for d in range(prng.MAX_FOLDS + 2):
        long = long.fold_in(d)
        want_key = jax.random.fold_in(want_key, d)
    np.testing.assert_array_equal(prng.key_data(long).numpy(),
                                  _u32(want_key))


def test_kernel_wrapper_runs_the_plain_version_on_the_cpu():
    chain = prng.KeyChain(prng.PRNGKey(4)).fold_in(1)
    for mode in (prng.MODE_KEY, prng.MODE_BITS, prng.MODE_UNIFORM,
                 prng.MODE_BERNOULLI):
        got = kthreefry.threefry_draw(chain, 37, mode, lo=-1.0, hi=2.0,
                                      p=0.3)
        want = prng.plain_draw(chain, 37, mode, lo=-1.0, hi=2.0, p=0.3)
        assert torch.equal(got, want)
    assert kthreefry.THREEFRY.launches == 0


def test_draws_stay_on_the_requested_device():
    """A chain whose key is known on the host draws on the device it is
    asked for, never on the CPU and copied over (``meta`` stands in for
    the card here: a tensor made on the CPU would show)."""
    chain = prng.KeyChain(prng.PRNGKey_pair(5)).fold_in(3)
    meta = torch.device("meta")
    draws = [prng.uniform(chain, (4, 3), device=meta),
             prng.bernoulli(chain, 0.3, (7,), device=meta),
             prng.randint(chain, (5,), 0, 999, device=meta),
             prng.random_bits(chain, (6,), device=meta),
             prng.split(chain, 3, device=meta),
             prng.normal(chain, (2, 2), device=meta),
             prng.truncated_normal(chain, -2.0, 2.0, (3,), device=meta),
             prng.gumbel(chain, (8,), device=meta)]
    assert all(d.device.type == "meta" for d in draws)


def test_a_key_is_never_moved_to_the_requested_device():
    """A key tensor on one device drawn on another raises, in the
    kernel's wrapper and in the plain version alike, instead of drawing
    where the key lies (a CPU key asked for on the card would give a CPU
    tensor)."""
    for key in (prng.PRNGKey(5), prng.fold_in(prng.PRNGKey(5), 2),
                prng.KeyChain(prng.PRNGKey_pair(5)).fold_in(
                    torch.arange(3))):
        for device in ("cuda", "cuda:0", torch.device("meta")):
            with pytest.raises(ValueError, match="move the key first"):
                prng.uniform(key, (4,), device=device)
            with pytest.raises(ValueError, match="move the key first"):
                kthreefry.threefry_draw(prng.as_chain(key), 4,
                                        prng.MODE_BITS, device=device)
            with pytest.raises(ValueError, match="move the key first"):
                prng.plain_draw(prng.as_chain(key), 4, prng.MODE_BITS,
                                device=device)
    # the key's own device, named, is no conflict
    assert prng.uniform(prng.PRNGKey(5), (4,), device="cpu").shape == (4,)
