"""Attention dropout in the PyTorch port against the JAX package.

``multi_head_attention(dropout_rate=...)`` applies ``dropout`` to the
merged heads ahead of the output projection, as
``paddle_tpu/layers/attention.py:140-143`` does. Held here:

- the program's op types and variable names equal the JAX program's, in
  training and under ``is_test`` (names seed the parameters);
- under ``is_test`` the outputs equal the JAX program's (same seeded
  weights; 1e-5 absolute, fp32 projections and attention in another
  order);
- in training the dropout mask equals the JAX program's bit for bit
  (both packages draw from jax's threefry stream, keyed alike), its kept
  share is 1 - rate within a stated bound, the gradient is within
  1e-5 of the JAX program's, and the ``dropout_grad`` op carries its
  forward's ``__rng_id__`` and passes gradient exactly where the
  forward kept.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.testing import set_deterministic_params as j_seed_params
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.testing import fresh_state
from paddle_tpu_torch.testing import set_deterministic_params as t_seed_params

RATE = 0.1
BATCH, SEQ, D_MODEL, N_HEAD = 4, 16, 32, 4
OUT_TOL = 1e-5
# kept share of BATCH * SEQ * D_MODEL = 2048 Bernoulli(0.9) draws: its
# standard deviation is 0.0066, so 0.04 is six of them
KEEP_TOL = 0.04


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _mha_program(pkg, unique_name, is_test, with_grad=False):
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[SEQ, D_MODEL], stop_gradient=False)
        mask = pkg.layers.data("mask", shape=[SEQ])
        out = pkg.layers.multi_head_attention(
            x, None, None, d_key=D_MODEL // N_HEAD,
            d_value=D_MODEL // N_HEAD, d_model=D_MODEL, n_head=N_HEAD,
            dropout_rate=RATE, mask=mask, is_test=is_test, name="mha")
        grad = None
        if with_grad:
            drop = next(op for op in main.global_block().ops
                        if op.type == "dropout")
            merged = main.global_block().var(drop.input("X")[0])
            (grad,) = pkg.backward.calc_gradient(
                pkg.layers.reduce_sum(out), [merged])
    return main, startup, out, grad


def _feed(seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, SEQ + 1, BATCH)
    return {"x": rng.randn(BATCH, SEQ, D_MODEL).astype("float32"),
            "mask": (np.arange(SEQ)[None, :] < lens[:, None]).astype(
                "float32")}


def _ops_and_names(main):
    blk = main.global_block()
    return ([op.type for op in blk.ops], sorted(blk.vars))


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_program_matches_jax(is_test):
    """Op types, their order and the minted variable names equal the JAX
    program's; a dropout op sits between the merged heads and the output
    projection."""
    jm = _mha_program(jfluid, j_unique_name, is_test)[0]
    tm = _mha_program(tfluid, t_unique_name, is_test)[0]
    assert _ops_and_names(tm) == _ops_and_names(jm)
    types = _ops_and_names(tm)[0]
    assert types.count("dropout") == 1
    assert types[types.index("dropout") + 1] in ("mul", "matmul")
    drop = next(op for op in tm.global_block().ops if op.type == "dropout")
    assert drop.attrs["dropout_prob"] == RATE
    assert drop.attrs["is_test"] == is_test


def test_is_test_outputs_equal_jax():
    feed = _feed()
    jm, js, jout, _ = _mha_program(jfluid, j_unique_name, True)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), JScope()
    jexe.run(js, scope=jscope)
    j_seed_params(jm, jscope)
    (want,) = jexe.run(jm, feed=feed, fetch_list=[jout], scope=jscope)

    tm, ts, tout, _ = _mha_program(tfluid, t_unique_name, True)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    t_seed_params(tm, tscope)
    (got,) = texe.run(tm, feed=feed, fetch_list=[tout], scope=tscope)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=OUT_TOL)


def _train_mask_and_grad(pkg, unique_name, Scope, seed_params):
    main, startup, out, grad = _mha_program(pkg, unique_name, False,
                                            with_grad=True)
    main.random_seed = 17
    ops = main.global_block().ops
    fwd = next(op for op in ops if op.type == "dropout")
    bwd = next(op for op in ops if op.type == "dropout_grad")
    assert bwd.attrs["__rng_id__"] == fwd.attrs["__rng_id__"]
    exe, scope = pkg.Executor(pkg.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    seed_params(main, scope)
    mask, g = exe.run(main, feed=_feed(1), scope=scope,
                      fetch_list=[fwd.output("Mask")[0], grad])
    return np.asarray(mask), np.asarray(g), fwd.attrs["__rng_id__"]


def test_training_keep_rate_and_grad_replay_the_mask():
    """Training: the mask is the JAX package's, bit for bit (both draw
    ``bernoulli(fold_in(step_key, __rng_id__), 1 - rate)`` from jax's
    threefry stream), its kept share is 1 - rate within ``KEEP_TOL``, and
    ``dropout_grad`` passes gradient exactly where the forward kept."""
    mask, g, rng_id = _train_mask_and_grad(tfluid, t_unique_name,
                                           tfluid.Scope, t_seed_params)
    want_mask, want_g, want_id = _train_mask_and_grad(
        jfluid, j_unique_name, JScope, j_seed_params)
    assert rng_id == want_id
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_allclose(g, want_g, rtol=0, atol=OUT_TOL)
    assert mask.shape == (BATCH, SEQ, D_MODEL)
    assert abs((mask != 0).mean() - (1.0 - RATE)) < KEEP_TOL
    # downgrade_in_infer: the gradient is the output's times the mask
    np.testing.assert_array_equal(g == 0, mask == 0)
