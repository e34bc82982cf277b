"""Dropout in training, draw for draw against the JAX package.

A Transformer (n_layer 2, d_model 32, dropout 0.1, label smoothing 0.1)
trains 3 Adam steps in both packages from fresh executors with the same
``random_seed``: both run their startup programs, then the parameters
are set by ``set_deterministic_params`` (computed once, by name, and
given to both). Every dropout site draws from jax's threefry stream
keyed by the run counter and the op's ``__rng_id__``, so:

- the programs hold the same dropout ops with the same ``__rng_id__``s;
- every dropout mask of every step is bit-equal to the JAX package's;
- the losses are within ``LOSS_TOL`` = 1e-5 of the JAX package's (the
  fp32 products and reductions sum in another order);
- the startup programs' parameters (before they are overwritten) are the
  JAX package's too: uniform and Xavier draws bit-equal, normal draws
  within the ``prng`` tolerance.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.testing import fresh_state, set_deterministic_params

LOSS_TOL = 1e-5
NORMAL_TOL = 2e-6
STEPS = 3
SEED = 7


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _feed(batch=4, seq=8, vocab=60, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(1, vocab, (batch, seq)).astype("int64")
    return {"src_word": src,
            "src_len": rng.randint(2, seq + 1, (batch, 1)).astype("int64"),
            "trg_word": rng.randint(1, vocab, (batch, seq)).astype("int64"),
            "trg_len": rng.randint(2, seq + 1, (batch, 1)).astype("int64"),
            "label": src.copy()}


def _build(pkg, unique_name, transformer):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = SEED
    with unique_name.guard({}), pkg.program_guard(main, startup):
        loss, _, _ = transformer.build(
            src_vocab_size=60, trg_vocab_size=60, max_length=8, n_layer=2,
            n_head=2, d_model=32, d_inner=64, dropout=0.1,
            label_smooth_eps=0.1)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _train(pkg, unique_name, transformer, Scope, params):
    main, startup, loss = _build(pkg, unique_name, transformer)
    exe, scope = pkg.Executor(pkg.CPUPlace()), Scope()
    exe.run(startup, scope=scope)
    init = {p.name: np.array(scope.find_var(p.name).value)
            for p in main.global_block().all_parameters()}
    if params is None:
        # the port computes set_deterministic_params' values once
        set_deterministic_params(main, scope, parameters_only=True)
        params = {n: np.array(scope.find_var(n).value) for n in init}
    else:
        for n, v in params.items():
            scope.set_value(n, v.copy())
    drops = [op for op in main.global_block().ops if op.type == "dropout"]
    masks = [op.output("Mask")[0] for op in drops]
    losses, mask_runs = [], []
    for _ in range(STEPS):
        res = exe.run(main, feed=_feed(), fetch_list=[loss.name] + masks,
                      scope=scope)
        losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
        mask_runs.append([np.asarray(m) for m in res[1:]])
    rng_ids = [op.attrs["__rng_id__"] for op in drops]
    return losses, mask_runs, rng_ids, init, params


def test_dropout_masks_and_losses_match_jax():
    tl, tm, tids, tinit, params = _train(
        tfluid, t_unique_name, t_transformer, tfluid.Scope, None)
    jl, jm, jids, jinit, _ = _train(
        jfluid, j_unique_name, j_transformer, JScope, params)
    assert tids == jids and len(tids) >= 10
    for step, (t_run, j_run) in enumerate(zip(tm, jm)):
        for i, (t, j) in enumerate(zip(t_run, j_run)):
            np.testing.assert_array_equal(
                t, j, err_msg="step %d, dropout %d" % (step, i))
        # the masks drop something, and not the same cells every step
        assert all(0 < (m == 0).mean() < 0.3 for m in t_run)
    assert not np.array_equal(tm[0][0], tm[1][0])
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert sorted(tinit) == sorted(jinit)
    for name in jinit:
        np.testing.assert_allclose(tinit[name], jinit[name], rtol=0,
                                   atol=NORMAL_TOL, err_msg=name)
