"""Training through the PyTorch port against the JAX package, on the CPU.

- ``sgd`` and ``adam`` (and the other forward ops the train program adds:
  ``sum``, ``log_softmax``, ``dropout`` in test mode) as one-op programs
  through both packages' executors, within 1e-6;
- an MLP trained 5 steps with SGD and with Adam from the same initial
  state: accumulator names equal, losses within 1e-5;
- the small Transformer (n_layer 2, n_head 2, d_model 32, d_inner 64,
  vocab 60, max_length 8, dropout 0, label smoothing 0.1, Adam 1e-3):
  the JAX run's whole initial state is carried across with
  ``convert.persistables_from_numpy``; step 1's parameter gradients agree
  within atol 1e-5 + rtol 1e-4 and the 5-step loss within 1e-4;
- dropout on: ``dropout_grad`` carries its forward's ``__rng_id__`` and
  zeroes exactly the entries the forward dropped;
- the committed golden ``tests/golden/transformer.npz`` reproduced.
"""

import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as j_transformer
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.core.lowering import BlockLowerer
from paddle_tpu_torch.models import transformer as t_transformer
from paddle_tpu_torch.testing import (
    _seed_of,
    fresh_state,
    set_deterministic_params,
)

OP_TOL = 1e-6
MLP_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _run_op(pkg, op_type, ins, outs, attrs):
    prog = pkg.Program()
    blk = prog.global_block()
    feed = {}
    for slot, items in ins.items():
        for name, arr in items:
            if not blk.has_var(name):
                blk.create_var(name=name, shape=arr.shape,
                               dtype=str(arr.dtype), is_data=True)
            feed[name] = arr
    fetch = [n for names in outs.values() for n in names]
    for name in fetch:
        if not blk.has_var(name):
            blk.create_var(name=name)
    blk.append_op(type=op_type,
                  inputs={s: [n for n, _ in it] for s, it in ins.items()},
                  outputs=outs, attrs=dict(attrs))
    exe = pkg.Executor(pkg.CPUPlace())
    return [np.asarray(v) for v in exe.run(prog, feed=feed,
                                           fetch_list=fetch)]


def _op_cases():
    r = np.random.RandomState(0)

    def f(*shape):
        return r.randn(*shape).astype("float32")

    p, g = f(5, 7), f(5, 7)
    adam_ins = {"Param": [("p", p)], "Grad": [("g", g)],
                "LearningRate": [("lr", np.array([2e-3], "float32"))],
                "Moment1": [("m1", f(5, 7))],
                "Moment2": [("m2", np.abs(f(5, 7)))],
                "Beta1Pow": [("b1p", np.array([0.9 ** 3], "float32"))],
                "Beta2Pow": [("b2p", np.array([0.999 ** 3], "float32"))]}
    return [
        ("sgd", {"Param": [("p", p)], "Grad": [("g", g)],
                 "LearningRate": [("lr", np.array([0.1], "float32"))]},
         {"ParamOut": ["po"]}, {}),
        ("adam", adam_ins, {"ParamOut": ["po"], "Moment1Out": ["m1o"],
                            "Moment2Out": ["m2o"]}, {}),
        ("adam", adam_ins, {"ParamOut": ["po"], "Moment1Out": ["m1o"],
                            "Moment2Out": ["m2o"]},
         {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6}),
        ("sum", {"X": [("a", f(3, 4)), ("b", f(3, 4)), ("c", f(3, 4))]},
         {"Out": ["o"]}, {}),
        ("log_softmax", {"X": [("x", f(3, 9))]}, {"Out": ["o"]}, {}),
        ("dropout", {"X": [("x", f(3, 4))]}, {"Out": ["o"], "Mask": ["m"]},
         {"dropout_prob": 0.3, "is_test": True}),
        ("dropout", {"X": [("x", f(3, 4))]}, {"Out": ["o"], "Mask": ["m"]},
         {"dropout_prob": 0.3, "is_test": True,
          "dropout_implementation": "upscale_in_train"}),
    ]


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", OP_CASES, ids=[
    "%s_%d" % (c[0], i) for i, c in enumerate(OP_CASES)])
def test_train_ops_match_jax(case):
    op_type, ins, outs, attrs = case
    want = _run_op(jfluid, op_type, ins, outs, attrs)
    got = _run_op(tfluid, op_type, ins, outs, attrs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=OP_TOL, atol=OP_TOL)


def _seeded_params(program, scope, set_value):
    """Every parameter from numpy, seeded by its name, through
    ``set_value``; the optimizer's state stays as the startup set it."""
    for p in program.global_block().all_parameters():
        rng = np.random.RandomState(_seed_of(p.name))
        set_value(p.name, (0.1 * rng.randn(*p.shape)).astype("float32"))


def _train_both(net, make_opt, feed, steps, fetch_grads):
    """Build ``net`` + ``make_opt(pkg).minimize`` in both packages, seed
    the JAX scope, carry its whole state into the port, run ``steps``
    steps in each. Returns per package (losses, step-1 grads, program)."""
    out = {}
    state = None
    for name, pkg, unique_name in (("jax", jfluid, j_unique_name),
                                   ("torch", tfluid, t_unique_name)):
        main, startup = pkg.Program(), pkg.Program()
        with unique_name.guard({}), pkg.program_guard(main, startup):
            loss = net(pkg)
            _, params_grads = make_opt(pkg).minimize(loss)
        exe = pkg.Executor(pkg.CPUPlace())
        if pkg is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            _seeded_params(main, scope, scope.set_value)
            state = {v.name: np.asarray(scope.get_value(v.name))
                     for v in main.global_block().vars.values()
                     if v.persistable and scope.get_value(v.name) is not None}
        else:
            scope = tfluid.Scope()
            persistables_from_numpy(main, scope, state, "cpu")
        grad_names = [g.name for _, g in params_grads] if fetch_grads else []
        losses, grads = [], None
        for i in range(steps):
            res = exe.run(main, feed=feed, scope=scope,
                          fetch_list=[loss.name] + (grad_names if i == 0
                                                    else []))
            losses.append(float(np.asarray(res[0]).reshape(-1)[0]))
            if i == 0:
                grads = dict(zip(grad_names, (np.asarray(g)
                                              for g in res[1:])))
        out[name] = (losses, grads, main)
    return out


def _mlp(pkg):
    x = pkg.layers.data("x", shape=[16])
    label = pkg.layers.data("label", shape=[1], dtype="int64")
    h = pkg.layers.fc(input=x, size=32, act="relu")
    logits = pkg.layers.fc(input=h, size=10)
    return pkg.layers.reduce_sum(
        pkg.layers.softmax_with_cross_entropy(logits, label))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_mlp_trains_like_jax(opt):
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(8, 16).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}
    make_opt = ((lambda f: f.optimizer.SGD(learning_rate=0.05))
                if opt == "sgd" else
                (lambda f: f.optimizer.Adam(learning_rate=0.01)))
    res = _train_both(_mlp, make_opt, feed, 5, fetch_grads=False)
    (jl, _, jm), (tl, _, tm) = res["jax"], res["torch"]
    np.testing.assert_allclose(tl, jl, rtol=MLP_TOL, atol=MLP_TOL)
    assert tl[-1] < tl[0]
    persist = sorted(v.name for v in tm.global_block().vars.values()
                     if v.persistable)
    assert persist == sorted(v.name for v in jm.global_block().vars.values()
                             if v.persistable)
    if opt == "adam":
        assert "fc_0.w_0_moment1_0" in persist
        assert "fc_0.w_0_beta2_pow_acc_0" in persist
        assert "learning_rate_0" in persist


def _small_transformer(pkg):
    tr = j_transformer if pkg is jfluid else t_transformer
    loss, _, _ = tr.build(src_vocab_size=60, trg_vocab_size=60, max_length=8,
                          n_layer=2, n_head=2, d_model=32, d_inner=64,
                          dropout=0.0, label_smooth_eps=0.1)
    return loss


def _nmt_feed(batch=4, seq=8, vocab=60, seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(1, vocab, (batch, seq)).astype("int64")
    return {"src_word": src,
            "src_len": rng.randint(1, seq + 1, (batch, 1)).astype("int64"),
            "trg_word": rng.randint(1, vocab, (batch, seq)).astype("int64"),
            "trg_len": rng.randint(1, seq + 1, (batch, 1)).astype("int64"),
            "label": src.copy()}


def test_transformer_train_step_matches_jax():
    res = _train_both(_small_transformer,
                      lambda f: f.optimizer.Adam(learning_rate=1e-3),
                      _nmt_feed(), 5, fetch_grads=True)
    (jl, jg, _), (tl, tg, _) = res["jax"], res["torch"]
    assert len(tg) == len(jg) > 0 and set(tg) == set(jg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert tl[-1] < tl[0]


def _dropout_program(impl):
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[64], stop_gradient=False)
        y = tfluid.layers.dropout(x, dropout_prob=0.5,
                                  dropout_implementation=impl)
        loss = tfluid.layers.reduce_sum(y)
        (gx,) = tfluid.backward.calc_gradient(loss, [x])
    return main, x, y, gx


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_grad_replays_the_forward_mask(impl):
    main, x, y, gx = _dropout_program(impl)
    ops = main.global_block().ops
    fwd = next(op for op in ops if op.type == "dropout")
    bwd = next(op for op in ops if op.type == "dropout_grad")
    assert bwd.attrs["__rng_id__"] == fwd.attrs["__rng_id__"]
    mask_name = fwd.output("Mask")[0]
    xs = np.random.RandomState(5).uniform(0.5, 1.5, (6, 64)).astype(
        "float32")
    exe = tfluid.Executor(tfluid.CPUPlace())
    out, mask, grad = exe.run(main, feed={"x": xs},
                              fetch_list=[y, mask_name, gx])
    dropped = mask == 0
    assert 0 < dropped.mean() < 1
    np.testing.assert_array_equal(out == 0, dropped)
    np.testing.assert_array_equal(grad == 0, dropped)
    keep = 2.0 if impl == "upscale_in_train" else 1.0
    np.testing.assert_allclose(grad[~dropped], keep, rtol=1e-6)
    # a test clone flips is_test: no draw, downgrade scales by 1 - p
    test_prog = main.clone(for_test=True)
    (out_t,) = exe.run(test_prog, feed={"x": xs}, fetch_list=[y])
    np.testing.assert_allclose(out_t, xs * (1.0 if keep == 2.0 else 0.5),
                               rtol=1e-6)


def test_release_plan_keeps_fetches_and_state():
    """Each variable leaves the environment after its last use, except
    what the run fetches or writes back."""
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        loss = _mlp(tfluid)
        tfluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    keep = {loss.name, "fc_0.w_0"}
    plan = BlockLowerer(main, 0).release_plan(keep)
    released = [n for names in plan for n in names]
    assert len(released) == len(set(released))
    assert not keep & set(released)
    ops = main.global_block().ops
    for i, names in enumerate(plan):
        for n in names:
            assert not any(n in op.input_arg_names() + op.output_arg_names()
                           for op in ops[i + 1:])
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 16).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    h_name = ops[0].output("Out")[0]  # an intermediate, fetched
    lv, h = exe.run(main, feed=feed, fetch_list=[loss, h_name])
    assert np.isfinite(lv).all() and h.shape == (4, 32)


def test_persistables_from_numpy_names_what_is_missing():
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        tfluid.optimizer.Adam(learning_rate=0.1).minimize(_mlp(tfluid))
    with pytest.raises(KeyError, match="moment1"):
        persistables_from_numpy(main, tfluid.Scope(), {
            p.name: np.zeros(p.shape, "float32")
            for p in main.global_block().all_parameters()}, "cpu")


def test_port_reproduces_the_transformer_golden():
    """tests/golden/transformer.npz (the JAX package's Transformer logits
    with deterministic weights, label smoothing at its default 0.1):
    the port's ``build`` now carries the label-smoothed head, so it
    builds the golden's program and reproduces its logits. The label
    feeds only the loss, not the fetched logits."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "transformer.npz"))
    main, startup = tfluid.Program(), tfluid.Program()
    with t_unique_name.guard({}), tfluid.program_guard(main, startup):
        _, _, outs = t_transformer.build(
            src_vocab_size=60, trg_vocab_size=60, max_length=8, n_layer=1,
            n_head=2, d_model=32, d_inner=64, dropout=0.0)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    set_deterministic_params(main, scope)
    feed = {k[len("feed_"):]: golden[k] for k in golden.files
            if k.startswith("feed_")}
    feed["label"] = np.zeros_like(feed["src_word"])
    (logits,) = exe.run(main, feed=feed, fetch_list=[outs["logits"]],
                        scope=scope)
    np.testing.assert_allclose(logits, golden["expected"], rtol=1e-5,
                               atol=1e-5)
