"""The port's optimizers against numpy oracles and the JAX package, on
the CPU.

- every update op of ``ops/optimizer_ops.py`` after one step against the
  float64 numpy mirror of its reference rule (the oracles of
  ``tests/test_op_breadth_misc.py``), within rtol 1e-5 + atol 1e-6;
- every optimizer class trained 5 steps on ``test_torch_train.py``'s MLP
  from the JAX package's initial state: losses within ``MLP_TOL`` (1e-5),
  persistable names equal (the accumulators' names carry the state);
- ``ModelAverage``: the averaged parameters after ``apply``, and the
  trained ones after ``restore``, equal to the JAX package's.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch import unique_name as t_unique_name
from paddle_tpu_torch.convert import persistables_from_numpy
from paddle_tpu_torch.testing import fresh_state
from test_torch_train import MLP_TOL, _mlp, _seeded_params, _train_both

ORACLE_RTOL, ORACLE_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_torch_state():
    with fresh_state():
        yield


def _run_op(op_type, ins, outs, attrs):
    """One ``op_type`` op through the port's CPU executor; returns the
    fetched outputs by name."""
    prog = tfluid.Program()
    blk = prog.global_block()
    for name, arr in ins.items():
        blk.create_var(name=name, shape=arr.shape, dtype=str(arr.dtype),
                       is_data=True)
    for name in outs:
        blk.create_var(name=name + "_out")
    blk.append_op(type=op_type,
                  inputs={s: [s] for s in ins},
                  outputs={s: [s + "_out"] for s in outs},
                  attrs=dict(attrs))
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = exe.run(prog, feed=ins, fetch_list=[n + "_out" for n in outs])
    return dict(zip(outs, got))


def _opt_inputs(seed, extra=()):
    rng = np.random.RandomState(seed)
    ins = {"Param": rng.randn(3, 4).astype("float32"),
           "Grad": rng.randn(3, 4).astype("float32"),
           "LearningRate": np.asarray([0.05], "float32")}
    for slot in extra:
        ins[slot] = np.abs(rng.randn(3, 4)).astype("float32") * 0.1
    return ins


def _f64(ins, *slots):
    return [ins[s].astype("float64") for s in slots]


def _momentum(nesterov):
    ins = _opt_inputs(49, ["Velocity"])
    p, g, v = _f64(ins, "Param", "Grad", "Velocity")
    lr, mu = 0.05, 0.9
    v_o = mu * v + g
    p_o = p - (g + mu * v_o) * lr if nesterov else p - lr * v_o
    return ins, {"ParamOut": p_o, "VelocityOut": v_o}, {
        "mu": mu, "use_nesterov": nesterov}


def _adadelta():
    ins = _opt_inputs(50, ["AvgSquaredGrad", "AvgSquaredUpdate"])
    del ins["LearningRate"]  # adadelta_op.cc has no LR input
    p, g, asg, asu = _f64(ins, "Param", "Grad", "AvgSquaredGrad",
                          "AvgSquaredUpdate")
    rho, eps = 0.95, 1e-6
    asg_o = rho * asg + (1 - rho) * g * g
    upd = -np.sqrt((asu + eps) / (asg_o + eps)) * g
    asu_o = rho * asu + (1 - rho) * upd * upd
    return ins, {"ParamOut": p + upd, "AvgSquaredGradOut": asg_o,
                 "AvgSquaredUpdateOut": asu_o}, {"rho": rho, "epsilon": eps}


def _adagrad():
    ins = _opt_inputs(51, ["Moment"])
    p, g, m = _f64(ins, "Param", "Grad", "Moment")
    lr, eps = 0.05, 1e-6
    m_o = m + g * g
    return ins, {"ParamOut": p - lr * g / (np.sqrt(m_o) + eps),
                 "MomentOut": m_o}, {"epsilon": eps}


def _adamax():
    ins = _opt_inputs(52, ["Moment", "InfNorm"])
    ins["Beta1Pow"] = np.asarray([0.9], "float32")
    p, g, m, inf = _f64(ins, "Param", "Grad", "Moment", "InfNorm")
    lr, b1, b2, eps = 0.05, 0.9, 0.999, 1e-8
    m_o = b1 * m + (1 - b1) * g
    inf_o = np.maximum(b2 * inf, np.abs(g))
    return ins, {"ParamOut": p - lr / (1 - 0.9) * m_o / (inf_o + eps),
                 "MomentOut": m_o, "InfNormOut": inf_o}, {
        "beta1": b1, "beta2": b2, "epsilon": eps}


def _decayed_adagrad():
    ins = _opt_inputs(53, ["Moment"])
    p, g, m = _f64(ins, "Param", "Grad", "Moment")
    lr, decay, eps = 0.05, 0.95, 1e-6
    m_o = decay * m + (1 - decay) * g * g
    return ins, {"ParamOut": p - lr * g / (np.sqrt(m_o) + eps),
                 "MomentOut": m_o}, {"decay": decay, "epsilon": eps}


def _ftrl():
    ins = _opt_inputs(54, ["SquaredAccumulator", "LinearAccumulator"])
    p, g, sq, lin = _f64(ins, "Param", "Grad", "SquaredAccumulator",
                         "LinearAccumulator")
    lr, l1, l2, power = 0.05, 0.1, 0.1, -0.5
    new_sq = sq + g * g
    sigma = (new_sq ** -power - sq ** -power) / lr
    lin_o = lin + g - sigma * p
    x = l1 * np.sign(lin_o) - lin_o
    y = new_sq ** -power / lr + 2 * l2
    return ins, {"ParamOut": np.where(np.abs(lin_o) > l1, x / y, 0.0),
                 "SquaredAccumOut": new_sq, "LinearAccumOut": lin_o}, {
        "l1": l1, "l2": l2, "lr_power": power}


def _rmsprop(centered):
    ins = _opt_inputs(55, ["MeanSquare", "MeanGrad", "Moment"])
    p, g, ms, mg, mom = _f64(ins, "Param", "Grad", "MeanSquare", "MeanGrad",
                             "Moment")
    lr, rho, eps, mu = 0.05, 0.9, 1e-10, 0.9
    ms_o = rho * ms + (1 - rho) * g * g
    outs = {"MeanSquareOut": ms_o}
    if centered:
        mg_o = rho * mg + (1 - rho) * g
        denom = ms_o - mg_o * mg_o + eps
        outs["MeanGradOut"] = mg_o
    else:
        denom = ms_o + eps
    mom_o = mu * mom + lr * g / np.sqrt(denom)
    outs.update({"ParamOut": p - mom_o, "MomentOut": mom_o})
    return ins, outs, {"decay": rho, "epsilon": eps, "momentum": mu,
                       "centered": centered}


def _proximal(prox, lr_t, l1, l2):
    return np.sign(prox) * np.maximum(np.abs(prox) - lr_t * l1, 0) / (
        1 + lr_t * l2)


def _proximal_adagrad():
    ins = _opt_inputs(56, ["Moment"])
    p, g, m = _f64(ins, "Param", "Grad", "Moment")
    lr, l1, l2 = 0.05, 0.1, 0.05
    m_o = m + g * g
    lr_t = lr / np.sqrt(m_o)
    return ins, {"ParamOut": _proximal(p - lr_t * g, lr_t, l1, l2),
                 "MomentOut": m_o}, {"l1": l1, "l2": l2}


def _proximal_gd():
    ins = _opt_inputs(57)
    p, g = _f64(ins, "Param", "Grad")
    lr, l1, l2 = 0.05, 0.1, 0.05
    return ins, {"ParamOut": _proximal(p - lr * g, lr, l1, l2)}, {
        "l1": l1, "l2": l2}


def _lars_momentum():
    ins = _opt_inputs(58, ["Velocity"])
    p, g, v = _f64(ins, "Param", "Grad", "Velocity")
    lr, mu, coeff, wd = 0.05, 0.9, 0.001, 0.0005
    p_n = np.sqrt(np.sum(p * p))
    g_n = np.sqrt(np.sum(g * g))
    local_lr = lr * coeff * p_n / (g_n + wd * p_n + 1e-12)
    v_o = mu * v + local_lr * (g + wd * p)
    return ins, {"ParamOut": p - v_o, "VelocityOut": v_o}, {
        "mu": mu, "lars_coeff": coeff, "lars_weight_decay": wd}


UPDATE_CASES = [
    ("momentum", lambda: _momentum(False)),
    ("momentum", lambda: _momentum(True)),
    ("lars_momentum", _lars_momentum),
    ("adagrad", _adagrad),
    ("adamax", _adamax),
    ("decayed_adagrad", _decayed_adagrad),
    ("adadelta", _adadelta),
    ("rmsprop", lambda: _rmsprop(False)),
    ("rmsprop", lambda: _rmsprop(True)),
    ("ftrl", _ftrl),
    ("proximal_gd", _proximal_gd),
    ("proximal_adagrad", _proximal_adagrad),
]


@pytest.mark.parametrize("case", UPDATE_CASES, ids=[
    "momentum", "momentum_nesterov", "lars_momentum", "adagrad", "adamax",
    "decayed_adagrad", "adadelta", "rmsprop", "rmsprop_centered", "ftrl",
    "proximal_gd", "proximal_adagrad"])
def test_update_op_matches_numpy_oracle(case):
    op_type, make = case
    ins, want, attrs = make()
    got = _run_op(op_type, ins, list(want), attrs)
    for slot, w in want.items():
        np.testing.assert_allclose(got[slot], w, rtol=ORACLE_RTOL,
                                   atol=ORACLE_ATOL, err_msg=slot)


def _mlp_feed():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(8, 16).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}


# (name, optimizer factory, accumulator suffixes of fc_0.w_0 it creates)
OPTIMIZERS = [
    ("momentum", lambda f: f.optimizer.Momentum(0.05, 0.9),
     ["velocity_0"]),
    ("nesterov", lambda f: f.optimizer.Momentum(0.05, 0.9,
                                                use_nesterov=True),
     ["velocity_0"]),
    ("lars_momentum", lambda f: f.optimizer.LarsMomentum(0.5, 0.9),
     ["velocity_0"]),
    ("adagrad", lambda f: f.optimizer.Adagrad(0.05), ["moment_0"]),
    ("adamax", lambda f: f.optimizer.Adamax(0.01),
     ["moment_0", "inf_norm_0", "beta1_pow_acc_0"]),
    ("decayed_adagrad", lambda f: f.optimizer.DecayedAdagrad(0.01),
     ["moment_0"]),
    ("adadelta", lambda f: f.optimizer.Adadelta(1.0),
     ["_avg_squared_grad_0", "_avg_squared_update_0"]),
    ("rmsprop", lambda f: f.optimizer.RMSProp(0.01),
     ["momentum_0", "mean_square_0", "mean_grad_0"]),
    ("rmsprop_centered", lambda f: f.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True),
     ["momentum_0", "mean_square_0", "mean_grad_0"]),
    ("ftrl", lambda f: f.optimizer.Ftrl(0.05, l1=0.01, l2=0.01),
     ["squared_0", "linear_0"]),
]


@pytest.mark.parametrize("case", OPTIMIZERS, ids=[c[0] for c in OPTIMIZERS])
def test_optimizer_trains_mlp_like_jax(case):
    name, make_opt, accs = case
    res = _train_both(_mlp, make_opt, _mlp_feed(), 5, fetch_grads=False)
    (jl, _, jm), (tl, _, tm) = res["jax"], res["torch"]
    np.testing.assert_allclose(tl, jl, rtol=MLP_TOL, atol=MLP_TOL)
    assert tl[-1] < tl[0]
    persist = sorted(v.name for v in tm.global_block().vars.values()
                     if v.persistable)
    assert persist == sorted(v.name for v in jm.global_block().vars.values()
                             if v.persistable)
    for acc in accs:
        assert "fc_0.w_0_" + acc in persist, acc


def test_optimizer_aliases():
    for alias, cls in [("Momentum", "MomentumOptimizer"),
                       ("LarsMomentum", "LarsMomentumOptimizer"),
                       ("Adagrad", "AdagradOptimizer"),
                       ("Adamax", "AdamaxOptimizer"),
                       ("DecayedAdagrad", "DecayedAdagradOptimizer"),
                       ("Adadelta", "AdadeltaOptimizer"),
                       ("RMSProp", "RMSPropOptimizer"),
                       ("Ftrl", "FtrlOptimizer")]:
        assert getattr(tfluid.optimizer, alias) is getattr(
            tfluid.optimizer, cls)


def _average_run(pkg, unique_name, state):
    """3 Momentum steps with a ModelAverage over every parameter; returns
    (the parameters after ``apply``, after ``restore``, the state)."""
    main, startup = pkg.Program(), pkg.Program()
    with unique_name.guard({}), pkg.program_guard(main, startup):
        loss = _mlp(pkg)
        _, params_grads = pkg.optimizer.Momentum(0.05, 0.9).minimize(loss)
        avg = pkg.optimizer.ModelAverage(0.15)
        avg.build([p for p, _ in params_grads])
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
    for _ in range(3):
        exe.run(main, feed=_mlp_feed(), scope=scope, fetch_list=[loss])
    names = sorted(p.name for p, _ in params_grads)

    def values():
        return {n: np.asarray(scope.get_value(n)) for n in names}

    avg.apply(exe, scope)
    applied = values()
    avg.restore(exe, scope)
    return applied, values(), state


def test_model_average_apply_restore_like_jax():
    j_applied, j_restored, state = _average_run(jfluid, j_unique_name, None)
    t_applied, t_restored, _ = _average_run(tfluid, t_unique_name, state)
    assert set(t_applied) == set(j_applied)
    for n in j_applied:
        np.testing.assert_allclose(t_applied[n], j_applied[n], rtol=MLP_TOL,
                                   atol=MLP_TOL, err_msg=n)
        np.testing.assert_allclose(t_restored[n], j_restored[n],
                                   rtol=MLP_TOL, atol=MLP_TOL, err_msg=n)
        assert not np.allclose(t_applied[n], t_restored[n])
