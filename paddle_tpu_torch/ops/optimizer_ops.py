"""Optimizer update ops: sgd, momentum, lars_momentum, adam, adamax,
adagrad, decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd and
proximal_adagrad.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py`` (paddle/fluid/
operators/*_op.cc) with the same formulas. Each op reads the
parameter and its accumulators and returns new tensors that the program
binds back onto the same variable names; the executor writes them into
the scope after the step.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.op_registry import register_op


def _scalar(ins, slot, like):
    return ins[slot][0].reshape(()).to(like.dtype)


register_op(
    "sgd",
    inputs=["Param", "Grad", "LearningRate"],
    outputs=["ParamOut"],
    lower=lambda ctx, ins, attrs: ins["Param"][0] - _scalar(
        ins, "LearningRate", ins["Param"][0]) * ins["Grad"][0],
    grad=None,
)


def _lower_adam(ctx, ins, attrs):
    """m1 = b1 m1 + (1-b1) g; m2 = b2 m2 + (1-b2) g^2;
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t); p -= lr_t m1 / (sqrt(m2) + eps)
    (epsilon outside the sqrt, as adam_op.h)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p = _scalar(ins, "Beta1Pow", p)
    b2p = _scalar(ins, "Beta2Pow", p)
    lr = _scalar(ins, "LearningRate", p)
    # the constants in float32, as the reference rounds them
    b1 = np.float32(attrs.get("beta1", 0.9))
    b2 = np.float32(attrs.get("beta2", 0.999))
    eps = float(np.float32(attrs.get("epsilon", 1e-8)))
    m1o = float(b1) * m1 + float(np.float32(1) - b1) * g
    m2o = float(b2) * m2 + float(np.float32(1) - b2) * torch.square(g)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return {"ParamOut": p_out, "Moment1Out": m1o, "Moment2Out": m2o}


register_op(
    "adam",
    inputs=["Param", "Grad", "LearningRate", "Moment1", "Moment2",
            "Beta1Pow", "Beta2Pow"],
    outputs=["ParamOut", "Moment1Out", "Moment2Out"],
    attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
           "lazy_mode": False},
    lower=_lower_adam,
    grad=None,
)


def _c(attrs, name, default, like):
    """An attr as a 0-d tensor of ``like``'s dtype (jnp.asarray(v, dtype))."""
    return torch.tensor(attrs.get(name, default), dtype=like.dtype,
                        device=like.device)


def _lower_momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _scalar(ins, "LearningRate", p)
    mu = _c(attrs, "mu", 0.0, p)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


register_op(
    "momentum",
    inputs=["Param", "Grad", "Velocity", "LearningRate"],
    outputs=["ParamOut", "VelocityOut"],
    attrs={"mu": 0.0, "use_nesterov": False},
    lower=_lower_momentum,
    grad=None,
)


def _lower_lars_momentum(ctx, ins, attrs):
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    lr = _scalar(ins, "LearningRate", p)
    mu = _c(attrs, "mu", 0.0, p)
    lars_coeff = attrs.get("lars_coeff", 0.001)
    lars_wd = attrs.get("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(torch.square(p)))
    g_norm = torch.sqrt(torch.sum(torch.square(g)))
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + lars_wd * p_norm + 1e-12),
        lr)
    v_out = mu * v + local_lr * (g + lars_wd * p)
    return {"ParamOut": p - v_out, "VelocityOut": v_out}


register_op(
    "lars_momentum",
    inputs=["Param", "Grad", "Velocity", "LearningRate"],
    outputs=["ParamOut", "VelocityOut"],
    attrs={"mu": 0.0, "lars_coeff": 0.001, "lars_weight_decay": 0.0005},
    lower=_lower_lars_momentum,
    grad=None,
)


def _lower_adamax(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = _scalar(ins, "Beta1Pow", p)
    lr = _scalar(ins, "LearningRate", p)
    b1 = _c(attrs, "beta1", 0.9, p)
    b2 = _c(attrs, "beta2", 0.999, p)
    eps = _c(attrs, "epsilon", 1e-8, p)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    lr_t = lr / (1 - b1p)
    p_out = p - lr_t * m_out / (inf_out + eps)
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out}


register_op(
    "adamax",
    inputs=["Param", "Grad", "LearningRate", "Moment", "InfNorm",
            "Beta1Pow"],
    outputs=["ParamOut", "MomentOut", "InfNormOut"],
    attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    lower=_lower_adamax,
    grad=None,
)


def _lower_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    eps = _c(attrs, "epsilon", 1e-6, p)
    m_out = mom + torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out, "MomentOut": m_out}


register_op(
    "adagrad",
    inputs=["Param", "Grad", "Moment", "LearningRate"],
    outputs=["ParamOut", "MomentOut"],
    attrs={"epsilon": 1e-6},
    lower=_lower_adagrad,
    grad=None,
)


def _lower_decayed_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    decay = _c(attrs, "decay", 0.95, p)
    eps = _c(attrs, "epsilon", 1e-6, p)
    m_out = decay * mom + (1 - decay) * torch.square(g)
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out, "MomentOut": m_out}


register_op(
    "decayed_adagrad",
    inputs=["Param", "Grad", "Moment", "LearningRate"],
    outputs=["ParamOut", "MomentOut"],
    attrs={"decay": 0.95, "epsilon": 1e-6},
    lower=_lower_decayed_adagrad,
    grad=None,
)


def _lower_adadelta(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    avg_sq_g, avg_sq_u = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    rho = _c(attrs, "rho", 0.95, p)
    eps = _c(attrs, "epsilon", 1e-6, p)
    asg_out = rho * avg_sq_g + (1 - rho) * torch.square(g)
    update = -torch.sqrt((avg_sq_u + eps) / (asg_out + eps)) * g
    asu_out = rho * avg_sq_u + (1 - rho) * torch.square(update)
    return {"ParamOut": p + update, "AvgSquaredGradOut": asg_out,
            "AvgSquaredUpdateOut": asu_out}


register_op(
    "adadelta",
    inputs=["Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"],
    outputs=["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
    attrs={"rho": 0.95, "epsilon": 1e-6},
    lower=_lower_adadelta,
    grad=None,
)


def _lower_rmsprop(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    rho = _c(attrs, "decay", 0.9, p)
    eps = _c(attrs, "epsilon", 1e-10, p)
    momentum = _c(attrs, "momentum", 0.0, p)
    out = {}
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    if attrs.get("centered", False):
        mg = ins["MeanGrad"][0]
        mg_out = rho * mg + (1 - rho) * g
        denom = ms_out - torch.square(mg_out) + eps
        out["MeanGradOut"] = mg_out
    else:
        denom = ms_out + eps
    mom_out = momentum * mom + lr * g / torch.sqrt(denom)
    out.update({"ParamOut": p - mom_out, "MomentOut": mom_out,
                "MeanSquareOut": ms_out})
    return out


register_op(
    "rmsprop",
    inputs=["Param", "Grad", "MeanSquare", "MeanGrad", "Moment",
            "LearningRate"],
    outputs=["ParamOut", "MomentOut", "MeanSquareOut", "MeanGradOut"],
    attrs={"decay": 0.9, "epsilon": 1e-10, "momentum": 0.0,
           "centered": False},
    lower=_lower_rmsprop,
    grad=None,
)


def _lower_ftrl(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    lr = _scalar(ins, "LearningRate", p)
    l1 = _c(attrs, "l1", 0.0, p)
    l2 = _c(attrs, "l2", 0.0, p)
    power = _c(attrs, "lr_power", -0.5, p)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
    lin_out = lin + g - sigma * p
    x = l1 * torch.sign(lin_out) - lin_out
    y = torch.pow(new_sq, -power) / lr + 2 * l2
    p_out = torch.where(torch.abs(lin_out) > l1, x / y, torch.zeros_like(p))
    return {"ParamOut": p_out, "SquaredAccumOut": new_sq,
            "LinearAccumOut": lin_out}


register_op(
    "ftrl",
    inputs=["Param", "Grad", "SquaredAccumulator", "LinearAccumulator",
            "LearningRate"],
    outputs=["ParamOut", "SquaredAccumOut", "LinearAccumOut"],
    attrs={"l1": 0.0, "l2": 0.0, "lr_power": -0.5},
    lower=_lower_ftrl,
    grad=None,
)


def _proximal(prox, lr_t, l1, l2):
    return (torch.sign(prox)
            * torch.maximum(torch.abs(prox) - lr_t * l1,
                            torch.zeros((), dtype=prox.dtype,
                                        device=prox.device))
            / (1.0 + lr_t * l2))


def _lower_proximal_gd(ctx, ins, attrs):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = _scalar(ins, "LearningRate", p)
    l1 = _c(attrs, "l1", 0.0, p)
    l2 = _c(attrs, "l2", 0.0, p)
    return {"ParamOut": _proximal(p - lr * g, lr, l1, l2)}


register_op(
    "proximal_gd",
    inputs=["Param", "Grad", "LearningRate"],
    outputs=["ParamOut"],
    attrs={"l1": 0.0, "l2": 0.0},
    lower=_lower_proximal_gd,
    grad=None,
)


def _lower_proximal_adagrad(ctx, ins, attrs):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = _scalar(ins, "LearningRate", p)
    l1 = _c(attrs, "l1", 0.0, p)
    l2 = _c(attrs, "l2", 0.0, p)
    m_out = mom + torch.square(g)
    lr_t = lr / torch.sqrt(m_out)
    return {"ParamOut": _proximal(p - lr_t * g, lr_t, l1, l2),
            "MomentOut": m_out}


register_op(
    "proximal_adagrad",
    inputs=["Param", "Grad", "Moment", "LearningRate"],
    outputs=["ParamOut", "MomentOut"],
    attrs={"l1": 0.0, "l2": 0.0},
    lower=_lower_proximal_adagrad,
    grad=None,
)
