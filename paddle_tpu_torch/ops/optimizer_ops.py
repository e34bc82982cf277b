"""Optimizer update ops: sgd and adam.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py`` (paddle/fluid/
operators/{sgd,adam}_op.cc) with the same formulas. Each op reads the
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
