"""Activation family (activation_op.cc) and softmax (softmax_op.cc).

Counterpart of ``paddle_tpu/ops/activation_ops.py``: the same ops, attrs
and formulas, on torch tensors. Each formula is written as the JAX
package writes it, so that the gradient matches too where torch's own
function would choose another value at a tie: ``clip`` is
``minimum(maximum(x, lo), hi)`` (jnp.clip; a boundary value takes half
the gradient, as torch.maximum and torch.minimum split ties), ``abs``
takes gradient 1 at 0 (lax.abs), ``leaky_relu`` and ``elu`` pick their
branch as jax.nn does, and ``gelu`` is jax.nn.gelu's tanh form.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.op_registry import register_op


def _const(value, x):
    """A 0-d tensor of ``x``'s dtype and device (jnp.asarray(v, dtype))."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def clip(x, lo, hi):
    """jnp.clip: ``minimum(maximum(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, _const(lo, x)), _const(hi, x))


def jax_abs(x):
    """|x| with lax.abs's gradient: +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _gelu(x):
    """jax.nn.gelu(approximate=True)."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                  * (x + 0.044715 * x ** 3)))
    return x * cdf


def _unary(fn):
    return lambda ctx, ins, attrs: fn(ins["X"][0])


_SIMPLE = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "exp": torch.exp,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "tanh_shrink": lambda x: x - torch.tanh(x),
    "sqrt": torch.sqrt,
    "abs": jax_abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "cos": torch.cos,
    "sin": torch.sin,
    "round": torch.round,
    "reciprocal": torch.reciprocal,
    "log": torch.log,
    "square": torch.square,
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x: x / (1 + jax_abs(x)),
    "sign": torch.sign,
    "gelu": _gelu,
}

for _name, _fn in _SIMPLE.items():
    register_op(
        _name,
        inputs=["X"],
        outputs=["Out"],
        lower=_unary(_fn),
        grad=None if _name in ("ceil", "floor", "round", "sign") else "auto",
    )

register_op(
    "relu6",
    inputs=["X"],
    outputs=["Out"],
    attrs={"threshold": 6.0},
    lower=lambda ctx, ins, attrs: clip(
        ins["X"][0], 0.0, attrs.get("threshold", 6.0)),
)


def _leaky_relu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


register_op(
    "leaky_relu",
    inputs=["X"],
    outputs=["Out"],
    attrs={"alpha": 0.02},
    lower=lambda ctx, ins, attrs: _leaky_relu(
        ins["X"][0], attrs.get("alpha", 0.02)),
)


def _elu(x, alpha):
    safe = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(safe))


register_op(
    "elu",
    inputs=["X"],
    outputs=["Out"],
    attrs={"alpha": 1.0},
    lower=lambda ctx, ins, attrs: _elu(ins["X"][0], attrs.get("alpha", 1.0)),
)

register_op(
    "pow",
    inputs=["X"],
    outputs=["Out"],
    attrs={"factor": 1.0},
    lower=lambda ctx, ins, attrs: torch.pow(
        ins["X"][0], _const(attrs.get("factor", 1.0), ins["X"][0])),
)

register_op(
    "stanh",
    inputs=["X"],
    outputs=["Out"],
    attrs={"scale_a": 2.0 / 3.0, "scale_b": 1.7159},
    lower=lambda ctx, ins, attrs: attrs.get("scale_b", 1.7159) * torch.tanh(
        ins["X"][0] * attrs.get("scale_a", 2.0 / 3.0)),
)

register_op(
    "hard_sigmoid",
    inputs=["X"],
    outputs=["Out"],
    attrs={"slope": 0.2, "offset": 0.5},
    lower=lambda ctx, ins, attrs: clip(
        ins["X"][0] * attrs.get("slope", 0.2) + attrs.get("offset", 0.5),
        0.0, 1.0),
)

register_op(
    "thresholded_relu",
    inputs=["X"],
    outputs=["Out"],
    attrs={"threshold": 1.0},
    lower=lambda ctx, ins, attrs: torch.where(
        ins["X"][0] > attrs.get("threshold", 1.0), ins["X"][0],
        torch.zeros_like(ins["X"][0])),
)

register_op(
    "soft_relu",
    inputs=["X"],
    outputs=["Out"],
    attrs={"threshold": 40.0},
    lower=lambda ctx, ins, attrs: torch.log(1.0 + torch.exp(clip(
        ins["X"][0], -attrs["threshold"], attrs["threshold"]))),
)

register_op(
    "brelu",
    inputs=["X"],
    outputs=["Out"],
    attrs={"t_min": 0.0, "t_max": 24.0},
    lower=lambda ctx, ins, attrs: clip(
        ins["X"][0], attrs.get("t_min", 0.0), attrs.get("t_max", 24.0)),
)

register_op(
    "swish",
    inputs=["X"],
    outputs=["Out"],
    attrs={"beta": 1.0},
    lower=lambda ctx, ins, attrs: ins["X"][0] * torch.sigmoid(
        attrs.get("beta", 1.0) * ins["X"][0]),
)


def _prelu_shape(x, mode):
    if mode == "all":
        return (1,) * x.dim()
    if mode == "channel":
        return (1, -1) + (1,) * (x.dim() - 2)
    # element: one value per non-batch element, broadcast over the batch
    return (1,) + tuple(x.shape[1:])


register_op(
    "prelu",
    inputs=["X", "Alpha"],
    outputs=["Out"],
    attrs={"mode": "all"},
    lower=lambda ctx, ins, attrs: torch.where(
        ins["X"][0] >= 0, ins["X"][0],
        ins["X"][0] * ins["Alpha"][0].reshape(
            _prelu_shape(ins["X"][0], attrs.get("mode", "all")))),
)

register_op(
    "softmax",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.softmax(ins["X"][0], dim=-1),
)

register_op(
    "log_softmax",
    inputs=["X"],
    outputs=["Out"],
    attrs={"axis": -1},
    lower=lambda ctx, ins, attrs: torch.log_softmax(
        ins["X"][0], dim=attrs.get("axis", -1)),
)

register_op(
    "softshrink",
    inputs=["X"],
    outputs=["Out"],
    attrs={"lambda": 0.5},
    lower=lambda ctx, ins, attrs: torch.sign(ins["X"][0]) * torch.maximum(
        jax_abs(ins["X"][0]) - attrs.get("lambda", 0.5),
        _const(0.0, ins["X"][0])),
)

register_op(
    "hard_shrink",
    inputs=["X"],
    outputs=["Out"],
    attrs={"threshold": 0.5},
    lower=lambda ctx, ins, attrs: torch.where(
        jax_abs(ins["X"][0]) > attrs.get("threshold", 0.5), ins["X"][0],
        torch.zeros_like(ins["X"][0])),
)

register_op(
    "rsqrt",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.rsqrt(ins["X"][0]),
)


def _maxout(x, groups):
    n, c, h, w = x.shape
    return torch.amax(x.reshape(n, c // groups, groups, h, w), dim=2)


register_op(
    "maxout",
    inputs=["X"],
    outputs=["Out"],
    attrs={"groups": 1},
    lower=lambda ctx, ins, attrs: _maxout(ins["X"][0],
                                          attrs.get("groups", 1)),
)
