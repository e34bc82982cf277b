"""Dense math ops: mul / matmul / elementwise / reduce / scale / sum /
clip / cumsum / norms / ...

Counterpart of ``paddle_tpu/ops/math_ops.py``: the same ops, attrs and
formulas. A plain matrix product goes to ``torch.matmul`` (fp32, TF32
off), as the JAX package leaves it to XLA. ``clip`` is
``minimum(maximum(x, min), max)``, as jnp.clip computes it, so a value
on a boundary takes half the gradient, as in the JAX package;
``reduce_max`` / ``reduce_min`` share the gradient among ties (amax /
amin), as jnp.max does.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.ops.activation_ops import clip as _clip
from paddle_tpu_torch.ops.activation_ops import jax_abs
from paddle_tpu_torch.ops.common import (
    broadcast_y,
    flatten_to_2d,
    reduce_axes,
    scalar_like,
)


def _lower_mul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    out = flatten_to_2d(x, xn) @ flatten_to_2d(y, yn)
    return out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))


register_op(
    "mul",
    inputs=["X", "Y"],
    outputs=["Out"],
    attrs={"x_num_col_dims": 1, "y_num_col_dims": 1},
    lower=_lower_mul,
)


def _lower_matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * float(alpha)
    return out


register_op(
    "matmul",
    inputs=["X", "Y"],
    outputs=["Out"],
    attrs={"transpose_X": False, "transpose_Y": False, "alpha": 1.0},
    lower=_lower_matmul,
)


def _floor_divide(x, y):
    """Its gradient is zero, as jnp.floor_divide's: torch has none, so
    the quotient is taken off the graph."""
    return torch.floor_divide(x.detach(), y.detach())


def _elementwise(fn):
    def lower(ctx, ins, attrs):
        x, y = ins["X"][0], ins["Y"][0]
        return fn(x, broadcast_y(x, y, attrs.get("axis", -1)))

    return lower


for _name, _fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum),
    ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
    ("elementwise_mod", torch.remainder),
    ("elementwise_floordiv", _floor_divide),
]:
    register_op(
        _name,
        inputs=["X", "Y"],
        outputs=["Out"],
        attrs={"axis": -1},
        lower=_elementwise(_fn),
    )


# ``sum`` adds its inputs left to right; backward.py emits it to add up
# the gradient contributions of a variable read more than once
register_op(
    "sum",
    inputs=["*X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: sum(ins["X"][1:], ins["X"][0]),
)


def _lower_scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = scalar_like(attrs.get("scale", 1.0), x)
    bias = scalar_like(attrs.get("bias", 0.0), x)
    if attrs.get("bias_after_scale", True):
        return x * scale + bias
    return (x + bias) * scale


register_op(
    "scale",
    inputs=["X"],
    outputs=["Out"],
    attrs={"scale": 1.0, "bias": 0.0, "bias_after_scale": True},
    lower=_lower_scale,
)


def _prod(x, dim, keepdim):
    """torch.prod takes one dim: reduce the axes one at a time, the last
    first, so the indices of the rest stay put."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn):
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        axes = reduce_axes(x.dim(), attrs.get("dim", [0]),
                           attrs.get("reduce_all", False))
        out = fn(x, dim=axes, keepdim=attrs.get("keep_dim", False))
        if out.dim() == 0:
            out = out.reshape(1)
        return out

    return lower


for _name, _fn in [
    ("reduce_sum", torch.sum),
    ("reduce_mean", torch.mean),
    ("reduce_max", torch.amax),
    ("reduce_min", torch.amin),
    ("reduce_prod", _prod),
]:
    register_op(
        _name,
        inputs=["X"],
        outputs=["Out"],
        attrs={"dim": [0], "keep_dim": False, "reduce_all": False},
        lower=_reduce(_fn),
    )

register_op(
    "mean",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.mean(ins["X"][0]).reshape(1),
)


register_op(
    "clip",
    inputs=["X"],
    outputs=["Out"],
    attrs={"min": 0.0, "max": 0.0},
    lower=lambda ctx, ins, attrs: _clip(ins["X"][0], attrs["min"],
                                        attrs["max"]),
)


def _clip_by_norm(x, max_norm):
    norm = torch.sqrt(torch.sum(torch.square(x)))
    max_norm = torch.tensor(max_norm, dtype=x.dtype, device=x.device)
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


register_op(
    "clip_by_norm",
    inputs=["X"],
    outputs=["Out"],
    attrs={"max_norm": 1.0},
    lower=lambda ctx, ins, attrs: _clip_by_norm(ins["X"][0],
                                                attrs["max_norm"]),
)


def _cumsum(x, attrs):
    axis = attrs.get("axis", -1)
    reverse = attrs.get("reverse", False)
    if reverse:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    if reverse:
        out = torch.flip(out, (axis,))
    return out


register_op(
    "cumsum",
    inputs=["X"],
    outputs=["Out"],
    attrs={"axis": -1, "exclusive": False, "reverse": False},
    lower=lambda ctx, ins, attrs: _cumsum(ins["X"][0], attrs),
)


def _l2_normalize(x, attrs):
    axis = attrs.get("axis", -1)
    eps = float(attrs.get("epsilon", 1e-10))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                      + eps)
    return x / norm, norm


for _name, _axis in (("l2_normalize", -1), ("norm", 1)):
    register_op(
        _name,
        inputs=["X"],
        outputs=["Out", "Norm"],
        attrs={"axis": _axis, "epsilon": 1e-10},
        lower=lambda ctx, ins, attrs: _l2_normalize(ins["X"][0], attrs),
        intermediate_outputs=("Norm",),
    )


def _lower_isfinite(ctx, ins, attrs):
    flat = [torch.isfinite(x).all() for x in ins["X"]]
    return torch.stack(flat).all().reshape(1)


register_op("isfinite", inputs=["*X"], outputs=["Out"],
            lower=_lower_isfinite, grad=None)

for _name, _fn in (("isinf", torch.isinf), ("isnan", torch.isnan)):
    register_op(
        _name,
        inputs=["X"],
        outputs=["Out"],
        lower=lambda ctx, ins, attrs, fn=_fn: fn(ins["X"][0]).any().reshape(
            1),
        grad=None,
    )


def _lower_cos_sim(ctx, ins, attrs):
    """cos_sim_op.cc: per-row cosine similarity over the flattened
    trailing dims; Y may hold one row, broadcast against every row of X.
    Out is [N, 1]."""
    x, y = ins["X"][0], ins["Y"][0]
    x = x.reshape(x.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    xn = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    dot = torch.sum(x * y, dim=1, keepdim=True)
    out = dot / torch.maximum(xn * yn, torch.tensor(1e-12, dtype=x.dtype,
                                                    device=x.device))
    return {"Out": out, "XNorm": xn, "YNorm": yn}


register_op(
    "cos_sim",
    inputs=["X", "Y"],
    outputs=["Out", "XNorm", "YNorm"],
    lower=_lower_cos_sim,
    intermediate_outputs=("XNorm", "YNorm"),
)

register_op(
    "minus",
    inputs=["X", "Y"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: ins["X"][0] - ins["Y"][0],
)

register_op(
    "l1_norm",
    inputs=["X"],
    outputs=["Out"],
    lower=lambda ctx, ins, attrs: torch.sum(jax_abs(ins["X"][0])).reshape(1),
)


def _lower_multiplex(ctx, ins, attrs):
    """multiplex_op.cc: Out[b] = X[Ids[b]][b]."""
    ids = ins["Ids"][0].reshape(-1).long()
    xs = torch.stack(ins["X"], dim=0)  # [K, B, ...]
    b = xs.shape[1]
    idx = ids.reshape((1, b) + (1,) * (xs.dim() - 2)).expand(
        (1,) + tuple(xs.shape[1:]))
    return torch.gather(xs, 0, idx).squeeze(0)


register_op(
    "multiplex",
    inputs=["Ids", "*X"],
    outputs=["Out"],
    lower=_lower_multiplex,
    no_grad_inputs=("Ids",),
)


def _lower_bilinear_tensor_product(ctx, ins, attrs):
    """Out[b, k] = X[b]^T W_k Y[b] (+ bias)."""
    out = torch.einsum("bm,kmn,bn->bk", ins["X"][0], ins["Weight"][0],
                       ins["Y"][0])
    if ins.get("Bias"):
        out = out + ins["Bias"][0].reshape(1, -1)
    return out


register_op(
    "bilinear_tensor_product",
    inputs=["X", "Y", "Weight", "Bias"],
    outputs=["Out"],
    lower=_lower_bilinear_tensor_product,
)


def _lower_conv_shift(ctx, ins, attrs):
    """conv_shift_op.cc: X [B, M], Y [B, N], N odd;
    Out[b, i] = sum_j X[b, (i + j - (N - 1) / 2) mod M] * Y[b, j]."""
    x, y = ins["X"][0], ins["Y"][0]
    m, n = x.shape[1], y.shape[1]
    half = (n - 1) // 2
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(n, device=x.device)[None, :] - half) % m
    return torch.einsum("bij,bj->bi", x[:, idx], y)


register_op(
    "conv_shift",
    inputs=["X", "Y"],
    outputs=["Out"],
    lower=_lower_conv_shift,
)
