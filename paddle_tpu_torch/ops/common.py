"""Shared lowering helpers for op definitions.

Counterpart of ``paddle_tpu/ops/common.py``, on torch tensors.
"""

import torch


def broadcast_y(x, y, axis):
    """Paddle elementwise broadcasting: align y's dims to x starting at
    ``axis`` (-1 = align trailing), then rely on torch broadcasting.
    Reference: paddle/fluid/operators/elementwise_op_function.h."""
    xnd, ynd = x.dim(), y.dim()
    if xnd > ynd:
        ax = axis if axis >= 0 else xnd - ynd
        shape = (1,) * ax + tuple(y.shape) + (1,) * (xnd - ax - ynd)
        return y.reshape(shape)
    return y  # same rank, or y has more dims: leading alignment


def normalize_axis(a, ndim, what="axis"):
    """Python-style negative wrapping only: an out-of-range axis raises
    instead of silently naming a different axis."""
    if not -ndim <= a < ndim:
        raise ValueError(
            "%s %d out of range for rank-%d input" % (what, a, ndim))
    return a % ndim


def reduce_axes(ndim, dim, reduce_all):
    if reduce_all or dim is None:
        return tuple(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return tuple(normalize_axis(d, ndim, "reduce dim") for d in dim)


def flatten_to_2d(x, num_col_dims):
    """Collapse leading num_col_dims dims into rows, rest into cols
    (mul_op's x_num_col_dims semantics)."""
    rows = 1
    for d in x.shape[:num_col_dims]:
        rows *= int(d)
    cols = 1
    for d in x.shape[num_col_dims:]:
        cols *= int(d)
    return x.reshape(rows, cols)


def scalar_like(value, x):
    """A Python scalar in ``x``'s kind: an int for integer tensors (the
    reference's ``jnp.asarray(value, x.dtype)`` truncates), a float
    otherwise, so torch keeps ``x``'s dtype."""
    if x.dtype.is_floating_point:
        return float(value)
    if x.dtype == torch.bool:
        return bool(value)
    return int(value)
