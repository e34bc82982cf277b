"""Random ops: uniform_random, gaussian_random, truncated_gaussian_random,
dropout, sampling_id, random_crop and the two ``*_batch_size_like``
draws.

Counterpart of ``paddle_tpu/ops/random_ops.py``, drawing the same bits:
each op takes its key from ``LowerContext.rng()`` (jax's threefry
stream, ``core/prng.py``: ``fold_in(step_key, __rng_id__)``, or
``fold_in(PRNGKey(seed), __rng_id__)`` for a nonzero ``seed`` attr) and
samples as ``jax.random`` does. On the card each draw is one launch of
the threefry kernel (``kernels/threefry.py``). A ``dropout_grad`` op
reuses its forward's mask through the forward tape, or reruns the
forward under the same key. During build-time shape inference
(``rng()`` is None) an op returns uninitialized tensors of its shape.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype


def _out_dtype(attrs):
    return device_dtype(attrs.get("dtype"))


def _uniform(ctx, attrs, shape):
    key = ctx.rng()
    if key is None:
        return torch.empty(shape, dtype=_out_dtype(attrs), device=ctx.device)
    return prng.uniform(key, shape, attrs.get("min", -1.0),
                        attrs.get("max", 1.0),
                        device=ctx.device).to(_out_dtype(attrs))


def _gaussian(ctx, attrs, shape, truncated=False):
    key = ctx.rng()
    if key is None:
        return torch.empty(shape, dtype=_out_dtype(attrs), device=ctx.device)
    if truncated:
        n = prng.truncated_normal(key, -2.0, 2.0, shape, device=ctx.device)
    else:
        n = prng.normal(key, shape, device=ctx.device)
    # mean + std * n, one multiply-add as XLA contracts it
    return prng.fma32(n, attrs.get("std", 1.0),
                      attrs.get("mean", 0.0)).to(_out_dtype(attrs))


def _shape(attrs):
    return tuple(int(d) for d in attrs["shape"])


register_op(
    "uniform_random",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [], "min": -1.0, "max": 1.0, "seed": 0,
           "dtype": "float32"},
    lower=lambda ctx, ins, attrs: _uniform(ctx, attrs, _shape(attrs)),
    grad=None,
)

register_op(
    "gaussian_random",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
           "dtype": "float32"},
    lower=lambda ctx, ins, attrs: _gaussian(ctx, attrs, _shape(attrs)),
    grad=None,
)

register_op(
    "truncated_gaussian_random",
    inputs=[],
    outputs=["Out"],
    attrs={"shape": [], "mean": 0.0, "std": 1.0, "seed": 0,
           "dtype": "float32"},
    lower=lambda ctx, ins, attrs: _gaussian(ctx, attrs, _shape(attrs),
                                            truncated=True),
    grad=None,
)


def _lower_dropout(ctx, ins, attrs):
    """Downgrade-in-infer by default (train: ``x * mask``; test:
    ``x * (1 - p)``); ``upscale_in_train`` scales the kept entries by
    ``1 / (1 - p)`` in training and passes ``x`` through in test. The
    keep mask is ``jax.random.bernoulli(key, 1 - p, x.shape)``:
    ``uniform < float32(1 - p)``."""
    x = ins["X"][0]
    p = float(attrs.get("dropout_prob", 0.5))
    upscale = attrs.get("dropout_implementation",
                        "downgrade_in_infer") == "upscale_in_train"
    if ctx.is_test:
        return {"Out": x if upscale else x * (1.0 - p),
                "Mask": torch.ones_like(x)}
    key = ctx.rng()
    if key is None:
        mask = torch.empty_like(x)
    elif x.dtype == torch.float32:
        mask = prng.bernoulli(key, 1.0 - p, tuple(x.shape),
                              dtype=torch.float32, device=x.device)
    else:
        mask = prng.bernoulli(key, 1.0 - p, tuple(x.shape),
                              device=x.device).to(x.dtype)
    if not upscale:
        out = x * mask
    elif p >= 1.0:
        out = torch.zeros_like(x)
    else:
        # XLA divides by the constant float32(1 - p) as a product with
        # its float32 reciprocal
        out = x * mask * float(np.float32(1.0) / np.float32(1.0 - p))
    return {"Out": out, "Mask": mask}


register_op(
    "dropout",
    inputs=["X"],
    outputs=["Out", "Mask"],
    attrs={"dropout_prob": 0.5, "is_test": False, "seed": 0,
           "fix_seed": False,
           "dropout_implementation": "downgrade_in_infer"},
    lower=_lower_dropout,
    intermediate_outputs=("Mask",),
)


def _lower_sampling_id(ctx, ins, attrs):
    x = ins["X"][0]
    key = ctx.rng()
    if key is None:
        return torch.empty(x.shape[:-1], dtype=torch.int64, device=x.device)
    logits = torch.log(torch.clamp(x.to(torch.float32), min=1e-20))
    return prng.categorical(key, logits, axis=-1).to(torch.int64)


register_op(
    "sampling_id",
    inputs=["X"],
    outputs=["Out"],
    attrs={"min": 0.0, "max": 1.0, "seed": 0},
    lower=_lower_sampling_id,
    grad=None,
)


def _random_crop(ctx, x, crop_shape):
    """The JAX package's crop: per cropped dim, ``key, sub =
    split(key)`` and a start ``randint(sub, (), 0, limit)``; the slice
    gathers on the device (no host read, so it captures)."""
    crop_shape = [int(c) for c in crop_shape]
    nbatch = x.dim() - len(crop_shape)
    key = ctx.rng()
    if key is None:
        return torch.empty(tuple(x.shape[:nbatch]) + tuple(crop_shape),
                           dtype=x.dtype, device=x.device)
    key = prng.as_chain(key)
    out = x
    for i, c in enumerate(crop_shape):
        limit = x.shape[nbatch + i] - c + 1
        key, sub = key.fold_in(0), key.fold_in(1)
        start = prng.randint(sub, (), 0, limit, device=x.device)
        idx = start.reshape(1) + torch.arange(c, device=x.device)
        out = out.index_select(nbatch + i, idx)
    return out


register_op(
    "random_crop",
    inputs=["X", "Seed"],
    outputs=["Out", "SeedOut"],
    attrs={"shape": [], "seed": 0},
    lower=lambda ctx, ins, attrs: {
        "Out": _random_crop(ctx, ins["X"][0], attrs["shape"]),
        "SeedOut": ins["Seed"][0],
    },
    grad=None,
)


def _batch_size_like_shape(ins, attrs):
    shape = [int(d) for d in attrs["shape"]]
    x = ins["Input"][0]
    shape[int(attrs.get("output_dim_idx", 0))] = int(
        x.shape[int(attrs.get("input_dim_idx", 0))])
    return tuple(shape)


register_op(
    "gaussian_random_batch_size_like",
    inputs=["Input"],
    outputs=["Out"],
    attrs={"shape": [], "input_dim_idx": 0, "output_dim_idx": 0,
           "mean": 0.0, "std": 1.0, "seed": 0, "dtype": "float32"},
    lower=lambda ctx, ins, attrs: _gaussian(
        ctx, attrs, _batch_size_like_shape(ins, attrs)),
    grad=None,
)

register_op(
    "uniform_random_batch_size_like",
    inputs=["Input"],
    outputs=["Out"],
    attrs={"shape": [], "input_dim_idx": 0, "output_dim_idx": 0,
           "min": -1.0, "max": 1.0, "seed": 0, "dtype": "float32"},
    lower=lambda ctx, ins, attrs: _uniform(
        ctx, attrs, _batch_size_like_shape(ins, attrs)),
    grad=None,
)
