"""Neural-network ops: conv2d, pool2d and layer_norm.

Counterpart of ``paddle_tpu/ops/nn_ops.py`` for the ops this slice runs.
The JAX package computes conv2d and pool2d with XLA's convolution and
reduce-window, outside any Pallas kernel; here they are torch's
convolution (cuDNN on the card, TF32 off: ``Executor``) and pooling
calls. Pooling is written so that it computes what the JAX lowering
computes where torch's own options would differ: the padding is explicit
(``F.pad``, so a pad above half the window is allowed, as XLA allows
it), ``ceil_mode`` uses the reference's clamp on the last window, and
the average divides by the in-bounds count (``exclusive``) or by the
whole window, ``ceil_mode`` or not.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.op_registry import register_op


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


def _lower_conv2d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    # FLAGS_conv_nhwc (a TPU layout experiment in the JAX package, the
    # same numbers) is not read: the convolution runs on NCHW either way
    return F.conv2d(x, w,
                    stride=_pair(attrs.get("strides", [1, 1])),
                    padding=_pair(attrs.get("paddings", [0, 0])),
                    dilation=_pair(attrs.get("dilations", [1, 1])),
                    groups=attrs.get("groups", 1))


register_op(
    "conv2d",
    inputs=["Input", "Filter"],
    outputs=["Output"],
    attrs={
        "strides": [1, 1],
        "paddings": [0, 0],
        "dilations": [1, 1],
        "groups": 1,
        "use_cudnn": False,
        "data_format": "NCHW",
    },
    lower=_lower_conv2d,
)


def _pool_pads(x, ksize, strides, paddings, ceil_mode):
    """(low, high) padding per spatial dim (nn_ops.py:236-258): under
    ``ceil_mode`` the high side grows so the ceil-divided window count
    fits, with the reference's clamp (the last window starts inside input
    plus low padding, so no window lies wholly in the padding)."""
    pads = []
    for i, (k, s, p) in enumerate(zip(ksize, strides, paddings)):
        if not ceil_mode:
            pads.append((p, p))
            continue
        size = int(x.shape[2 + i])
        out_ceil = -(-(size + 2 * p - k) // s) + 1
        if (out_ceil - 1) * s >= size + p:
            out_ceil -= 1
        needed = (out_ceil - 1) * s + k - (size + 2 * p)
        pads.append((p, p + max(0, needed)))
    return pads


def _lower_pool2d(ctx, ins, attrs):
    x = ins["X"][0]
    is_max = attrs.get("pooling_type", "max") == "max"
    if attrs.get("global_pooling", False):
        # ksize is ignored: one window over the whole map
        return (x.amax(dim=(2, 3), keepdim=True) if is_max
                else x.mean(dim=(2, 3), keepdim=True))
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pool_pads(x, ksize, strides, _pair(attrs.get("paddings", [0, 0])),
                      attrs.get("ceil_mode", False))
    # F.pad takes the last dim first
    flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
    if is_max:
        return F.max_pool2d(F.pad(x, flat, value=-math.inf), ksize, strides)
    padded = F.pad(x, flat)
    if not attrs.get("exclusive", True):
        # the whole window's size, padding and ceil_mode's overhang
        # included
        return F.avg_pool2d(padded, ksize, strides)
    summed = F.avg_pool2d(padded, ksize, strides, divisor_override=1)
    ones = F.pad(x.new_ones((1, 1) + tuple(x.shape[2:])), flat)
    return summed / F.avg_pool2d(ones, ksize, strides, divisor_override=1)


register_op(
    "pool2d",
    inputs=["X"],
    outputs=["Out"],
    attrs={
        "pooling_type": "max",
        "ksize": [2, 2],
        "strides": [1, 1],
        "paddings": [0, 0],
        "global_pooling": False,
        "exclusive": True,
        "ceil_mode": False,
        "adaptive": False,
        "use_cudnn": False,
    },
    lower=_lower_pool2d,
)


def _lower_layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = float(attrs.get("epsilon", 1e-5))
    axes = tuple(range(begin, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    norm_shape = tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(norm_shape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(norm_shape)
    lead = tuple(x.shape[:begin])
    return {"Y": y, "Mean": mean.reshape(lead), "Variance": var.reshape(lead)}


register_op(
    "layer_norm",
    inputs=["X", "Scale", "Bias"],
    outputs=["Y", "Mean", "Variance"],
    attrs={"epsilon": 1e-5, "begin_norm_axis": 1},
    lower=_lower_layer_norm,
    intermediate_outputs=("Mean", "Variance"),
)
