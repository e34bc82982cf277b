"""Neural-network ops: the convolutions (2-D, 3-D, depthwise and
transposed), pooling (2-D and 3-D), batch, layer and group norm, lrn,
im2sequence and the bilinear and nearest resizes.

Counterpart of ``paddle_tpu/ops/nn_ops.py``. The JAX package computes
the convolutions and pooling with XLA's convolution and reduce-window,
outside any Pallas kernel; here they are torch's convolution (cuDNN on
the card, TF32 off: ``Executor``) and pooling calls. Pooling is written so that it computes what the JAX lowering
computes where torch's own options would differ: the padding is explicit
(``F.pad``, so a pad above half the window is allowed, as XLA allows
it), ``ceil_mode`` uses the reference's clamp on the last window, and
the average divides by the in-bounds count (``exclusive``) or by the
whole window, ``ceil_mode`` or not.
"""

import math

import numpy as np
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


def _lower_batch_norm(ctx, ins, attrs):
    """nn_ops.py:373-430: the batch statistics in fp32 (fp64 stays), the
    variance as ``E[x^2] - mean^2``, as the JAX package computes it (not
    torch's two-pass variance); the moving statistics come out as new
    tensors, which the executor writes back through the scope. Under AMP
    (bf16 ``X``, float32 scale, bias and statistics) the dtypes follow the
    reference step by step: ``rsqrt`` of the bf16 variance plus a bf16
    epsilon, the float32 promotion through scale and bias, ``Y`` cast back
    to bf16."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    ch_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    reduce_ax = tuple(i for i in range(x.dim()) if i != ch_axis)
    bshape = tuple(x.shape[ch_axis] if i == ch_axis else 1
                   for i in range(x.dim()))
    if ctx.is_test or attrs.get("use_global_stats", False):
        mean, var = mean_in, var_in
        saved_mean, saved_var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        xc = x if x.dtype == torch.float64 else x.float()
        mean = xc.mean(dim=reduce_ax)
        var = torch.square(xc).mean(dim=reduce_ax) - torch.square(mean)
        mean_out = mean_in * momentum + mean.to(mean_in.dtype) * (
            1 - momentum)
        var_out = var_in * momentum + var.to(var_in.dtype) * (1 - momentum)
        saved_mean, saved_var = mean, var
    # the epsilon in x's dtype (jnp.asarray(eps, x.dtype)): bf16 under AMP
    eps = torch.tensor(eps, dtype=x.dtype).item()
    inv_std = torch.rsqrt(var.to(x.dtype) + eps)
    y = (x - mean.to(x.dtype).reshape(bshape)) * (inv_std * scale).reshape(
        bshape) + bias.reshape(bshape)
    return {"Y": y.to(x.dtype), "MeanOut": mean_out,
            "VarianceOut": var_out, "SavedMean": saved_mean,
            "SavedVariance": saved_var}


register_op(
    "batch_norm",
    inputs=["X", "Scale", "Bias", "Mean", "Variance"],
    outputs=["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"],
    attrs={"epsilon": 1e-5, "momentum": 0.9, "is_test": False,
           "data_layout": "NCHW", "use_global_stats": False},
    lower=_lower_batch_norm,
    no_grad_inputs=("Mean", "Variance"),
    intermediate_outputs=("MeanOut", "VarianceOut", "SavedMean",
                          "SavedVariance"),
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


def _lower_lrn(ctx, ins, attrs):
    """lrn_op.cc as the JAX package lowers it: ``alpha`` multiplies the
    window's sum of squares undivided by ``n`` (not torch's
    LocalResponseNorm), and the window of channel c is
    ``[c - (n-1)//2, c + n - 1 - (n-1)//2]``: for an even ``n`` one more
    channel above than below."""
    x = ins["X"][0]
    n = attrs.get("n", 5)
    lo = (n - 1) // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, lo, n - 1 - lo))
    c = int(x.shape[1])
    acc = 0
    for i in range(n):
        acc = acc + pad[:, i:i + c]
    mid = attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * acc
    return {"Out": x / torch.pow(mid, attrs.get("beta", 0.75)),
            "MidOut": mid}


register_op(
    "lrn",
    inputs=["X"],
    outputs=["Out", "MidOut"],
    attrs={"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75},
    lower=_lower_lrn,
    intermediate_outputs=("MidOut",),
)


def _conv_attrs(attrs, nd):
    return dict(stride=_pair(attrs.get("strides", [1] * nd), nd),
                padding=_pair(attrs.get("paddings", [0] * nd), nd),
                dilation=_pair(attrs.get("dilations", [1] * nd), nd))


def _lower_depthwise_conv2d(ctx, ins, attrs):
    """groups = the input's channels; filter ``[C * mult, 1, kh, kw]``."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return F.conv2d(x, w, groups=int(x.shape[1]), **_conv_attrs(attrs, 2))


register_op(
    "depthwise_conv2d",
    inputs=["Input", "Filter"],
    outputs=["Output"],
    attrs={"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
           "groups": 1, "data_format": "NCHW"},
    lower=_lower_depthwise_conv2d,
)


def _lower_conv3d(ctx, ins, attrs):
    return F.conv3d(ins["Input"][0], ins["Filter"][0],
                    groups=attrs.get("groups", 1), **_conv_attrs(attrs, 3))


register_op(
    "conv3d",
    inputs=["Input", "Filter"],
    outputs=["Output"],
    attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
           "dilations": [1, 1, 1], "groups": 1},
    lower=_lower_conv3d,
)


def _output_padding(output_size, x, w, attrs, nd):
    """conv_transpose_op.cc: ``output_size`` picks one of the
    stride-ambiguous output sizes; its surplus over the smallest, which
    must lie in [0, stride), is the extra high-side size
    (``nn_ops.py:200-218``)."""
    if not output_size:
        return [0] * nd
    a = _conv_attrs(attrs, nd)
    extras = []
    for d in range(nd):
        keff = (int(w.shape[2 + d]) - 1) * a["dilation"][d] + 1
        base = (int(x.shape[2 + d]) - 1) * a["stride"][d] \
            - 2 * a["padding"][d] + keff
        surplus = int(output_size[d]) - base
        if not 0 <= surplus < a["stride"][d]:
            raise ValueError(
                "conv_transpose: output_size %d for dim %d not reachable "
                "(base %d, stride %d)" % (output_size[d], d, base,
                                          a["stride"][d]))
        extras.append(surplus)
    return extras


def _conv_transpose(ins, attrs, nd, groups=None):
    """The transposed convolution (the gradient of a convolution), with
    Paddle's filter ``[in_c, out_c / groups, *k]``, which is torch's own
    layout for it."""
    x, w = ins["Input"][0], ins["Filter"][0]
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    return fn(x, w, groups=groups or attrs.get("groups", 1),
              output_padding=_output_padding(attrs.get("output_size"), x, w,
                                             attrs, nd),
              **_conv_attrs(attrs, nd))


register_op(
    "conv2d_transpose",
    inputs=["Input", "Filter"],
    outputs=["Output"],
    attrs={"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
           "groups": 1, "output_size": []},
    lower=lambda ctx, ins, attrs: _conv_transpose(ins, attrs, 2),
)

register_op(
    "depthwise_conv2d_transpose",
    inputs=["Input", "Filter"],
    outputs=["Output"],
    attrs={"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
           "groups": 1, "output_size": None, "data_format": "NCHW"},
    lower=lambda ctx, ins, attrs: _conv_transpose(
        ins, attrs, 2, groups=int(ins["Input"][0].shape[1])),
)

register_op(
    "conv3d_transpose",
    inputs=["Input", "Filter"],
    outputs=["Output"],
    attrs={"strides": [1, 1, 1], "paddings": [0, 0, 0],
           "dilations": [1, 1, 1], "groups": 1, "output_size": []},
    lower=lambda ctx, ins, attrs: _conv_transpose(ins, attrs, 3),
)


def _lower_pool3d(ctx, ins, attrs):
    """NCDHW pooling, pool2d's rules over three spatial dims."""
    x = ins["X"][0]
    is_max = attrs.get("pooling_type", "max") == "max"
    if attrs.get("global_pooling", False):
        return (x.amax(dim=(2, 3, 4), keepdim=True) if is_max
                else x.mean(dim=(2, 3, 4), keepdim=True))
    ksize = _pair(attrs.get("ksize", [2, 2, 2]), 3)
    strides = _pair(attrs.get("strides", [1, 1, 1]), 3)
    pads = _pool_pads(x, ksize, strides,
                      _pair(attrs.get("paddings", [0, 0, 0]), 3),
                      attrs.get("ceil_mode", False))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if is_max:
        return F.max_pool3d(F.pad(x, flat, value=-math.inf), ksize, strides)
    summed = F.avg_pool3d(F.pad(x, flat), ksize, strides, divisor_override=1)
    if not attrs.get("exclusive", True):
        return summed / float(np.prod(ksize))
    ones = F.pad(x.new_ones((1, 1) + tuple(x.shape[2:])), flat)
    return summed / F.avg_pool3d(ones, ksize, strides, divisor_override=1)


register_op(
    "pool3d",
    inputs=["X"],
    outputs=["Out"],
    attrs={"pooling_type": "max", "ksize": [2, 2, 2], "strides": [1, 1, 1],
           "paddings": [0, 0, 0], "global_pooling": False,
           "exclusive": True, "ceil_mode": False, "adaptive": False,
           "use_cudnn": False},
    lower=_lower_pool3d,
)


def _lower_group_norm(ctx, ins, attrs):
    x = ins["X"][0]
    groups = attrs.get("groups", 1)
    eps = float(attrs.get("epsilon", 1e-5))
    n, c = int(x.shape[0]), int(x.shape[1])
    rest = tuple(x.shape[2:])
    xg = x.reshape((n, groups, c // groups) + rest)
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = torch.square(xg - mean).mean(dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * len(rest)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": y, "Mean": mean.reshape(n, groups),
            "Variance": var.reshape(n, groups)}


register_op(
    "group_norm",
    inputs=["X", "Scale", "Bias"],
    outputs=["Y", "Mean", "Variance"],
    attrs={"epsilon": 1e-5, "groups": 1},
    lower=_lower_group_norm,
    intermediate_outputs=("Mean", "Variance"),
)


def _lower_im2sequence(ctx, ins, attrs):
    """Each ``[kh, kw]`` patch a row: ``[N * oh * ow, C * kh * kw]``, the
    features channel-major, the order of
    ``conv_general_dilated_patches`` and of ``F.unfold``."""
    x = ins["X"][0]
    kernels = list(attrs.get("kernels", [1, 1]))
    pads = list(attrs.get("paddings", [0, 0, 0, 0]))  # up, left, down, right
    xp = F.pad(x, [pads[1], pads[3], pads[0], pads[2]])
    cols = F.unfold(xp, kernels, stride=list(attrs.get("strides", [1, 1])))
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


register_op(
    "im2sequence",
    inputs=["X"],
    outputs=["Out"],
    attrs={"kernels": [1, 1], "strides": [1, 1], "paddings": [0, 0, 0, 0]},
    lower=_lower_im2sequence,
)


def _resize_weights(n_in, n_out, device):
    """``jax.image.resize``'s linear weights ``[n_out, n_in]``
    (``compute_weight_mat``, triangle kernel, antialiased when shrinking):
    half-pixel sample points ``(o + 0.5) * n_in / n_out - 0.5``, the
    kernel widened by ``n_in / n_out`` when that exceeds 1, each row
    normalised, rows whose sample lies outside the input zero."""
    inv = 1.0 / (n_out / n_in)
    kscale = max(inv, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv - 0.5)
    dist = (sample[:, None] - torch.arange(n_in, dtype=torch.float32,
                                           device=device)[None, :]).abs() \
        / kscale
    w = torch.clamp_min(1.0 - dist.abs(), 0.0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def _interp(x, out_h, out_w, method):
    """bilinear_interp / nearest_interp as ``jax.image.resize`` computes
    them over NCHW (``nn_ops.py:562-583``): half-pixel centres, not
    ``align_corners``; a dim of unchanged size is left as it is."""
    h, w = int(x.shape[2]), int(x.shape[3])
    if method == "nearest":
        for dim, n_in, n_out in ((2, h, out_h), (3, w, out_w)):
            if n_in == n_out:
                continue
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * float(n_in) / float(n_out)).to(torch.int64)
            x = x.index_select(dim, idx)
        return x
    if h != out_h:
        x = torch.einsum("nchw,oh->ncow", x,
                         _resize_weights(h, out_h, x.device).to(x.dtype))
    if w != out_w:
        x = torch.einsum("nchw,ow->ncho", x,
                         _resize_weights(w, out_w, x.device).to(x.dtype))
    return x


for _interp_type, _method in (("bilinear_interp", "bilinear"),
                              ("nearest_interp", "nearest")):
    register_op(
        _interp_type,
        inputs=["X", "OutSize"],
        outputs=["Out"],
        attrs={"out_h": -1, "out_w": -1, "interp_method": _method},
        lower=lambda ctx, ins, attrs, m=_method: _interp(
            ins["X"][0], attrs["out_h"], attrs["out_w"], m),
        no_grad_inputs=("OutSize",),
    )
