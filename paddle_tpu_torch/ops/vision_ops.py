"""Vision structural ops: channel affine, the spatial transformer
(affine_grid + grid_sampler), index-tracking max pooling, unpooling and
spatial pyramid pooling.

Counterpart of ``paddle_tpu/ops/vision_ops.py`` (the reference's
affine_channel, affine_grid, grid_sampler, pool_with_index, unpool and
spp ops), in torch ops whose gradients are the JAX package's:

* ``grid_sampler`` writes the bilinear weights ``(1 - |g - c|)`` out (not
  ``F.grid_sample``), with JAX's derivative of ``|u|``: +1 at u = 0 (torch's
  is 0), which the identity grid's integer coordinates reach;
* ``max_pool{2,3}d_with_index`` takes the max over stacked windows
  (``torch.amax`` splits the gradient among tied maxima, as ``jnp.max``
  does) and the first argmax for the mask;
* ``spp``'s max levels send each window's gradient to its first maximum
  in row-major order, the element XLA's ``reduce_window`` gradient picks;
* ``unpool`` sends the gradient of a duplicated index to its last write
  only, as the gradient of JAX's scatter does.
"""

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.op_registry import register_op


def _lower_affine_channel(ctx, ins, attrs):
    """Out = Scale_c * X + Bias_c, per channel."""
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(-1)
    bias = ins["Bias"][0].reshape(-1)
    if attrs.get("data_layout", "NCHW") == "NHWC":
        return x * scale + bias
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.reshape(shape) + bias.reshape(shape)


register_op(
    "affine_channel",
    inputs=["X", "Scale", "Bias"],
    outputs=["Out"],
    attrs={"data_layout": "NCHW"},
    lower=_lower_affine_channel,
)


def _affine_out_hw(ins, attrs):
    shape = attrs.get("output_shape") or []
    if len(shape) == 4:
        return int(shape[2]), int(shape[3])
    if ins.get("OutputShape"):
        raise ValueError(
            "affine_grid: OutputShape must be a host-known constant (static "
            "shapes); pass attr output_shape instead")
    raise ValueError("affine_grid: no output shape given")


def _linspace(n, dtype, device):
    """``jnp.linspace(-1, 1, n)`` value for value: -1 * (1 - t) + t with
    t = i / (n - 1), then the end point."""
    if n == 1:
        return torch.full((1,), -1.0, dtype=dtype, device=device)
    t = torch.arange(n - 1, dtype=dtype, device=device) / float(n - 1)
    out = -1.0 * (1 - t) + 1.0 * t
    return torch.cat([out, torch.ones(1, dtype=dtype, device=device)])


def _lower_affine_grid(ctx, ins, attrs):
    """theta [N,2,3] -> sampling grid [N,H,W,2] (align-corners: +-1 hits
    the corner pixel centres)."""
    theta = ins["Theta"][0]
    h, w = _affine_out_hw(ins, attrs)
    xs = _linspace(w, theta.dtype, theta.device)
    ys = _linspace(h, theta.dtype, theta.device)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")  # [H,W]
    base = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1)  # [H,W,3]
    return torch.einsum("hwc,nkc->nhwk", base, theta)


register_op(
    "affine_grid",
    inputs=["Theta", "OutputShape"],
    outputs=["Output"],
    attrs={"output_shape": [], "use_cudnn": False},
    lower=_lower_affine_grid,
    no_grad_inputs=("OutputShape",),
)


def _abs(u):
    """|u| whose derivative at 0 is +1, as JAX's ``abs`` has it."""
    return torch.where(u >= 0, u, -u)


def _lower_grid_sampler(ctx, ins, attrs):
    """Bilinear sampling of X [N,C,H,W] at grid [N,Hg,Wg,2] normalized
    coordinates; an out-of-bound corner contributes zero."""
    x = ins["X"][0]
    grid = ins["Grid"][0]
    n, c, h, w = x.shape
    hg, wg = grid.shape[1], grid.shape[2]
    gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0  # [N,Hg,Wg]
    gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    flat = x.reshape(n, c, h * w)
    out = None
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        cx = x0 + dx
        cy = y0 + dy
        wgt = (1.0 - _abs(gx - cx)) * (1.0 - _abs(gy - cy))
        inb = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
        ix = torch.clamp(cx, 0, w - 1).to(torch.int64)
        iy = torch.clamp(cy, 0, h - 1).to(torch.int64)
        idx = (iy * w + ix).reshape(n, 1, hg * wg).expand(n, c, hg * wg)
        vals = torch.gather(flat, 2, idx).reshape(n, c, hg, wg)
        term = vals * (wgt * inb.to(x.dtype))[:, None, :, :]
        out = term if out is None else out + term
    return out


register_op(
    "grid_sampler",
    inputs=["X", "Grid"],
    outputs=["Output"],
    attrs={"use_cudnn": False},
    lower=_lower_grid_sampler,
)


def _pool_with_index(x, ksize, strides, paddings, global_pooling, nd):
    """Windowed max and the flat argmax into the input map (the Mask)."""
    spatial = tuple(x.shape[2:])
    if global_pooling:
        ksize = list(spatial)
        paddings = [0] * nd
    xf = x.to(torch.float32)
    pad = []
    for p in reversed(paddings):
        pad += [p, p]
    xp = F.pad(xf, pad, value=-1e38)
    out_spatial = tuple(
        (spatial[d] + 2 * paddings[d] - ksize[d]) // strides[d] + 1
        for d in range(nd))
    slabs = []
    for offs in itertools.product(*[range(k) for k in ksize]):
        idx = (slice(None), slice(None)) + tuple(
            slice(offs[d], offs[d] + (out_spatial[d] - 1) * strides[d] + 1,
                  strides[d])
            for d in range(nd))
        slabs.append(xp[idx])
    patches = torch.stack(slabs, dim=2)  # [N, C, prod(k), *out_spatial]
    out = torch.amax(patches, dim=2)
    local = torch.argmax(patches, dim=2)  # first index on ties
    flat = torch.zeros_like(local)
    rem = local
    for d in range(nd):
        tail = int(np.prod(ksize[d + 1:])) if d + 1 < nd else 1
        off = rem // tail
        rem = rem % tail
        grid = (torch.arange(out_spatial[d], device=x.device) * strides[d]
                - paddings[d])
        shape = [1] * (2 + nd)
        shape[2 + d] = out_spatial[d]
        flat = flat * spatial[d] + (off + grid.reshape(shape))
    return out.to(x.dtype), flat.to(torch.int32)


def _pool_index_lowering(nd):
    def lower(ctx, ins, attrs):
        out, mask = _pool_with_index(
            ins["X"][0], list(attrs["ksize"]),
            list(attrs.get("strides", [1] * nd)),
            list(attrs.get("paddings", [0] * nd)),
            attrs.get("global_pooling", False), nd)
        return {"Out": out, "Mask": mask}

    return lower


for _nd in (2, 3):
    register_op(
        "max_pool%dd_with_index" % _nd,
        inputs=["X"],
        outputs=["Out", "Mask"],
        attrs={"ksize": [1] * _nd, "strides": [1] * _nd,
               "paddings": [0] * _nd, "global_pooling": False},
        lower=_pool_index_lowering(_nd),
        intermediate_outputs=("Mask",),
    )


def _lower_unpool(ctx, ins, attrs):
    """Scatter pooled values back to the positions max_pool2d_with_index
    recorded, into the output size the reference's rule gives (which can
    be smaller than the pooled map: an index past it is dropped, as JAX's
    scatter drops it). Duplicate indices (overlapping windows sharing an
    argmax) carry equal values; the last write takes the gradient, as
    JAX's scatter gives it (a scatter-add of the last writes only, so the
    card is deterministic too)."""
    x = ins["X"][0]
    idx = ins["Indices"][0]
    if attrs.get("unpooling_type", "max") != "max":
        raise ValueError("unpool: only max unpooling exists (reference "
                         "parity)")
    ksize = list(attrs["ksize"])
    strides = list(attrs.get("strides", [1, 1]))
    paddings = list(attrs.get("paddings", [0, 0]))
    n, c, h, w = x.shape
    oh = (h - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    ow = (w - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    flat_v = x.reshape(n * c, h * w)
    flat_i = idx.reshape(n * c, h * w).to(torch.int64)
    inside = (flat_i >= 0) & (flat_i < oh * ow)
    flat_i = torch.where(inside, flat_i, torch.zeros_like(flat_i))
    order = torch.arange(h * w, device=x.device).expand(n * c, h * w)
    last = torch.full((n * c, oh * ow), -1, dtype=torch.int64,
                      device=x.device).scatter_reduce(
        1, flat_i, torch.where(inside, order, -1), reduce="amax")
    won = (torch.gather(last, 1, flat_i) == order) & inside
    out = torch.zeros((n * c, oh * ow), dtype=x.dtype, device=x.device)
    out = out.scatter_add(1, flat_i, flat_v * won.to(x.dtype))
    return out.reshape(n, c, oh, ow)


register_op(
    "unpool",
    inputs=["X", "Indices"],
    outputs=["Out"],
    attrs={"unpooling_type": "max", "ksize": [1, 1], "strides": [1, 1],
           "paddings": [0, 0]},
    lower=_lower_unpool,
    no_grad_inputs=("Indices",),
)


def _windows(x, bins, kh, kw, ph, pw, value):
    """[N, C, bins, bins, kh * kw]: x padded (``value``) to bins windows
    of kh x kw a side, each window's elements in row-major order."""
    n, c, h, w = x.shape
    xp = F.pad(x, [pw, kw * bins - w - pw, ph, kh * bins - h - ph],
               value=value)
    return xp.reshape(n, c, bins, kh, bins, kw).permute(
        0, 1, 2, 4, 3, 5).reshape(n, c, bins, bins, kh * kw)


def _lower_spp(ctx, ins, attrs):
    """Spatial pyramid pooling: level l pools X into a 2^l x 2^l grid
    (kernel ceil(dim / bins), symmetric padding completing the last
    window); the levels flattened and concatenated -> [N, C * sum(4^l)].
    Average levels divide by the count of unpadded elements."""
    x = ins["X"][0]
    height = attrs["pyramid_height"]
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape
    xf = x.to(torch.float32)
    outs = []
    for lvl in range(height):
        bins = 2 ** lvl
        kh = int(np.ceil(h / float(bins)))
        kw = int(np.ceil(w / float(bins)))
        ph = (kh * bins - h + 1) // 2
        pw = (kw * bins - w + 1) // 2
        if ptype == "max":
            win = _windows(xf, bins, kh, kw, ph, pw, float("-inf"))
            first = torch.argmax(win, dim=-1, keepdim=True)
            pooled = torch.gather(win, -1, first)[..., 0]
        else:
            total = _windows(xf, bins, kh, kw, ph, pw, 0.0).sum(-1)
            count = _windows(torch.ones_like(xf), bins, kh, kw, ph, pw,
                             0.0).sum(-1)
            pooled = total / torch.clamp_min(count, 1.0)
        outs.append(pooled.reshape(n, c * bins * bins))
    return torch.cat(outs, dim=1).to(x.dtype)


register_op(
    "spp",
    inputs=["X"],
    outputs=["Out"],
    attrs={"pyramid_height": 1, "pooling_type": "max"},
    lower=_lower_spp,
)
