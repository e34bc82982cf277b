"""Detection ops (SSD and Faster R-CNN machinery): prior_box,
density_prior_box, anchor_generator, iou_similarity, box_coder,
polygon_box_transform, bipartite_match, target_assign,
mine_hard_examples, multiclass_nms, detection_map, roi_pool, roi_align,
roi_perspective_transform, rpn_target_assign, generate_proposals and
generate_proposal_labels.

Counterpart of ``paddle_tpu/ops/detection_ops.py``: the same op types,
attrs and defaults, the same dense formulation (ground truth a padded
batch ``[N, G, ...]`` whose padded rows are zero boxes; index lists as
masks; fixed-capacity outputs padded with label -1 and a count), and the
same dtypes (``int32`` match indices and counts). Every op runs as
launches alone: no ``.item()``, no boolean-mask indexing, no data-shaped
output, so nothing syncs the host with the card.

- The generators (``prior_box``, ``density_prior_box``,
  ``anchor_generator``) are functions of shapes and attrs: computed once
  on the host with the JAX package's float64 loops and kept, per
  device, for every later run.
- The sorts are stable (``torch.sort(..., stable=True)``), as
  ``jnp.argsort``: zero-padded borders give many priors equal scores.
- The greedy NMS of ``multiclass_nms`` and ``generate_proposals`` and
  ``detection_map``'s greedy match are the port's own kernels
  (``kernels/detection.py``: ``greedy_nms`` and ``det_match``); the
  sorts before them and the cumulative sums and AP after them are torch
  ops. ``bipartite_match`` is min(G, P) iterations of torch ops, each an
  argmax over ``[N, G * P]``.
- ``rpn_target_assign`` and ``generate_proposal_labels`` draw from the
  op's threefry key as the JAX package does (``split(key, N)``, then per
  image ``split`` and ``uniform``; ``core/prng.py``), so they sample the
  same anchors and RoIs bit for bit.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import prng
from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.kernels import detection as kdet

_iou = kdet.iou
_INF = float("inf")


def _argsort_desc(x, dim=-1):
    """``jnp.argsort(-x)``: stable, descending."""
    return torch.sort(-x, dim=dim, stable=True).indices


def _recip(c):
    """XLA divides by a constant as a product with its float32
    reciprocal: ``x / c`` in the JAX package is ``x * _recip(c)``."""
    return float(np.float32(1) / np.float32(c))


def _drop(x, index, dim):
    """``x`` without entry ``index`` of ``dim`` (slices: no index tensor
    to copy to the card)."""
    if not 0 <= index < x.shape[dim]:
        return x
    return torch.cat([x.narrow(dim, 0, index),
                      x.narrow(dim, index + 1, x.shape[dim] - index - 1)],
                     dim=dim)


def _gather_rows(x, idx):
    """``x[n, idx[n, ...]]`` for ``x`` ``[N, P, ...]`` and ``idx``
    ``[N, K]``: ``[N, K, ...]``."""
    ar = torch.arange(x.shape[0], device=x.device).view(
        (-1,) + (1,) * (idx.dim() - 1))
    return x[ar, idx]


# ---------------------------------------------------------------------------
# Generators: functions of shapes and attrs, kept per device
# ---------------------------------------------------------------------------

_CONSTS = {}


def _const(key, device, make):
    """The generator output ``make()`` (numpy arrays) for ``key``, as
    tensors on ``device``: made once a process, copied to a device once.
    A meta device gets fresh tensors of the shapes."""
    arrs = _CONSTS.get(key)
    if arrs is None:
        arrs = _CONSTS[key] = tuple(make())
    if device.type == "meta":
        return tuple(torch.empty(a.shape, dtype=torch.float32,
                                 device=device) for a in arrs)
    dkey = (key, str(device))
    hit = _CONSTS.get(dkey)
    if hit is None:
        hit = _CONSTS[dkey] = tuple(torch.from_numpy(a).to(device)
                                    for a in arrs)
    return hit


def _attr_key(attrs, names):
    return tuple((n, repr(attrs.get(n))) for n in names)


def _prior_box_arrays(fh, fw, ih, iw, attrs):
    min_sizes = attrs["min_sizes"]
    max_sizes = attrs.get("max_sizes", [])
    aspect_ratios = list(attrs.get("aspect_ratios", [1.0]))
    flip = attrs.get("flip", False)
    clip = attrs.get("clip", False)
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    offset = attrs.get("offset", 0.5)
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh

    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - a) > 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)

    boxes = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            for k, ms in enumerate(min_sizes):
                for ar in ars:
                    bw = ms * np.sqrt(ar) / 2.0
                    bh = ms / np.sqrt(ar) / 2.0
                    boxes.append([(cx - bw) / iw, (cy - bh) / ih,
                                  (cx + bw) / iw, (cy + bh) / ih])
                if k < len(max_sizes):
                    s = np.sqrt(ms * max_sizes[k]) / 2.0
                    boxes.append([(cx - s) / iw, (cy - s) / ih,
                                  (cx + s) / iw, (cy + s) / ih])
    arr = np.asarray(boxes, np.float32)
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    num_priors = arr.shape[0] // (fh * fw)
    out = arr.reshape(fh, fw, num_priors, 4)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          out.shape).copy()
    return out, var


_PRIOR_ATTRS = ("min_sizes", "max_sizes", "aspect_ratios", "variances",
                "flip", "clip", "step_w", "step_h", "offset")


def _lower_prior_box(ctx, ins, attrs):
    feat, image = ins["Input"][0], ins["Image"][0]
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    boxes, var = _const(
        ("prior_box", fh, fw, ih, iw, _attr_key(attrs, _PRIOR_ATTRS)),
        feat.device, lambda: _prior_box_arrays(fh, fw, ih, iw, attrs))
    return {"Boxes": boxes, "Variances": var}


register_op(
    "prior_box",
    inputs=["Input", "Image"],
    outputs=["Boxes", "Variances"],
    attrs={
        "min_sizes": [],
        "max_sizes": [],
        "aspect_ratios": [1.0],
        "variances": [0.1, 0.1, 0.2, 0.2],
        "flip": False,
        "clip": False,
        "step_w": 0.0,
        "step_h": 0.0,
        "offset": 0.5,
    },
    lower=_lower_prior_box,
    grad=None,
)


def _anchor_arrays(fh, fw, attrs):
    sizes = attrs["anchor_sizes"]
    ratios = attrs.get("aspect_ratios", [1.0])
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    stride = attrs.get("stride", [16.0, 16.0])
    offset = attrs.get("offset", 0.5)
    sw, sh = float(stride[0]), float(stride[1])

    anchors = []
    for h in range(fh):
        row = []
        for w in range(fw):
            x_ctr = w * sw + offset * (sw - 1)
            y_ctr = h * sh + offset * (sh - 1)
            cell = []
            for ar in ratios:
                area = sw * sh
                base_w = round(np.sqrt(area / ar))
                base_h = round(base_w * ar)
                for s in sizes:
                    aw = (s / sw) * base_w
                    ah = (s / sh) * base_h
                    cell.append([x_ctr - 0.5 * (aw - 1),
                                 y_ctr - 0.5 * (ah - 1),
                                 x_ctr + 0.5 * (aw - 1),
                                 y_ctr + 0.5 * (ah - 1)])
            row.append(cell)
        anchors.append(row)
    arr = np.asarray(anchors, np.float32)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          arr.shape).copy()
    return arr, var


def _lower_anchor_generator(ctx, ins, attrs):
    feat = ins["Input"][0]
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    anchors, var = _const(
        ("anchor_generator", fh, fw, _attr_key(attrs, (
            "anchor_sizes", "aspect_ratios", "variances", "stride",
            "offset"))),
        feat.device, lambda: _anchor_arrays(fh, fw, attrs))
    return {"Anchors": anchors, "Variances": var}


register_op(
    "anchor_generator",
    inputs=["Input"],
    outputs=["Anchors", "Variances"],
    attrs={
        "anchor_sizes": [64.0, 128.0, 256.0, 512.0],
        "aspect_ratios": [0.5, 1.0, 2.0],
        "variances": [0.1, 0.1, 0.2, 0.2],
        "stride": [16.0, 16.0],
        "offset": 0.5,
    },
    lower=_lower_anchor_generator,
    grad=None,
)


def _density_arrays(fh, fw, ih, iw, attrs):
    densities = attrs.get("densities", [])
    fixed_sizes = attrs.get("fixed_sizes", [])
    fixed_ratios = attrs.get("fixed_ratios", [1.0])
    variances = attrs.get("variances", [0.1, 0.1, 0.2, 0.2])
    clip = attrs.get("clip", False)
    offset = attrs.get("offset", 0.5)
    step_w = attrs.get("step_w", 0.0) or iw / fw
    step_h = attrs.get("step_h", 0.0) or ih / fh

    boxes = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            for size, density in zip(fixed_sizes, densities):
                for ar in fixed_ratios:
                    bw = size * np.sqrt(ar)
                    bh = size / np.sqrt(ar)
                    shift_w = step_w / density
                    shift_h = step_h / density
                    for di in range(density):
                        for dj in range(density):
                            ccx = (cx - step_w / 2.0 + shift_w / 2.0
                                   + dj * shift_w)
                            ccy = (cy - step_h / 2.0 + shift_h / 2.0
                                   + di * shift_h)
                            boxes.append([(ccx - bw / 2.0) / iw,
                                          (ccy - bh / 2.0) / ih,
                                          (ccx + bw / 2.0) / iw,
                                          (ccy + bh / 2.0) / ih])
    arr = np.asarray(boxes, np.float32)
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    num_priors = arr.shape[0] // (fh * fw)
    out = arr.reshape(fh, fw, num_priors, 4)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          out.shape).copy()
    return out, var


def _lower_density_prior_box(ctx, ins, attrs):
    feat, image = ins["Input"][0], ins["Image"][0]
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    ih, iw = int(image.shape[2]), int(image.shape[3])
    boxes, var = _const(
        ("density_prior_box", fh, fw, ih, iw, _attr_key(attrs, (
            "densities", "fixed_sizes", "fixed_ratios", "variances", "clip",
            "step_w", "step_h", "offset"))),
        feat.device, lambda: _density_arrays(fh, fw, ih, iw, attrs))
    return {"Boxes": boxes, "Variances": var}


register_op(
    "density_prior_box",
    inputs=["Input", "Image"],
    outputs=["Boxes", "Variances"],
    attrs={
        "densities": [],
        "fixed_sizes": [],
        "fixed_ratios": [1.0],
        "variances": [0.1, 0.1, 0.2, 0.2],
        "clip": False,
        "step_w": 0.0,
        "step_h": 0.0,
        "offset": 0.5,
        "flatten_to_2d": False,
    },
    lower=_lower_density_prior_box,
    grad=None,
)


# ---------------------------------------------------------------------------
# IoU, box coding
# ---------------------------------------------------------------------------


def _lower_iou_similarity(ctx, ins, attrs):
    # [N, G, 4] against a shared [P, 4] broadcasts to [N, G, P]
    return _iou(ins["X"][0], ins["Y"][0])


register_op(
    "iou_similarity",
    inputs=["X", "Y"],
    outputs=["Out"],
    lower=_lower_iou_similarity,
    grad=None,
)


def _lower_box_coder(ctx, ins, attrs):
    prior = ins["PriorBox"][0]  # [M, 4]
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") else None
    target = ins["TargetBox"][0]
    code_type = attrs.get("code_type", "encode_center_size")
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    if pvar is None:
        pvar = torch.ones((prior.shape[0], 4), dtype=prior.dtype,
                          device=prior.device)
    if code_type.startswith("encode"):
        # t [..., T, 4] -> [..., T, P, 4] (a padded gt batch [N, G, 4]
        # gives [N, G, P, 4])
        t = target
        tw = t[..., 2] - t[..., 0]
        th = t[..., 3] - t[..., 1]
        tcx = t[..., 0] + tw / 2
        tcy = t[..., 1] + th / 2
        return torch.stack([
            (tcx[..., None] - pcx) / pw / pvar[:, 0],
            (tcy[..., None] - pcy) / ph / pvar[:, 1],
            torch.log(torch.clamp_min(tw[..., None] / pw, 1e-10))
            / pvar[:, 2],
            torch.log(torch.clamp_min(th[..., None] / ph, 1e-10))
            / pvar[:, 3],
        ], dim=-1)
    # decode: target [N, M, 4]
    t = target
    dcx = pvar[:, 0] * t[..., 0] * pw + pcx
    dcy = pvar[:, 1] * t[..., 1] * ph + pcy
    dw = torch.exp(pvar[:, 2] * t[..., 2]) * pw
    dh = torch.exp(pvar[:, 3] * t[..., 3]) * ph
    return torch.stack([dcx - dw / 2, dcy - dh / 2, dcx + dw / 2,
                        dcy + dh / 2], dim=-1)


register_op(
    "box_coder",
    inputs=["PriorBox", "PriorBoxVar", "TargetBox"],
    outputs=["OutputBox"],
    attrs={"code_type": "encode_center_size", "box_normalized": True},
    lower=_lower_box_coder,
    grad=None,
)


def _lower_polygon_box_transform(ctx, ins, attrs):
    x = ins["Input"][0]  # [N, C, H, W], C = 2 * coords (x, y interleaved)
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    jj = torch.arange(w, dtype=x.dtype, device=x.device)
    ii = torch.arange(h, dtype=x.dtype, device=x.device)
    even = jj[None, :] * 4.0 - x  # x-channels: id_w * 4 - in
    odd = ii[:, None] * 4.0 - x  # y-channels: id_h * 4 - in
    is_even = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None,
                                                          None]
    return torch.where(is_even, even, odd)


register_op(
    "polygon_box_transform",
    inputs=["Input"],
    outputs=["Output"],
    lower=_lower_polygon_box_transform,
    grad=None,
)


# ---------------------------------------------------------------------------
# Matching, target assignment, hard-example mining
# ---------------------------------------------------------------------------


def _bipartite_match(dist, match_type, overlap_threshold):
    """The greedy bipartite match of every image at once: dist ``[N, G,
    P]`` -> (match_idx ``[N, P]`` int32, match_dist ``[N, P]``). Rows
    whose largest distance is <= 0 (zero-padded gt) never match;
    min(G, P) times the global argmax binds its (row, col) and retires
    both."""
    n, g, p = dist.shape
    dev = dist.device
    row_valid = torch.amax(dist, dim=2) > 0
    d = torch.where(row_valid[:, :, None], dist, -1.0)
    midx = torch.full((n, p), -1, dtype=torch.int32, device=dev)
    mdist = torch.zeros((n, p), dtype=dist.dtype, device=dev)
    rows = torch.arange(g, device=dev)[None, :, None]
    cols = torch.arange(p, device=dev)[None, None, :]
    cols1 = cols[:, 0]
    ar = torch.arange(n, device=dev)
    work = d
    for _ in range(min(g, p)):
        flat = work.reshape(n, g * p)
        k = torch.argmax(flat, dim=1)
        v = flat[ar, k]
        r, c = k // p, k % p
        take = v > 0
        at_c = take[:, None] & (cols1 == c[:, None])
        midx = torch.where(at_c, r.to(torch.int32)[:, None], midx)
        mdist = torch.where(at_c, v[:, None], mdist)
        hit = take[:, None, None] & ((rows == r[:, None, None])
                                     | (cols == c[:, None, None]))
        work = torch.where(hit, -1.0, work)
    if match_type == "per_prediction":
        best, best_row = torch.max(d, dim=1)
        upd = (midx < 0) & (best >= overlap_threshold)
        midx = torch.where(upd, best_row.to(torch.int32), midx)
        mdist = torch.where(upd, best, mdist)
    return midx, mdist


def _lower_bipartite_match(ctx, ins, attrs):
    dist = ins["DistMat"][0]
    if dist.dim() == 2:
        dist = dist[None]
    midx, mdist = _bipartite_match(dist, attrs.get("match_type", "bipartite"),
                                   attrs.get("dist_threshold", 0.5))
    return {"ColToRowMatchIndices": midx, "ColToRowMatchDist": mdist}


register_op(
    "bipartite_match",
    inputs=["DistMat"],
    outputs=["ColToRowMatchIndices", "ColToRowMatchDist"],
    attrs={"match_type": "bipartite", "dist_threshold": 0.5},
    lower=_lower_bipartite_match,
    grad=None,
)


def _lower_target_assign(ctx, ins, attrs):
    x = ins["X"][0]  # [N, G, K] or [N, G, P, K] padded per-image gt rows
    midx = ins["MatchIndices"][0]  # [N, P], -1 = unmatched
    neg = ins["NegMask"][0] if ins.get("NegMask") else None  # [N, P]
    mismatch = attrs.get("mismatch_value", 0)

    matched = midx >= 0
    safe = torch.clamp_min(midx, 0).to(torch.int64)
    n, p = midx.shape
    if x.dim() == 4:
        # per-prior targets (encoded boxes): out[n, p] = x[n, match, p]
        out = x[torch.arange(n, device=x.device)[:, None], safe,
                torch.arange(p, device=x.device)[None, :]]
    else:
        out = _gather_rows(x, safe)
    fill = float(mismatch) if x.is_floating_point() else int(mismatch)
    out = torch.where(matched[..., None], out, fill)
    w = matched.to(torch.float32)
    if neg is not None:
        w = torch.maximum(w, neg.to(torch.float32))
    return {"Out": out, "OutWeight": w[..., None]}


register_op(
    "target_assign",
    inputs=["X", "MatchIndices", "NegMask"],
    outputs=["Out", "OutWeight"],
    attrs={"mismatch_value": 0},
    lower=_lower_target_assign,
    grad=None,
)


def _rank_of(order):
    """The inverse permutation of each row of ``order`` ``[N, P]``."""
    n, p = order.shape
    ranks = torch.arange(p, device=order.device).expand(n, p)
    return torch.empty_like(order).scatter_(1, order, ranks)


def _lower_mine_hard_examples(ctx, ins, attrs):
    cls_loss = ins["ClsLoss"][0]  # [N, P]
    loc_loss = ins["LocLoss"][0] if ins.get("LocLoss") else None
    midx = ins["MatchIndices"][0]  # [N, P]
    mdist = ins["MatchDist"][0]
    ratio = attrs.get("neg_pos_ratio", 3.0)
    neg_thr = attrs.get("neg_dist_threshold", 0.5)
    mining = attrs.get("mining_type", "max_negative")
    sample_size = attrs.get("sample_size", 0) or 0

    loss = cls_loss if loc_loss is None else cls_loss + loc_loss
    pos = midx >= 0
    cand = (~pos) & (mdist < neg_thr)
    num_pos = torch.sum(pos, dim=1)
    num_cand = torch.sum(cand, dim=1)
    if mining == "hard_example" and sample_size:
        num_neg = torch.clamp_max(num_cand, sample_size)
    else:
        # float32 ratio * num_pos, truncated
        num_neg = torch.minimum(
            (num_pos.to(torch.float32) * ratio).to(num_cand.dtype),
            num_cand)
    masked = torch.where(cand, loss, -_INF)
    rank = _rank_of(_argsort_desc(masked, dim=1))
    neg_mask = cand & (rank < num_neg[:, None])
    return {"NegMask": neg_mask.to(torch.float32),
            "UpdatedMatchIndices": midx}


register_op(
    "mine_hard_examples",
    inputs=["ClsLoss", "LocLoss", "MatchIndices", "MatchDist"],
    outputs=["NegMask", "UpdatedMatchIndices"],
    attrs={
        "neg_pos_ratio": 3.0,
        "neg_dist_threshold": 0.5,
        "mining_type": "max_negative",
        "sample_size": 0,
    },
    lower=_lower_mine_hard_examples,
    grad=None,
)


# ---------------------------------------------------------------------------
# multiclass_nms: fixed capacity, label -1 padding, a count per image
# ---------------------------------------------------------------------------


def nms_candidates(scores, boxes, attrs):
    """``multiclass_nms``'s input to the greedy NMS: each image's and
    foreground class's top ``nms_top_k`` candidates by score (a stable
    sort). ``scores`` ``[N, C, P]``, ``boxes`` ``[N, P, 4]`` -> (their
    scores ``[N, M, k]``, their boxes ``[N, M, k, 4]``), M the classes
    but the background one."""
    n, c, p = scores.shape
    nms_top_k = attrs.get("nms_top_k", -1)
    k = min(nms_top_k, p) if nms_top_k > 0 else p
    fg = _drop(scores, attrs.get("background_label", 0), 1)  # [N, M, P]
    cand = _argsort_desc(fg)[..., :k]  # [N, M, k]
    ar = torch.arange(n, device=scores.device)[:, None, None]
    return torch.gather(fg, 2, cand), boxes[ar, cand]


def nms_keep(s, b, attrs, nms=None):
    """The keep mask ``[N, M, k]`` of ``nms_candidates``' output:
    ``kernels/detection.py`` ``greedy_nms`` over the ``N * M`` rows (or
    ``nms``, a function of the same arguments)."""
    n, m, k = s.shape
    offset = 0.0 if attrs.get("normalized", True) else 1.0
    return (nms or kdet.greedy_nms)(
        b.reshape(n * m, k, 4),
        (s > attrs.get("score_threshold", 0.0)).reshape(n * m, k),
        attrs.get("nms_threshold", 0.3), attrs.get("nms_eta", 1.0),
        offset).reshape(n, m, k)


def _lower_multiclass_nms(ctx, ins, attrs):
    scores = ins["Scores"][0]  # [N, C, P]
    boxes = ins["BBoxes"][0]  # [N, P, 4]
    n, c, _ = scores.shape
    bg = attrs.get("background_label", 0)
    keep_top_k = attrs.get("keep_top_k", -1)
    dev = scores.device
    s, b = nms_candidates(scores, boxes, attrs)
    m, k = s.shape[1], s.shape[2]
    keep = nms_keep(s, b, attrs)
    # class-major, as the reference concatenates the classes
    cat_s = torch.where(keep, s, -_INF).reshape(n, m * k)
    cat_b = b.reshape(n, m * k, 4)
    cat_l = _drop(torch.arange(c, dtype=torch.float32, device=dev), bg,
                  0).repeat_interleave(k)
    total = m * k
    kk = min(keep_top_k, total) if keep_top_k > 0 else total
    top = _argsort_desc(cat_s)[:, :kk]
    sel_s = torch.gather(cat_s, 1, top)
    valid = torch.isfinite(sel_s)
    out = torch.cat([
        torch.where(valid, cat_l[top], -1.0)[..., None],
        torch.where(valid, sel_s, 0.0)[..., None],
        torch.where(valid[..., None], _gather_rows(cat_b, top), 0.0),
    ], dim=2)
    return {"Out": out, "Count": torch.sum(valid, dim=1).to(torch.int32)}


register_op(
    "multiclass_nms",
    inputs=["BBoxes", "Scores"],
    outputs=["Out", "Count"],
    attrs={
        "background_label": 0,
        "score_threshold": 0.0,
        "nms_top_k": -1,
        "nms_threshold": 0.3,
        "nms_eta": 1.0,
        "keep_top_k": -1,
        "normalized": True,
    },
    lower=_lower_multiclass_nms,
    grad=None,
)


# ---------------------------------------------------------------------------
# ROI ops: the dense RoisBatch index vector maps each roi to its image
# ---------------------------------------------------------------------------


def _rois_batch(ins, rois):
    if ins.get("RoisBatch"):
        return ins["RoisBatch"][0].to(torch.int64)
    return torch.zeros((rois.shape[0],), dtype=torch.int64,
                       device=rois.device)


def _lower_roi_pool(ctx, ins, attrs):
    """roi_pool_op.cc's quantized max pool, every roi at once: the
    separable masked max (rows, then columns) of the JAX package."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    feats = x[_rois_batch(ins, rois)]  # [R, C, H, W]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    h, w = feats.shape[2], feats.shape[3]
    dev = feats.device
    rs = torch.round(rois * scale)
    x1, y1 = rs[:, 0:1], rs[:, 1:2]
    rw = torch.clamp_min(rs[:, 2:3] - rs[:, 0:1] + 1, 1.0)
    rh = torch.clamp_min(rs[:, 3:4] - rs[:, 1:2] + 1, 1.0)
    bin_w = rw * _recip(pw)
    bin_h = rh * _recip(ph)
    ii = torch.arange(ph, dtype=torch.float32, device=dev)[None, :]
    jj = torch.arange(pw, dtype=torch.float32, device=dev)[None, :]
    hstart = torch.clamp(torch.floor(ii * bin_h) + y1, 0, h)
    hend = torch.clamp(torch.ceil((ii + 1) * bin_h) + y1, 0, h)
    wstart = torch.clamp(torch.floor(jj * bin_w) + x1, 0, w)
    wend = torch.clamp(torch.ceil((jj + 1) * bin_w) + x1, 0, w)
    hh = torch.arange(h, dtype=torch.float32, device=dev)
    ww = torch.arange(w, dtype=torch.float32, device=dev)
    hm = (hh >= hstart[..., None]) & (hh < hend[..., None])  # [R, ph, H]
    wm = (ww >= wstart[..., None]) & (ww < wend[..., None])  # [R, pw, W]
    # [R, ph, C, W]: the max over each bin's rows
    rows = torch.amax(torch.where(hm[:, :, None, :, None], feats[:, None],
                                  -_INF), dim=3)
    # [R, pw, ph, C]: then over its columns
    cols = torch.amax(torch.where(wm[:, :, None, None, :], rows[:, None],
                                  -_INF), dim=4)
    out = cols.permute(0, 3, 2, 1)  # [R, C, ph, pw]
    return torch.where(torch.isfinite(out), out, 0.0)


register_op(
    "roi_pool",
    inputs=["X", "ROIs", "RoisBatch"],
    outputs=["Out"],
    attrs={"pooled_height": 1, "pooled_width": 1, "spatial_scale": 1.0},
    lower=_lower_roi_pool,
    grad="auto",
    no_grad_inputs=("ROIs", "RoisBatch"),
)


def _sample(feats, yy, xx):
    """``feats`` ``[R, C, H, W]`` at integer-valued float coordinates
    ``yy`` ``[R, a, 1]`` and ``xx`` ``[R, 1, b]``: ``[R, C, a, b]``."""
    r = torch.arange(feats.shape[0], device=feats.device)[:, None, None]
    return feats[r, :, yy.to(torch.int64), xx.to(torch.int64)].permute(
        0, 3, 1, 2)


def _bilinear(feats, yy, xx, h, w):
    """The JAX package's bilinear read: coordinates clipped to the map,
    the four neighbours' weighted sum in its order."""
    yy = torch.clamp(yy, 0.0, h - 1.0)
    xx = torch.clamp(xx, 0.0, w - 1.0)
    y0 = torch.floor(yy)
    x0 = torch.floor(xx)
    y1 = torch.clamp_max(y0 + 1, h - 1.0)
    x1 = torch.clamp_max(x0 + 1, w - 1.0)
    ly, lx = (yy - y0)[:, None], (xx - x0)[:, None]
    return (_sample(feats, y0, x0) * (1 - ly) * (1 - lx)
            + _sample(feats, y0, x1) * (1 - ly) * lx
            + _sample(feats, y1, x0) * ly * (1 - lx)
            + _sample(feats, y1, x1) * ly * lx)


def _lower_roi_align(ctx, ins, attrs):
    """roi_align_op.cc's bilinear average, every roi at once."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    feats = x[_rois_batch(ins, rois)]  # [R, C, H, W]
    ph = attrs.get("pooled_height", 1)
    pw = attrs.get("pooled_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    sr = attrs.get("sampling_ratio", -1)
    r, c, h, w = feats.shape
    dev = feats.device
    x1 = rois[:, 0] * scale
    y1 = rois[:, 1] * scale
    rw = torch.clamp_min(rois[:, 2] * scale - x1, 1.0)
    rh = torch.clamp_min(rois[:, 3] * scale - y1, 1.0)
    bin_w = (rw * _recip(pw))[:, None, None]
    bin_h = (rh * _recip(ph))[:, None, None]
    s = sr if sr > 0 else 2
    frac = ((torch.arange(s, dtype=torch.float32, device=dev) + 0.5)
            * _recip(s))[None, None, :]
    ii = torch.arange(ph, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(pw, dtype=torch.float32, device=dev)[None, :, None]
    sy = y1[:, None, None] + (ii + frac) * bin_h  # [R, ph, s]
    sx = x1[:, None, None] + (jj + frac) * bin_w  # [R, pw, s]
    vals = _bilinear(feats, sy.reshape(r, -1, 1), sx.reshape(r, 1, -1),
                     h, w)  # [R, C, ph * s, pw * s]
    return torch.mean(vals.reshape(r, c, ph, s, pw, s), dim=(3, 5))


register_op(
    "roi_align",
    inputs=["X", "ROIs", "RoisBatch"],
    outputs=["Out"],
    attrs={
        "pooled_height": 1,
        "pooled_width": 1,
        "spatial_scale": 1.0,
        "sampling_ratio": -1,
    },
    lower=_lower_roi_align,
    grad="auto",
    no_grad_inputs=("ROIs", "RoisBatch"),
)


def _perspective_coef(qx, qy, tw, th):
    """The homography from the output rectangle to each roi's quad
    (``get_transform_matrix``): ``[R, 8]`` from ``[R, 4]`` corners in
    u/v grid order. ``solve_ex``: no check, so no host sync."""
    dev = qx.device
    corner = torch.arange(4, device=dev).expand_as(qx)
    u = (corner % 2) * (tw - 1.0)  # 0, tw - 1, 0, tw - 1
    v = (corner // 2) * (th - 1.0)  # 0, 0, th - 1, th - 1
    zeros = torch.zeros_like(qx)
    ones = torch.ones_like(qx)
    a_rows = torch.stack([u, v, ones, zeros, zeros, zeros, -u * qx, -v * qx],
                         dim=2)
    b_rows = torch.stack([zeros, zeros, zeros, u, v, ones, -u * qy, -v * qy],
                         dim=2)
    mat = torch.cat([a_rows, b_rows], dim=1)  # [R, 8, 8]
    rhs = torch.cat([qx, qy], dim=1)[..., None]
    return torch.linalg.solve_ex(mat, rhs)[0][..., 0]


def _lower_roi_perspective_transform(ctx, ins, attrs):
    """roi_perspective_transform_op.cc: each quad [R, 8] warped to a
    ``transformed_height`` x ``transformed_width`` rectangle by its
    homography and read bilinearly; points outside the map read 0."""
    x, rois = ins["X"][0], ins["ROIs"][0]
    feats = x[_rois_batch(ins, rois)]
    th = attrs.get("transformed_height", 1)
    tw = attrs.get("transformed_width", 1)
    scale = attrs.get("spatial_scale", 1.0)
    r, c, h, w = feats.shape
    dev = feats.device
    qx = rois[:, 0::2] * scale
    qy = rois[:, 1::2] * scale
    # corners (x1,y1) top-left, (x2,y2) top-right, (x3,y3) bottom-right,
    # (x4,y4) bottom-left -> u/v grid order
    qx = torch.stack([qx[:, 0], qx[:, 1], qx[:, 3], qx[:, 2]], dim=1)
    qy = torch.stack([qy[:, 0], qy[:, 1], qy[:, 3], qy[:, 2]], dim=1)
    coef = _perspective_coef(qx, qy, tw, th)[:, :, None, None]
    vv, uu = torch.meshgrid(torch.arange(th, dtype=torch.float32, device=dev),
                            torch.arange(tw, dtype=torch.float32, device=dev),
                            indexing="ij")
    denom = coef[:, 6] * uu + coef[:, 7] * vv + 1.0
    sx = (coef[:, 0] * uu + coef[:, 1] * vv + coef[:, 2]) / denom
    sy = (coef[:, 3] * uu + coef[:, 4] * vv + coef[:, 5]) / denom
    inside = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    sxc = torch.clamp(sx, 0.0, w - 1.0)
    syc = torch.clamp(sy, 0.0, h - 1.0)
    x0 = torch.floor(sxc)
    y0 = torch.floor(syc)
    x1 = torch.clamp_max(x0 + 1, w - 1.0)
    y1 = torch.clamp_max(y0 + 1, h - 1.0)
    lx, ly = (sxc - x0)[:, None], (syc - y0)[:, None]
    ar = torch.arange(r, device=dev)[:, None, None]

    def g(yy, xx):  # [R, C, th, tw]
        return feats[ar, :, yy.to(torch.int64), xx.to(torch.int64)].permute(
            0, 3, 1, 2)

    val = (g(y0, x0) * (1 - ly) * (1 - lx)
           + g(y0, x1) * (1 - ly) * lx
           + g(y1, x0) * ly * (1 - lx)
           + g(y1, x1) * ly * lx)
    return torch.where(inside[:, None], val, 0.0)


register_op(
    "roi_perspective_transform",
    inputs=["X", "ROIs", "RoisBatch"],
    outputs=["Out"],
    attrs={
        "transformed_height": 1,
        "transformed_width": 1,
        "spatial_scale": 1.0,
    },
    lower=_lower_roi_perspective_transform,
    grad="auto",
    no_grad_inputs=("ROIs", "RoisBatch"),
)


# ---------------------------------------------------------------------------
# RPN target assignment, proposal generation, RoI sampling
# ---------------------------------------------------------------------------


def _rpn_encode(anchors, gt):
    """The RPN box encoding (dx, dy, dw, dh); anchors, gt ``[..., 4]``."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + aw * 0.5
    acy = anchors[..., 1] + ah * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + gw * 0.5
    gcy = gt[..., 1] + gh * 0.5
    return torch.stack([
        (gcx - acx) / aw,
        (gcy - acy) / ah,
        torch.log(torch.clamp_min(gw / aw, 1e-10)),
        torch.log(torch.clamp_min(gh / ah, 1e-10)),
    ], dim=-1)


def _image_draws(ctx, n, size, device):
    """Per image, the two uniform draws of the JAX package's samplers:
    ``keys = split(rng, n)``, then ``k1, k2 = split(key)`` and
    ``uniform(k, (size,))`` each: two ``[n, size]`` tensors. None during
    shape inference (no key), where any tensor of the shape will do."""
    key = ctx.rng()
    if key is None:
        return None
    keys = prng.split(key, n, device=device)
    pair = prng.split(keys, 2)  # [n, 2, 2]
    return (prng.uniform(pair[:, 0], (size,)),
            prng.uniform(pair[:, 1], (size,)))


def _lower_rpn_target_assign(ctx, ins, attrs):
    anchors = ins["Anchor"][0].reshape(-1, 4)  # [A, 4]
    gt = ins["GtBoxes"][0]  # [N, G, 4]
    n, g = gt.shape[0], gt.shape[1]
    a = anchors.shape[0]
    dev = gt.device
    bs = attrs.get("rpn_batch_size_per_im", 256)
    straddle = attrs.get("rpn_straddle_thresh", 0.0)
    fg_frac = attrs.get("rpn_fg_fraction", 0.5)
    pos_thr = attrs.get("rpn_positive_overlap", 0.7)
    neg_thr = attrs.get("rpn_negative_overlap", 0.3)
    use_random = attrs.get("use_random", True)
    n_fg = int(round(bs * fg_frac))
    n_all = bs
    if ins.get("ImInfo"):
        im_info = ins["ImInfo"][0]  # [N, 3]
        ih, iw = im_info[:, 0:1], im_info[:, 1:2]
    else:  # no image bounds: every anchor counts as inside
        ih = iw = torch.full((n, 1), _INF, dtype=torch.float32, device=dev)
    if ins.get("IsCrowd"):
        is_crowd = ins["IsCrowd"][0].to(torch.int32)  # [N, G]
    else:
        is_crowd = torch.zeros((n, g), dtype=torch.int32, device=dev)

    inside = ((anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle)
              & (anchors[:, 2] < iw + straddle)
              & (anchors[:, 3] < ih + straddle))  # [N, A]
    has_box = torch.amax(gt, dim=2) > 0
    gt_valid = has_box & (is_crowd == 0)
    iou = _iou(gt, anchors)  # [N, G, A]
    # anchors on crowd regions are left out of sampling
    crowd_rows = has_box & (is_crowd != 0)
    crowd_hit = torch.any(
        torch.where(crowd_rows[:, :, None], iou, -1.0) >= neg_thr, dim=1)
    inside = inside & ~crowd_hit
    iou = torch.where(gt_valid[:, :, None] & inside[:, None, :], iou, -1.0)
    anchor_best, anchor_gt = torch.max(iou, dim=1)  # [N, A]
    gt_best = torch.amax(iou, dim=2)  # [N, G]
    is_gt_best = torch.any(
        (iou == gt_best[:, :, None]) & gt_valid[:, :, None]
        & (gt_best[:, :, None] > 0), dim=1)
    pos = inside & ((anchor_best >= pos_thr) | is_gt_best)
    neg = inside & ~pos & (anchor_best < neg_thr)

    if use_random:
        u1, u2 = _image_draws(ctx, n, a, dev) or (anchor_best, anchor_best)
        fg_score = torch.where(pos, u1, -_INF)
        bg_score = torch.where(neg, u2, -_INF)
    else:
        fg_score = torch.where(pos, anchor_best, -_INF)
        bg_score = torch.where(neg, -anchor_best, -_INF)
    fg_idx = _argsort_desc(fg_score)[:, :n_fg]
    fg_ok = torch.gather(pos, 1, fg_idx)
    num_fg = torch.sum(fg_ok, dim=1)
    bg_idx = _argsort_desc(bg_score)[:, :n_all]
    bg_ok = torch.gather(neg, 1, bg_idx) & (
        torch.arange(bg_idx.shape[1], device=dev)[None, :]
        < (n_all - num_fg)[:, None])

    loc_index = torch.where(fg_ok, fg_idx, -1).to(torch.int32)
    score_index = torch.cat(
        [loc_index, torch.where(bg_ok, bg_idx, -1).to(torch.int32)], dim=1)
    tgt_label = torch.cat(
        [fg_ok.to(torch.int32),
         torch.zeros((n, n_all), dtype=torch.int32, device=dev)], dim=1)
    label_w = torch.cat([fg_ok, bg_ok], dim=1).to(torch.float32)
    matched_gt = _gather_rows(gt, torch.gather(anchor_gt, 1, fg_idx))
    tgt_bbox = _rpn_encode(anchors[fg_idx], matched_gt)
    bbox_w = fg_ok[:, :, None].to(torch.float32).expand(
        n, fg_idx.shape[1], 4).contiguous()
    return {"LocIndex": loc_index, "ScoreIndex": score_index,
            "TargetBBox": tgt_bbox, "TargetLabel": tgt_label,
            "BBoxInsideWeight": bbox_w, "LabelWeight": label_w}


register_op(
    "rpn_target_assign",
    inputs=["Anchor", "GtBoxes", "IsCrowd", "ImInfo"],
    outputs=[
        "LocIndex",
        "ScoreIndex",
        "TargetBBox",
        "TargetLabel",
        "BBoxInsideWeight",
        "LabelWeight",
    ],
    attrs={
        "rpn_batch_size_per_im": 256,
        "rpn_straddle_thresh": 0.0,
        "rpn_fg_fraction": 0.5,
        "rpn_positive_overlap": 0.7,
        "rpn_negative_overlap": 0.3,
        "use_random": True,
    },
    lower=_lower_rpn_target_assign,
    grad=None,
)


def _lower_generate_proposals(ctx, ins, attrs):
    scores = ins["Scores"][0]  # [N, A, H, W]
    deltas = ins["BboxDeltas"][0]  # [N, A*4, H, W]
    im_info = ins["ImInfo"][0]  # [N, 3]
    anchors = ins["Anchors"][0].reshape(-1, 4)
    variances = ins["Variances"][0].reshape(-1, 4)
    pre_n = attrs.get("pre_nms_topN", 6000)
    post_n = attrs.get("post_nms_topN", 1000)
    min_size = attrs.get("min_size", 0.1)
    n, a, h, w = scores.shape
    dev = scores.device
    # [N, A, H, W] -> [N, H*W*A], the anchors' layout [H, W, A, 4]
    sc = scores.permute(0, 2, 3, 1).reshape(n, -1)
    dl = deltas.reshape(n, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        n, -1, 4)
    k = min(pre_n, sc.shape[1])
    top = _argsort_desc(sc)[:, :k]  # [N, k]
    sc = torch.gather(sc, 1, top)
    d = _gather_rows(dl, top)
    an = anchors[top]
    var = variances[top]
    # decode (anchor + variance-scaled deltas), generate_proposals_op.cc
    aw = an[..., 2] - an[..., 0] + 1.0
    ah = an[..., 3] - an[..., 1] + 1.0
    acx = an[..., 0] + aw * 0.5
    acy = an[..., 1] + ah * 0.5
    cx = var[..., 0] * d[..., 0] * aw + acx
    cy = var[..., 1] * d[..., 1] * ah + acy
    wf = torch.exp(torch.clamp_max(var[..., 2] * d[..., 2], 10.0)) * aw
    hf = torch.exp(torch.clamp_max(var[..., 3] * d[..., 3], 10.0)) * ah
    ih, iw = im_info[:, 0:1], im_info[:, 1:2]
    zero = torch.zeros_like(ih)
    boxes = torch.stack([
        torch.clamp(cx - wf * 0.5, zero, iw - 1),
        torch.clamp(cy - hf * 0.5, zero, ih - 1),
        torch.clamp(cx + wf * 0.5 - 1, zero, iw - 1),
        torch.clamp(cy + hf * 0.5 - 1, zero, ih - 1),
    ], dim=2)
    # drop boxes below min_size, scaled by im_info[2]
    ms = min_size * im_info[:, 2:3]
    keep_size = (((boxes[..., 2] - boxes[..., 0] + 1) >= ms)
                 & ((boxes[..., 3] - boxes[..., 1] + 1) >= ms))
    sc = torch.where(keep_size, sc, -_INF)
    keep = kdet.greedy_nms(boxes, torch.isfinite(sc),
                           attrs.get("nms_thresh", 0.5),
                           attrs.get("eta", 1.0), 0.0)
    # compact the kept boxes to the front, fixed capacity post_n
    ar = torch.arange(k, device=dev).expand(n, k)
    sel = torch.sort(torch.where(keep, ar, k), dim=1,
                     stable=True).indices[:, :post_n]
    kept = torch.gather(keep, 1, sel)
    out = torch.where(kept[..., None], _gather_rows(boxes, sel), 0.0)
    probs = torch.where(kept, torch.gather(sc, 1, sel), 0.0)
    valid = torch.clamp_max(torch.sum(keep, dim=1), post_n).to(torch.int32)
    return {"RpnRois": out, "RpnRoiProbs": probs, "RpnRoisCount": valid}


register_op(
    "generate_proposals",
    inputs=["Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances"],
    outputs=["RpnRois", "RpnRoiProbs", "RpnRoisCount"],
    attrs={
        "pre_nms_topN": 6000,
        "post_nms_topN": 1000,
        "nms_thresh": 0.5,
        "min_size": 0.1,
        "eta": 1.0,
    },
    lower=_lower_generate_proposals,
    grad=None,
)


def _lower_generate_proposal_labels(ctx, ins, attrs):
    rois = ins["RpnRois"][0]  # [N, R, 4] or [R, 4]
    gt_cls = ins["GtClasses"][0].to(torch.int32)  # [N, G]
    gt = ins["GtBoxes"][0]  # [N, G, 4]
    n, g = gt.shape[0], gt.shape[1]
    dev = gt.device
    bs = attrs.get("batch_size_per_im", 256)
    fg_frac = attrs.get("fg_fraction", 0.25)
    fg_thresh = attrs.get("fg_thresh", 0.5)
    bg_hi = attrs.get("bg_thresh_hi", 0.5)
    bg_lo = attrs.get("bg_thresh_lo", 0.0)
    weights = attrs.get("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])
    class_nums = attrs.get("class_nums", 2)
    use_random = attrs.get("use_random", True)
    n_fg = int(round(bs * fg_frac))
    if rois.dim() == 2:
        rois = rois[None].expand((n,) + tuple(rois.shape))
    if ins.get("IsCrowd"):
        is_crowd = ins["IsCrowd"][0].to(torch.int32)
    else:
        is_crowd = torch.zeros((n, g), dtype=torch.int32, device=dev)
    if ins.get("ImInfo"):
        im_scale = ins["ImInfo"][0][:, 2]
    else:
        im_scale = torch.ones((n,), dtype=torch.float32, device=dev)

    # crowd gt leaves the sampling; gt comes in original-image coords,
    # scaled into the roi frame by im_info's scale
    gt = gt * im_scale[:, None, None]
    gt_valid = (torch.amax(gt, dim=2) > 0) & (is_crowd == 0)
    # the gt boxes join the candidate pool, padded to n_fg + bs rows
    pool = torch.cat([rois, gt], dim=1)
    pool_valid = torch.cat(
        [torch.ones((n, rois.shape[1]), dtype=torch.bool, device=dev),
         gt_valid], dim=1)
    deficit = max(0, n_fg + bs - int(pool.shape[1]))
    if deficit:
        pool = torch.cat([pool, torch.zeros((n, deficit, 4), dtype=pool.dtype,
                                            device=dev)], dim=1)
        pool_valid = torch.cat(
            [pool_valid, torch.zeros((n, deficit), dtype=torch.bool,
                                     device=dev)], dim=1)
    iou = _iou(pool, gt)  # [N, P, G]
    iou = torch.where(gt_valid[:, None, :] & pool_valid[:, :, None], iou,
                      -1.0)
    best, best_gt = torch.max(iou, dim=2)
    fg = pool_valid & (best >= fg_thresh)
    bg = pool_valid & (best < bg_hi) & (best >= bg_lo)
    p = pool.shape[1]
    if use_random:
        u1, u2 = _image_draws(ctx, n, p, dev) or (best, best)
        fg_score = torch.where(fg, u1, -_INF)
        bg_score = torch.where(bg, u2, -_INF)
    else:
        fg_score = torch.where(fg, best, -_INF)
        bg_score = torch.where(bg, -best, -_INF)
    fg_idx = _argsort_desc(fg_score)[:, :n_fg]
    fg_ok = torch.gather(fg, 1, fg_idx)
    num_fg = torch.sum(fg_ok, dim=1)
    bg_idx = _argsort_desc(bg_score)[:, :bs]
    bg_ok = torch.gather(bg, 1, bg_idx) & (
        torch.arange(bs, device=dev)[None, :] < (bs - num_fg)[:, None])

    sel = torch.cat([fg_idx, bg_idx], dim=1)  # [N, n_fg + bs]
    ok = torch.cat([fg_ok, bg_ok], dim=1)
    is_fg = torch.cat([fg_ok, torch.zeros((n, bs), dtype=torch.bool,
                                          device=dev)], dim=1)
    out_rois = torch.where(ok[..., None], _gather_rows(pool, sel), 0.0)
    sel_gt = torch.gather(best_gt, 1, sel)
    labels = torch.where(is_fg, torch.gather(gt_cls, 1, sel_gt), 0)
    labels = torch.where(ok, labels, -1).to(torch.int32)  # -1: padding

    # class-aware regression targets: the RPN center-form encoding
    # scaled by bbox_reg_weights (padding rows have pw == ph == 1.0)
    matched = _gather_rows(gt, sel_gt)
    enc = _rpn_encode(out_rois, matched)
    deltas = torch.stack([enc[..., i] * _recip(weights[i])
                          for i in range(4)], dim=-1)
    cls = torch.clamp_min(labels, 0).to(torch.int64)
    col = torch.arange(4 * class_nums, device=dev)[None, None, :]
    in_class = (col // 4) == cls[..., None]
    on = is_fg[..., None] & in_class
    targets = torch.where(on, deltas.repeat(1, 1, class_nums), 0.0)
    inside_w = torch.where(on, 1.0, 0.0)
    return {"Rois": out_rois, "LabelsInt32": labels, "BboxTargets": targets,
            "BboxInsideWeights": inside_w, "BboxOutsideWeights": inside_w,
            "RoisWeight": ok.to(torch.float32)}


register_op(
    "generate_proposal_labels",
    inputs=["RpnRois", "GtClasses", "IsCrowd", "GtBoxes", "ImInfo"],
    outputs=["Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
             "BboxOutsideWeights", "RoisWeight"],
    attrs={
        "batch_size_per_im": 256,
        "fg_fraction": 0.25,
        "fg_thresh": 0.5,
        "bg_thresh_hi": 0.5,
        "bg_thresh_lo": 0.0,
        "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2],
        "class_nums": 2,
        "use_random": True,
    },
    lower=_lower_generate_proposal_labels,
    grad=None,
)


# ---------------------------------------------------------------------------
# detection_map: mean average precision (integral or 11-point)
# ---------------------------------------------------------------------------


def global_rank(det):
    """``detection_map``'s one global order of detections ``[N, D, 6]``:
    valid ones (label >= 0) by score, a stable sort of the flattened
    scores. Returns (the order ``[N * D]``, each detection's rank in it
    ``[N, D]``)."""
    n, d_cap = det.shape[0], det.shape[1]
    flat = torch.where(det[:, :, 0] >= 0, det[:, :, 1], -_INF).reshape(-1)
    order = _argsort_desc(flat)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n * d_cap, device=det.device))
    return order, rank.reshape(n, d_cap)


def _lower_detection_map(ctx, ins, attrs):
    det = ins["DetectRes"][0]  # [N, D, 6] (label, score, x1, y1, x2, y2)
    gt_label = ins["GtLabel"][0].to(torch.int32)  # [N, G]
    gt_box = ins["GtBox"][0]  # [N, G, 4]
    if ins.get("GtDifficult"):
        difficult = ins["GtDifficult"][0] > 0
    else:
        difficult = torch.zeros(gt_label.shape, dtype=torch.bool,
                                device=gt_label.device)
    thr = attrs.get("overlap_threshold", 0.5)
    eval_diff = attrs.get("evaluate_difficult", True)
    ap_type = attrs.get("ap_type", "integral")
    class_num = attrs.get("class_num")
    bg = attrs.get("background_label", 0)
    dev = det.device
    gt_exists = gt_label >= 0
    # difficult gt stays matchable (a detection on it is ignored, not a
    # false positive) but counts for recall only when evaluated
    gt_countable = gt_exists if eval_diff else gt_exists & ~difficult
    order, rank = global_rank(det)
    tp, fp = kdet.det_match(det, rank, gt_label, gt_box, difficult, thr,
                            eval_diff)

    # per-class AP from the shared pass, every class at once
    cls_t = _drop(torch.arange(class_num, dtype=torch.int32, device=dev),
                  bg, 0)
    sorted_cls = det[:, :, 0].to(torch.int32).reshape(-1)[order]
    sel = sorted_cls[None, :] == cls_t[:, None]  # [K, N * D]
    n_pos = torch.sum(gt_countable[None] & (gt_label[None]
                                            == cls_t[:, None, None]),
                      dim=(1, 2))
    tpc = tp[None] & sel
    fpc = fp[None] & sel
    ctp = torch.cumsum(tpc.to(torch.float32), dim=1)
    cfp = torch.cumsum(fpc.to(torch.float32), dim=1)
    precision = ctp / torch.clamp_min(ctp + cfp, 1e-10)
    recall = ctp / torch.clamp_min(n_pos.to(torch.float32), 1e-10)[:, None]
    active = tpc | fpc
    if ap_type == "11point":
        pts = [torch.amax(torch.where(active & (recall >= float(
            np.float32(r))), precision, 0.0), dim=1)
            for r in np.arange(0.0, 1.1, 0.1)]
        ap = torch.sum(torch.stack(pts, dim=1), dim=1) * _recip(11.0)
    else:  # integral
        prev_recall = torch.cat([torch.zeros_like(recall[:, :1]),
                                 recall[:, :-1]], dim=1)
        ap = torch.sum(torch.where(active, (recall - prev_recall) * precision,
                                   0.0), dim=1)
    aps = torch.where(n_pos > 0, ap, float("nan"))
    present = torch.isfinite(aps)
    m_ap = torch.sum(torch.where(present, aps, 0.0)) / torch.clamp_min(
        torch.sum(present), 1)
    return {"MAP": m_ap}


register_op(
    "detection_map",
    inputs=["DetectRes", "GtLabel", "GtBox", "GtDifficult"],
    outputs=["MAP"],
    attrs={
        "overlap_threshold": 0.5,
        "evaluate_difficult": True,
        "ap_type": "integral",
        "class_num": 2,
        "background_label": 0,
    },
    lower=_lower_detection_map,
    grad=None,
)
