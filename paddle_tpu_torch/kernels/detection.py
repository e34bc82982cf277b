"""The detection ops' greedy loops on the card: the launch wrappers of
``csrc/detection.cu``, each beside its plain version.

The port's own kernels; they replace no TPU kernel. The JAX package runs
both loops as ``lax.fori_loop``s inside its one XLA executable
(``paddle_tpu/ops/detection_ops.py:343-371`` and ``:941-955``, the
greedy NMS; ``:1037-1067``, ``detection_map``'s greedy match). The
port's ``Executor`` interprets one eager op at a time, so the same loop
in torch ops would cost the host hundreds to thousands of iterations of
several launches each, for work the card does in microseconds.

- ``greedy_nms(boxes, eligible, threshold, eta, offset)``: score-sorted
  candidates ``[B, k, 4]`` and their eligibility ``[B, k]`` give the
  keep mask ``[B, k]``: candidate ``i`` is taken when it is eligible and
  no kept ``j < i`` has an IoU with it above the current threshold,
  which shrinks by ``eta`` after a take while ``eta < 1`` and it is
  above 0.5. ``GREEDY_NMS``: one block a row.
- ``det_match(det, rank, gt_label, gt_box, difficult, threshold,
  evaluate_difficult)``: detections ``[N, D, 6]`` (label, score, box)
  walked in their global score order (``rank`` ``[N, D]``, each
  detection's position in it) against their image's ground truth;
  returns the true- and false-positive flags ``[N * D]`` at each
  detection's global rank. ``DET_MATCH``: one warp an image (``matched``
  is per image, so walking each image's detections in global order is
  the JAX package's single global pass).

The IoU is ``_iou``'s (``paddle_tpu/ops/detection_ops.py:84-99``) in
float32 with every operation rounded on its own, in both versions, so
the masks and flags of kernel and plain version are equal bit for bit.
On a CUDA tensor a wrapper launches its kernel or raises; on a meta
tensor (build-time shape inference) it returns an uninitialized result
of the output's shape; elsewhere it runs the plain version.
"""

import ctypes

import numpy as np
import torch

from paddle_tpu_torch.kernels.build import Kernel

GREEDY_NMS = Kernel("paddle_greedy_nms", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p])
DET_MATCH = Kernel("paddle_det_match", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])

# the card's per-block shared memory. greedy_nms stages a row of at
# most NMS_MAX_K candidates, 21 bytes each (its box, its eligibility, a
# kept-list slot); a longer row reads its boxes from device memory and
# keeps its kept list in a device buffer. det_match stages an image's
# gts, 22 bytes each padded to 16, and, where they fit beside them, its
# detections, 32 bytes each (its row, its walk slot, its rank); else it
# reads the detections from device memory
SMEM_LIMIT = 232448
NMS_MAX_K = SMEM_LIMIT // 21


def _gt_bytes(g):
    return 16 * g + (6 * g + 15) // 16 * 16


def iou(a, b, offset=0.0):
    """``_iou`` batched: ``a`` ``[..., n, 4]``, ``b`` ``[..., m, 4]``
    (xmin, ymin, xmax, ymax) -> ``[..., n, m]``, in its order of
    operations; ``offset`` 1 for the unnormalized pixel-box convention
    (w = x2 - x1 + 1)."""
    area_a = torch.clamp_min(a[..., 2] - a[..., 0] + offset, 0) * \
        torch.clamp_min(a[..., 3] - a[..., 1] + offset, 0)
    area_b = torch.clamp_min(b[..., 2] - b[..., 0] + offset, 0) * \
        torch.clamp_min(b[..., 3] - b[..., 1] + offset, 0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt + offset, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-10)


def _f32(x):
    return float(np.float32(x))


def greedy_nms_plain(boxes, eligible, threshold, eta=1.0, offset=0.0):
    """The kernel's plain version: the JAX package's loop over the ``k``
    candidates, every row at once (torch ops; ``k`` iterations)."""
    b, k = eligible.shape
    ov = iou(boxes, boxes, offset)
    keep = torch.zeros((b, k), dtype=torch.bool, device=boxes.device)
    thr = torch.full((b,), _f32(threshold), dtype=torch.float32,
                     device=boxes.device)
    shrink = eta < 1.0
    for i in range(k):
        sup = torch.any(keep[:, :i] & (ov[:, i, :i] > thr[:, None]), dim=1)
        take = eligible[:, i] & ~sup
        keep[:, i] = take
        if shrink:
            thr = torch.where(take & (thr > 0.5), thr * eta, thr)
    return keep


def greedy_nms(boxes, eligible, threshold, eta=1.0, offset=0.0):
    """The keep mask ``[B, k]`` (bool) of score-sorted ``boxes``
    ``[B, k, 4]`` (float32) under ``eligible`` ``[B, k]``. On the card
    one launch of ``GREEDY_NMS``."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            tuple(eligible.shape) != tuple(boxes.shape[:2]):
        raise ValueError("greedy_nms: boxes [B, k, 4] and eligible [B, k], "
                         "not %s and %s" % (list(boxes.shape),
                                            list(eligible.shape)))
    b, k = eligible.shape
    if boxes.device.type == "meta":
        return torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if boxes.device.type != "cuda":
        return greedy_nms_plain(boxes, eligible.to(torch.bool), threshold,
                                eta, offset)
    if boxes.dtype != torch.float32:
        raise TypeError("greedy_nms: float32 boxes on the card, not %s"
                        % boxes.dtype)
    if eligible.device != boxes.device:
        raise ValueError("greedy_nms: eligible on %s, boxes on %s"
                         % (eligible.device, boxes.device))
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    kept = None  # the kept lists, where a row outgrows shared memory
    if k > NMS_MAX_K:
        kept = torch.empty((b, k), dtype=torch.int32, device=boxes.device)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    elig = eligible.to(torch.bool).contiguous()
    with torch.cuda.device(boxes.device):
        GREEDY_NMS.launch(
            boxes.data_ptr(), elig.data_ptr(), b, k, _f32(threshold),
            _f32(eta), float(offset),
            None if kept is None else kept.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream(boxes.device).cuda_stream)
    return keep


def det_match_plain(det, rank, gt_label, gt_box, difficult, threshold,
                    evaluate_difficult=True):
    """The kernel's plain version: the greedy match, one detection of
    every image a step (``D`` steps), each image's detections in global
    order."""
    n, d_cap = det.shape[0], det.shape[1]
    dev = det.device
    local = torch.argsort(rank, dim=1)
    ov = iou(det[:, :, 2:6], gt_box)  # [N, D, G]
    exists = gt_label >= 0
    label = det[:, :, 0]
    cls, valid = label.to(torch.int32), label >= 0
    matched = torch.zeros(gt_label.shape, dtype=torch.bool, device=dev)
    tp = torch.zeros(n * d_cap, dtype=torch.bool, device=dev)
    fp = torch.zeros(n * d_cap, dtype=torch.bool, device=dev)
    ar = torch.arange(n, device=dev)
    for t in range(d_cap):
        j = local[:, t]
        over = torch.where(exists & (gt_label == cls[ar, j][:, None]),
                           ov[ar, j], -1.0)
        best_g = torch.argmax(over, dim=1)
        covered = over[ar, best_g] >= threshold
        hit = valid[ar, j] & covered & ~matched[ar, best_g]
        score = valid[ar, j]
        if not evaluate_difficult:
            score = score & ~(covered & difficult[ar, best_g])
        matched[ar, best_g] |= hit
        r = rank[ar, j]
        tp[r] = score & hit
        fp[r] = score & ~hit
    return tp, fp


def det_match(det, rank, gt_label, gt_box, difficult, threshold,
              evaluate_difficult=True):
    """(tp, fp): bool ``[N * D]`` at each detection's global rank.
    ``det`` ``[N, D, 6]`` float32, ``rank`` ``[N, D]`` (a permutation of
    ``0 .. N * D - 1``), ``gt_label`` ``[N, G]`` int, ``gt_box`` ``[N, G,
    4]``, ``difficult`` ``[N, G]`` bool. On the card one launch of
    ``DET_MATCH``."""
    n, d_cap = det.shape[0], det.shape[1]
    g = gt_label.shape[1]
    if det.dim() != 3 or det.shape[2] != 6 or tuple(rank.shape) != (
            n, d_cap) or tuple(gt_box.shape) != (n, g, 4) or \
            tuple(difficult.shape) != (n, g):
        raise ValueError("det_match: det [N, D, 6], rank [N, D], gt_label "
                         "[N, G], gt_box [N, G, 4], difficult [N, G]; not "
                         "%s" % ([list(t.shape) for t in (
                             det, rank, gt_label, gt_box, difficult)],))
    if det.device.type == "meta":
        return tuple(torch.empty(n * d_cap, dtype=torch.bool,
                                 device=det.device) for _ in range(2))
    if det.device.type != "cuda":
        return det_match_plain(det, rank, gt_label, gt_box,
                               difficult.to(torch.bool), threshold,
                               evaluate_difficult)
    if det.dtype != torch.float32 or gt_box.dtype != torch.float32:
        raise TypeError("det_match: float32 detections and boxes on the "
                        "card, not %s and %s" % (det.dtype, gt_box.dtype))
    if g < 1:
        raise ValueError("det_match: no ground-truth column")
    if _gt_bytes(g) > SMEM_LIMIT:
        raise ValueError("det_match: %d gts an image do not fit a block's "
                         "shared memory" % g)
    staged = _gt_bytes(g) + d_cap * 32 <= SMEM_LIMIT
    dev = det.device
    for what, t in (("rank", rank), ("gt_label", gt_label),
                    ("gt_box", gt_box), ("difficult", difficult)):
        if t.device != dev:
            raise ValueError("det_match: %s on %s, det on %s"
                             % (what, t.device, dev))
    tp = torch.empty(n * d_cap, dtype=torch.bool, device=dev)
    fp = torch.empty(n * d_cap, dtype=torch.bool, device=dev)
    if tp.numel() == 0:
        return tp, fp
    rank = rank.to(torch.int32).contiguous()
    # each image's detections in global order
    local = torch.argsort(rank, dim=1).to(torch.int32)
    det = det.contiguous()
    label = gt_label.to(torch.int32).contiguous()
    box = gt_box.contiguous()
    if box.data_ptr() % 16:
        box = box.clone()
    diff = difficult.to(torch.bool).contiguous()
    with torch.cuda.device(dev):
        DET_MATCH.launch(
            det.data_ptr(), local.data_ptr(), rank.data_ptr(),
            label.data_ptr(), box.data_ptr(), diff.data_ptr(), n, d_cap, g,
            _f32(threshold), int(bool(evaluate_difficult)), int(staged),
            tp.data_ptr(),
            fp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return tp, fp
