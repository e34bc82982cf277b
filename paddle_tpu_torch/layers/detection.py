"""Detection layers.

Counterpart of ``paddle_tpu/layers/detection.py``: every name of its
``__all__`` with its signature (reference parity:
python/paddle/fluid/layers/detection.py, plus roi_pool / roi_align),
building the same ops (``ops/detection_ops.py``).

Conventions (vs the reference's LoD ground truth):
  * ground-truth boxes are a padded dense batch ``[N, G, 4]`` where padded
    rows are all-zero; labels ``[N, G]`` use -1 (or any value: zero-box
    rows are ignored by the matcher);
  * index-list outputs (NegIndices) become dense masks;
  * NMS-style ops emit fixed-capacity results padded with label -1 plus an
    explicit per-image count.
"""

import math

from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.layers import nn, tensor
from paddle_tpu_torch.layers import loss as loss_layers

__all__ = [
    "prior_box",
    "density_prior_box",
    "multi_box_head",
    "bipartite_match",
    "target_assign",
    "detection_output",
    "multiclass_nms",
    "ssd_loss",
    "detection_map",
    "rpn_target_assign",
    "anchor_generator",
    "generate_proposals",
    "generate_proposal_labels",
    "roi_perspective_transform",
    "iou_similarity",
    "box_coder",
    "polygon_box_transform",
    "roi_pool",
    "roi_align",
]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype,
                                                      stop_gradient=True)
    variances = helper.create_variable_for_type_inference(input.dtype,
                                                          stop_gradient=True)
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={
            "min_sizes": list(min_sizes),
            "max_sizes": list(max_sizes or []),
            "aspect_ratios": list(aspect_ratios),
            "variances": list(variance),
            "flip": flip,
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
        },
    )
    return boxes, variances


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios=(1.0,),
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False,
                      name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = helper.create_variable_for_type_inference(input.dtype,
                                                      stop_gradient=True)
    variances = helper.create_variable_for_type_inference(input.dtype,
                                                          stop_gradient=True)
    helper.append_op(
        type="density_prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={
            "densities": list(densities),
            "fixed_sizes": list(fixed_sizes),
            "fixed_ratios": list(fixed_ratios),
            "variances": list(variance),
            "clip": clip,
            "step_w": steps[0],
            "step_h": steps[1],
            "offset": offset,
            "flatten_to_2d": flatten_to_2d,
        },
    )
    if flatten_to_2d:
        boxes = nn.reshape(boxes, shape=[-1, 4])
        variances = nn.reshape(variances, shape=[-1, 4])
    return boxes, variances


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="iou_similarity", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}
    )
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(
        type="box_coder",
        inputs=inputs,
        outputs={"OutputBox": [out]},
        attrs={"code_type": code_type, "box_normalized": box_normalized},
    )
    return out


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    """Greedy bipartite matching on a padded distance matrix [N, G, P].

    Returns (match_indices [N, P] int32 with -1 for unmatched, match_dist
    [N, P]). Reference: bipartite_match_op.cc.
    """
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    match_dist = helper.create_variable_for_type_inference(
        dist_matrix.dtype, stop_gradient=True)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix]},
        outputs={
            "ColToRowMatchIndices": [match_indices],
            "ColToRowMatchDist": [match_dist],
        },
        attrs={"match_type": match_type, "dist_threshold": dist_threshold},
    )
    return match_indices, match_dist


def target_assign(input, match_indices, negative_mask=None, mismatch_value=0,
                  name=None):
    """Assign per-prior targets by match index; returns (out, out_weight).

    ``input`` is [N, G, K] (per-gt rows) or [N, G, P, K] (per-gt-per-prior,
    e.g. encoded boxes). ``negative_mask`` [N, P] marks hard negatives whose
    weight is forced to 1 (the reference's NegIndices LoD, densified).
    Reference: target_assign_op.cc.
    """
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    out_weight = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    inputs = {"X": [input], "MatchIndices": [match_indices]}
    if negative_mask is not None:
        inputs["NegMask"] = [negative_mask]
    helper.append_op(
        type="target_assign",
        inputs=inputs,
        outputs={"Out": [out], "OutWeight": [out_weight]},
        attrs={"mismatch_value": mismatch_value},
    )
    return out, out_weight


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.0,
                   nms_top_k=-1, nms_threshold=0.3, nms_eta=1.0,
                   keep_top_k=-1, normalized=True, name=None):
    """Multi-class NMS. scores [N, C, P], bboxes [N, P, 4].

    Returns (out [N, keep_top_k, 6] padded with label -1, count [N]).
    Reference: multiclass_nms_op.cc (LoD output becomes padded + count).
    """
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype,
                                                    stop_gradient=True)
    count = helper.create_variable_for_type_inference("int32",
                                                      stop_gradient=True)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out], "Count": [count]},
        attrs={
            "background_label": background_label,
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "nms_threshold": nms_threshold,
            "nms_eta": nms_eta,
            "keep_top_k": keep_top_k,
            "normalized": normalized,
        },
    )
    return out, count


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     name=None):
    """SSD inference head: decode loc against priors, softmax scores, NMS.

    loc [N, P, 4], scores [N, P, C]. Returns the padded NMS output
    [N, keep_top_k, 6]. Reference: layers/detection.py:197 detection_output.
    """
    decoded = box_coder(
        prior_box=prior_box,
        prior_box_var=prior_box_var,
        target_box=loc,
        code_type="decode_center_size",
    )
    probs = nn.softmax(scores)
    probs = nn.transpose(probs, perm=[0, 2, 1])  # [N, C, P]
    out, _ = multiclass_nms(
        bboxes=decoded,
        scores=probs,
        background_label=background_label,
        score_threshold=score_threshold,
        nms_top_k=nms_top_k,
        nms_threshold=nms_threshold,
        nms_eta=nms_eta,
        keep_top_k=keep_top_k,
        name=name,
    )
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss (match -> mine hard negatives -> assign -> loss).

    location [N, P, 4], confidence [N, P, C], gt_box [N, G, 4] zero-padded,
    gt_label [N, G] (or [N, G, 1]) int. Returns loss [N, 1].
    Reference: layers/detection.py:672 ssd_loss (same five steps, dense).
    """
    if mining_type != "max_negative":
        raise ValueError("Only mining_type == max_negative is supported.")
    helper = LayerHelper("ssd_loss")
    num, num_prior, num_class = confidence.shape

    # 1. match priors to ground truth
    iou = iou_similarity(x=gt_box, y=prior_box)  # [N, G, P]
    matched_indices, matched_dist = bipartite_match(
        iou, match_type, overlap_threshold)

    # 2. confidence loss against matched labels (for mining)
    if len(gt_label.shape) == 2:
        gt_label3 = nn.reshape(gt_label, shape=[0, -1, 1])
    else:
        gt_label3 = gt_label
    target_label, _ = target_assign(
        gt_label3, matched_indices, mismatch_value=background_label)
    conf2d = nn.reshape(confidence, shape=[-1, num_class])
    tl2d = nn.reshape(tensor.cast(target_label, "int32"), shape=[-1, 1])
    tl2d.stop_gradient = True
    conf_loss = loss_layers.softmax_with_cross_entropy(conf2d, tl2d)
    conf_loss = nn.reshape(conf_loss, shape=[num, num_prior])
    conf_loss.stop_gradient = True

    # 3. mine hard negatives
    neg_mask = helper.create_variable_for_type_inference(
        "float32", stop_gradient=True)
    updated_indices = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(
        type="mine_hard_examples",
        inputs={
            "ClsLoss": [conf_loss],
            "MatchIndices": [matched_indices],
            "MatchDist": [matched_dist],
        },
        outputs={
            "NegMask": [neg_mask],
            "UpdatedMatchIndices": [updated_indices],
        },
        attrs={
            "neg_pos_ratio": neg_pos_ratio,
            "neg_dist_threshold": neg_overlap,
            "mining_type": mining_type,
            "sample_size": sample_size or 0,
        },
    )

    # 4. regression + classification targets
    encoded_bbox = box_coder(
        prior_box=prior_box,
        prior_box_var=prior_box_var,
        target_box=gt_box,
        code_type="encode_center_size",
    )  # [N, G, P, 4]
    target_bbox, target_loc_weight = target_assign(
        encoded_bbox, updated_indices, mismatch_value=background_label)
    target_label, target_conf_weight = target_assign(
        gt_label3, updated_indices, negative_mask=neg_mask,
        mismatch_value=background_label)

    # 5. weighted losses
    tl2d = nn.reshape(tensor.cast(target_label, "int32"), shape=[-1, 1])
    tl2d.stop_gradient = True
    conf_loss = loss_layers.softmax_with_cross_entropy(conf2d, tl2d)
    tcw2d = nn.reshape(target_conf_weight, shape=[-1, 1])
    tcw2d.stop_gradient = True
    conf_loss = nn.elementwise_mul(conf_loss, tcw2d)

    loc2d = nn.reshape(location, shape=[-1, 4])
    tb2d = nn.reshape(target_bbox, shape=[-1, 4])
    tb2d.stop_gradient = True
    loc_loss = loss_layers.smooth_l1(loc2d, tb2d)
    tlw2d = nn.reshape(target_loc_weight, shape=[-1, 1])
    tlw2d.stop_gradient = True
    loc_loss = nn.elementwise_mul(loc_loss, tlw2d)

    loss = nn.elementwise_add(
        nn.scale(conf_loss, scale=conf_loss_weight),
        nn.scale(loc_loss, scale=loc_loss_weight),
    )
    loss = nn.reshape(loss, shape=[-1, num_prior])
    loss = nn.reduce_sum(loss, dim=1, keep_dim=True)
    if normalize:
        normalizer = nn.reduce_sum(tlw2d)
        normalizer.stop_gradient = True
        loss = nn.elementwise_div(loss, normalizer)
    return loss


def detection_map(detect_res, gt_label, gt_box, gt_difficult=None,
                  class_num=None, background_label=0, overlap_threshold=0.5,
                  evaluate_difficult=True, ap_version="integral", name=None):
    """mAP over padded detections [N, D, 6] and dense ground truth.

    Reference: detection_map_op.cc; this op scores one batch in-graph
    (the accumulating ``metrics.DetectionMAP`` is not ported yet).
    """
    if class_num is None:
        raise ValueError("detection_map requires class_num")
    helper = LayerHelper("detection_map", name=name)
    m_ap = helper.create_variable_for_type_inference("float32",
                                                     stop_gradient=True)
    inputs = {
        "DetectRes": [detect_res],
        "GtLabel": [gt_label],
        "GtBox": [gt_box],
    }
    if gt_difficult is not None:
        inputs["GtDifficult"] = [gt_difficult]
    helper.append_op(
        type="detection_map",
        inputs=inputs,
        outputs={"MAP": [m_ap]},
        attrs={
            "overlap_threshold": overlap_threshold,
            "evaluate_difficult": evaluate_difficult,
            "ap_type": ap_version,
            "class_num": class_num,
            "background_label": background_label,
        },
    )
    return m_ap


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    variances = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    helper.append_op(
        type="anchor_generator",
        inputs={"Input": [input]},
        outputs={"Anchors": [anchors], "Variances": [variances]},
        attrs={
            "anchor_sizes": list(anchor_sizes or [64.0, 128.0, 256.0, 512.0]),
            "aspect_ratios": list(aspect_ratios or [0.5, 1.0, 2.0]),
            "variances": list(variance),
            "stride": list(stride or [16.0, 16.0]),
            "offset": offset,
        },
    )
    return anchors, variances


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var, gt_boxes,
                      is_crowd=None, im_info=None, rpn_batch_size_per_im=256,
                      rpn_straddle_thresh=0.0, rpn_fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      use_random=True):
    """RPN anchor sampling; fixed-size index outputs padded with -1.

    bbox_pred [N, A, 4], cls_logits [N, A, 1], anchor_box [A, 4],
    gt_boxes [N, G, 4] zero-padded, im_info [N, 3]. Returns
    (predicted_cls_logits [N, S_fg+S, 1], predicted_bbox_pred [N, S_fg, 4],
    target_label [N, S_fg+S], target_bbox [N, S_fg, 4],
    bbox_inside_weight [N, S_fg, 4], label_weight [N, S_fg+S]) where
    S = rpn_batch_size_per_im, S_fg = round(S * fg_fraction). Slots are
    fixed capacity (fg slots first, then up to S - num_fg negatives);
    label_weight marks the valid samples — exactly S of them when enough
    candidates exist, fewer only when the image lacks candidates.
    Reference: rpn_target_assign_op.cc:490-560 + layers/detection.py:51.
    """
    helper = LayerHelper("rpn_target_assign")
    dt = anchor_box.dtype
    mk = lambda d: helper.create_variable_for_type_inference(
        d, stop_gradient=True)
    loc_index, score_index = mk("int32"), mk("int32")
    target_bbox, target_label = mk(dt), mk("int32")
    bbox_inside_weight, label_weight = mk("float32"), mk("float32")
    inputs = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op(
        type="rpn_target_assign",
        inputs=inputs,
        outputs={
            "LocIndex": [loc_index],
            "ScoreIndex": [score_index],
            "TargetBBox": [target_bbox],
            "TargetLabel": [target_label],
            "BBoxInsideWeight": [bbox_inside_weight],
            "LabelWeight": [label_weight],
        },
        attrs={
            "rpn_batch_size_per_im": rpn_batch_size_per_im,
            "rpn_straddle_thresh": rpn_straddle_thresh,
            "rpn_fg_fraction": rpn_fg_fraction,
            "rpn_positive_overlap": rpn_positive_overlap,
            "rpn_negative_overlap": rpn_negative_overlap,
            "use_random": use_random,
        },
    )
    # gather predictions at the sampled indices (-1 padding clamps to row 0
    # inside batched_gather; mask with the weight outputs)
    predicted_cls_logits = nn.batched_gather(cls_logits, score_index)
    predicted_bbox_pred = nn.batched_gather(bbox_pred, loc_index)
    return (predicted_cls_logits, predicted_bbox_pred, target_label,
            target_bbox, bbox_inside_weight, label_weight)


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """RPN proposal generation; fixed-capacity rois + per-image count.

    scores [N, A, H, W], bbox_deltas [N, 4A, H, W], anchors [H, W, A, 4].
    Returns (rpn_rois [N, post_nms_top_n, 4], rpn_roi_probs, rois_count [N]).
    Reference: generate_proposals_op.cc.
    """
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(
        scores.dtype, stop_gradient=True)
    probs = helper.create_variable_for_type_inference(
        scores.dtype, stop_gradient=True)
    count = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op(
        type="generate_proposals",
        inputs={
            "Scores": [scores],
            "BboxDeltas": [bbox_deltas],
            "ImInfo": [im_info],
            "Anchors": [anchors],
            "Variances": [variances],
        },
        outputs={
            "RpnRois": [rois],
            "RpnRoiProbs": [probs],
            "RpnRoisCount": [count],
        },
        attrs={
            "pre_nms_topN": pre_nms_top_n,
            "post_nms_topN": post_nms_top_n,
            "nms_thresh": nms_thresh,
            "min_size": min_size,
            "eta": eta,
        },
    )
    return rois, probs, count


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="polygon_box_transform",
        inputs={"Input": [input]},
        outputs={"Output": [out]},
    )
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             rois_batch=None, name=None):
    """Quantized max pooling over ROIs. rois [R, 4]; rois_batch [R] maps each
    roi to its image (the reference's ROI-LoD, densified).
    Reference: roi_pool_op.cc."""
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch]
    helper.append_op(
        type="roi_pool",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
            "spatial_scale": spatial_scale,
        },
    )
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
              sampling_ratio=-1, rois_batch=None, name=None):
    """Bilinear average pooling over ROIs. Reference: roi_align_op.cc."""
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch]
    helper.append_op(
        type="roi_align",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
            "spatial_scale": spatial_scale,
            "sampling_ratio": sampling_ratio,
        },
    )
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD multibox head: per-feature-map loc/conf convs + prior boxes.

    Returns (mbox_loc [N, total_priors, 4], mbox_conf [N, total_priors, C],
    boxes [total_priors, 4], variances [total_priors, 4]).
    Reference: layers/detection.py:1026 multi_box_head.
    """
    n_layer = len(inputs)
    if min_sizes is None:
        # derive sizes from the ratio range, as the SSD paper does
        assert n_layer > 2 and min_ratio is not None and max_ratio is not None
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) / (n_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes

    def _per_layer(v, i, default):
        if v is None:
            return default
        return v[i] if isinstance(v, (list, tuple)) else v

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        mx = max_sizes[i] if max_sizes else None
        ar = _per_layer(aspect_ratios, i, [1.0])
        if not isinstance(ar, (list, tuple)):
            ar = [ar]
        sw = _per_layer(step_w, i, _per_layer(steps, i, 0.0))
        sh = _per_layer(step_h, i, _per_layer(steps, i, 0.0))
        box, var = prior_box(
            feat, image, [ms] if not isinstance(ms, (list, tuple)) else ms,
            [mx] if mx is not None else None, ar, variance, flip, clip,
            steps=(sw or 0.0, sh or 0.0), offset=offset)
        box2 = nn.reshape(box, shape=[-1, 4])
        var2 = nn.reshape(var, shape=[-1, 4])
        boxes_all.append(box2)
        vars_all.append(var2)
        num_priors = int(box2.shape[0]) // (
            int(feat.shape[2]) * int(feat.shape[3]))

        loc = nn.conv2d(feat, num_filters=num_priors * 4,
                        filter_size=kernel_size, padding=pad, stride=stride)
        loc = nn.transpose(loc, perm=[0, 2, 3, 1])
        locs.append(nn.reshape(loc, shape=[0, -1, 4]))

        conf = nn.conv2d(feat, num_filters=num_priors * num_classes,
                         filter_size=kernel_size, padding=pad, stride=stride)
        conf = nn.transpose(conf, perm=[0, 2, 3, 1])
        confs.append(nn.reshape(conf, shape=[0, -1, num_classes]))

    mbox_loc = tensor.concat(locs, axis=1)
    mbox_conf = tensor.concat(confs, axis=1)
    boxes = tensor.concat(boxes_all, axis=0)
    variances = tensor.concat(vars_all, axis=0)
    return mbox_loc, mbox_conf, boxes, variances


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True):
    """Fast R-CNN RoI sampling (generate_proposal_labels_op.cc). Fixed
    capacity: S_fg + S slots per image (fg first), labels -1 on padding,
    with a RoisWeight mask marking valid samples. Returns (rois, labels,
    bbox_targets, bbox_inside_weights, bbox_outside_weights, rois_weight).
    """
    if class_nums is None:
        raise ValueError("generate_proposal_labels requires class_nums")
    helper = LayerHelper("generate_proposal_labels")
    mk = lambda d: helper.create_variable_for_type_inference(
        d, stop_gradient=True)
    rois = mk(rpn_rois.dtype)
    labels = mk("int32")
    targets, inw, outw, rw = mk("float32"), mk("float32"), mk("float32"), \
        mk("float32")
    inputs = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
              "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op(
        type="generate_proposal_labels",
        inputs=inputs,
        outputs={
            "Rois": [rois], "LabelsInt32": [labels],
            "BboxTargets": [targets], "BboxInsideWeights": [inw],
            "BboxOutsideWeights": [outw], "RoisWeight": [rw],
        },
        attrs={
            "batch_size_per_im": batch_size_per_im,
            "fg_fraction": fg_fraction,
            "fg_thresh": fg_thresh,
            "bg_thresh_hi": bg_thresh_hi,
            "bg_thresh_lo": bg_thresh_lo,
            "bbox_reg_weights": list(bbox_reg_weights),
            "class_nums": class_nums,
            "use_random": use_random,
        },
    )
    return rois, labels, targets, inw, outw, rw


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_batch=None, name=None):
    """Perspective-warp quadrilateral ROIs [R, 8] to a fixed rectangle
    (roi_perspective_transform_op.cc, EAST-style text recognition)."""
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch]
    helper.append_op(
        type="roi_perspective_transform",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={
            "transformed_height": transformed_height,
            "transformed_width": transformed_width,
            "spatial_scale": spatial_scale,
        },
    )
    return out
