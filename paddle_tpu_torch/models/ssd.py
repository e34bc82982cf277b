"""SSD-style single-shot detector on a small VGG-ish backbone.

Counterpart of ``paddle_tpu/models/ssd.py`` (the same build: the SSD
recipe of the reference's detection layers, multi_box_head + ssd_loss,
scaled down): dense padded ground truth [N, G, 4] / [N, G],
fixed-capacity NMS for the eval head.
"""

import paddle_tpu_torch as fluid


def _backbone(img):
    """Three stride-2 stages; the last two feed the multibox head."""
    c1 = fluid.layers.conv2d(img, 32, 3, stride=2, padding=1, act="relu")
    c1 = fluid.layers.conv2d(c1, 32, 3, padding=1, act="relu")
    c2 = fluid.layers.conv2d(c1, 64, 3, stride=2, padding=1, act="relu")
    c2 = fluid.layers.conv2d(c2, 64, 3, padding=1, act="relu")
    c3 = fluid.layers.conv2d(c2, 128, 3, stride=2, padding=1, act="relu")
    return c2, c3


def build(img_shape=(3, 96, 96), class_num=4, max_gt=8,
          nms_keep_top_k=50, score_threshold=0.01):
    """Returns (loss, feeds, extras). Feeds: image [N,C,H,W], gt_box
    [N, max_gt, 4] zero-padded, gt_label [N, max_gt] int32. Extras carry
    the eval head: nmsed_out [N, keep_top_k, 6] and map_eval (detection
    mAP for the batch)."""
    img = fluid.layers.data("image", list(img_shape))
    gt_box = fluid.layers.data("gt_box", [max_gt, 4])
    gt_label = fluid.layers.data("gt_label", [max_gt], dtype="int32")

    f2, f3 = _backbone(img)
    size = img_shape[-1]
    locs, confs, boxes, variances = fluid.layers.multi_box_head(
        inputs=[f2, f3],
        image=img,
        base_size=size,
        num_classes=class_num,
        aspect_ratios=[[1.0, 2.0], [1.0, 2.0]],
        min_sizes=[size * 0.2, size * 0.5],
        max_sizes=[size * 0.5, size * 0.8],
        flip=True,
        clip=True,
    )

    loss = fluid.layers.ssd_loss(locs, confs, gt_box, gt_label,
                                 boxes, variances)
    loss = fluid.layers.mean(loss)

    nmsed_out = fluid.layers.detection_output(
        locs, confs, boxes, variances,
        score_threshold=score_threshold, keep_top_k=nms_keep_top_k)
    map_eval = fluid.layers.detection_map(
        nmsed_out, gt_label, gt_box, class_num=class_num)

    return loss, [img, gt_box, gt_label], {
        "nmsed_out": nmsed_out,
        "map_eval": map_eval,
        "mbox_locs": locs,
        "mbox_confs": confs,
    }
