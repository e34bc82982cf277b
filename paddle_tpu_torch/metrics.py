"""Python-side metric accumulators (python/paddle/fluid/metrics.py parity).

Counterpart of ``paddle_tpu/metrics.py``: numpy only, a copy of the JAX
package's accumulators, so both packages give equal results on equal
inputs.
"""

import numpy as np

__all__ = [
    "MetricBase",
    "CompositeMetric",
    "Precision",
    "Recall",
    "Accuracy",
    "ChunkEvaluator",
    "EditDistance",
    "Auc",
    "DetectionMAP",
]


class MetricBase(object):
    def __init__(self, name):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        """Zero every public accumulator in place. Subclasses keep their
        running state as public attributes, so the base reset can restart
        an epoch without knowing each metric's fields: numbers restart at
        zero, arrays at zeros of the same shape, anything else is cleared."""
        for attr in list(vars(self)):
            if attr.startswith("_"):
                continue
            value = getattr(self, attr)
            if callable(value):
                continue
            if isinstance(value, np.ndarray):
                fresh = np.zeros_like(value)
            elif isinstance(value, (int, float)):
                fresh = type(value)(0)
            else:
                fresh = None
            setattr(self, attr, fresh)

    def update(self, preds, labels):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super(CompositeMetric, self).__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super(Precision, self).__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super(Recall, self).__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super(Accuracy, self).__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated into Accuracy")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super(ChunkEvaluator, self).__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(
            np.asarray(num_correct_chunks).reshape(-1)[0]
        )

    def eval(self):
        precision = (
            float(self.num_correct_chunks) / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            float(self.num_correct_chunks) / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1 = (
            2 * precision * recall / (precision + recall)
            if self.num_correct_chunks
            else 0.0
        )
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super(EditDistance, self).__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data updated into EditDistance")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super(Auc, self).__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        for i, label in enumerate(labels):
            pos_prob = preds[i, 1] if preds.ndim == 2 else preds[i]
            bin_idx = int(pos_prob * self._num_thresholds)
            if label:
                self._stat_pos[bin_idx] += 1.0
            else:
                self._stat_neg[bin_idx] += 1.0

    @staticmethod
    def trapezoid_area(x1, x2, y1, y2):
        return abs(x1 - x2) * (y1 + y2) / 2.0

    def eval(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        idx = self._num_thresholds
        while idx >= 0:
            tot_pos_prev = tot_pos
            tot_neg_prev = tot_neg
            tot_pos += self._stat_pos[idx]
            tot_neg += self._stat_neg[idx]
            auc += self.trapezoid_area(
                tot_neg, tot_neg_prev, tot_pos, tot_pos_prev
            )
            idx -= 1
        return (
            auc / tot_pos / tot_neg if tot_pos > 0.0 and tot_neg > 0.0 else 0.0
        )


class DetectionMAP(MetricBase):
    """Accumulative mean-Average-Precision across batches (host side).

    Reference parity: python/paddle/fluid/metrics.py DetectionMAP /
    detection_map_op.cc accumulative states. The in-graph
    ``layers.detection_map`` op scores ONE batch; this class accumulates
    padded detections + dense ground truth over many batches and computes
    the epoch mAP with the same greedy-matching + integral/11point rules.

    update() takes the padded-batch layout (docs/LOD_DESIGN.md):
      detections [N, D, 6] (label, score, x1, y1, x2, y2), label -1 pads;
      gt_labels [N, G] int with -1 pads; gt_boxes [N, G, 4];
      difficult [N, G] optional.
    """

    def __init__(self, name=None, class_num=None, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral",
                 background_label=0):
        super(DetectionMAP, self).__init__(name)
        if class_num is None:
            raise ValueError("DetectionMAP requires class_num")
        self._class_num = class_num
        self._overlap_threshold = overlap_threshold
        self._evaluate_difficult = evaluate_difficult
        self._ap_version = ap_version
        self._background_label = background_label
        self.reset()

    def reset(self):
        # per image: (det [d,6], gt_label [g], gt_box [g,4], difficult [g])
        self._images = []

    def update(self, detections, gt_labels, gt_boxes, difficult=None):
        det = np.asarray(detections)
        gl = np.asarray(gt_labels)
        gb = np.asarray(gt_boxes)
        dif = (np.asarray(difficult) if difficult is not None
               else np.zeros_like(gl, dtype=np.float64))
        for i in range(det.shape[0]):
            dv = det[i][det[i, :, 0] >= 0]
            keep = gl[i] >= 0
            self._images.append(
                (dv.copy(), gl[i][keep].copy(), gb[i][keep].copy(),
                 dif[i][keep].astype(bool).copy()))

    @staticmethod
    def _iou(a, b):
        area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(
            a[:, 3] - a[:, 1], 0)
        area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
            b[:, 3] - b[:, 1], 0)
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.maximum(rb - lt, 0)
        inter = wh[..., 0] * wh[..., 1]
        return inter / np.maximum(
            area_a[:, None] + area_b[None, :] - inter, 1e-10)

    def eval(self):
        thr = self._overlap_threshold
        aps = []
        for cls in range(self._class_num):
            if cls == self._background_label:
                continue
            # gather this class's detections (img idx, score, box) and gts
            rows = []
            n_pos = 0
            per_img_gt = []
            for img, (det, gl, gb, dif) in enumerate(self._images):
                sel = gl == cls
                countable = sel & (np.ones_like(sel)
                                   if self._evaluate_difficult else ~dif)
                n_pos += int(countable.sum())
                per_img_gt.append((gb[sel], dif[sel]))
                for d in det[det[:, 0].astype(int) == cls]:
                    rows.append((img, d[1], d[2:6]))
            if n_pos == 0:
                continue
            rows.sort(key=lambda r: -r[1])
            matched = [np.zeros(g.shape[0], bool) for g, _ in per_img_gt]
            tp, fp = [], []
            for img, _score, box in rows:
                g, dif = per_img_gt[img]
                if g.shape[0] == 0:
                    tp.append(0.0)
                    fp.append(1.0)
                    continue
                overlaps = self._iou(box[None], g)[0]
                best = int(np.argmax(overlaps))
                covered = overlaps[best] >= thr
                if covered and not self._evaluate_difficult and dif[best]:
                    continue  # ignored: neither TP nor FP
                hit = covered and not matched[img][best]
                if hit:
                    matched[img][best] = True
                tp.append(1.0 if hit else 0.0)
                fp.append(0.0 if hit else 1.0)
            if not tp:
                aps.append(0.0)
                continue
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            precision = ctp / np.maximum(ctp + cfp, 1e-10)
            recall = ctp / n_pos
            if self._ap_version == "11point":
                ap = sum(
                    float(np.max(precision[recall >= r], initial=0.0))
                    for r in np.arange(0.0, 1.1, 0.1)
                ) / 11.0
            else:
                prev = np.concatenate([[0.0], recall[:-1]])
                ap = float(np.sum((recall - prev) * precision))
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0
