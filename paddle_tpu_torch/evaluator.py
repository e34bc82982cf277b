"""In-program evaluators with accumulated state.

Reference parity: python/paddle/fluid/evaluator.py — each Evaluator builds
its metric op into the main program plus persistable state variables, and
offers ``reset(executor)`` / ``eval(executor)`` across minibatches. (The
reference marks this module deprecated in favor of fluid.metrics; both
surfaces exist here too — paddle_tpu_torch.metrics holds the host-side
accumulators, this module the in-program ones.)

Counterpart of ``paddle_tpu/evaluator.py``: the states are built with
the port's layers over its ``chunk_eval``, ``edit_distance`` and
``detection_map`` ops, and accumulate on the host between runs (the
fetched per-batch counts are added into numpy accumulators), as in the
JAX package; reset() zeroes the host accumulator.
"""

import numpy as np

from paddle_tpu_torch import layers

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP"]


class Evaluator(object):
    """Base: subclasses expose .metrics (vars to fetch per batch) and
    fold fetched values into host state via update()."""

    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self, executor=None):
        raise NotImplementedError

    def eval(self, executor=None):
        raise NotImplementedError


class ChunkEvaluator(Evaluator):
    """Accumulated chunk P/R/F1 (evaluator.py:126 ChunkEvaluator).

    Build inside a program:
        ev = fluid.evaluator.ChunkEvaluator(input, label, "IOB", 3)
        ...
        counts = exe.run(main, feed=..., fetch_list=ev.metrics)
        ev.update(counts)
        precision, recall, f1 = ev.eval()
    """

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, length=None):
        super(ChunkEvaluator, self).__init__()
        (precision, recall, f1, num_infer, num_label,
         num_correct) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types, length=length)
        self.batch_metrics = [precision, recall, f1]
        self.metrics = [num_infer, num_label, num_correct]
        self.reset()

    def reset(self, executor=None):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, counts):
        num_infer, num_label, num_correct = (
            int(np.ravel(np.asarray(c))[0]) for c in counts)
        self.num_infer_chunks += num_infer
        self.num_label_chunks += num_label
        self.num_correct_chunks += num_correct

    def eval(self, executor=None):
        precision = (
            self.num_correct_chunks / self.num_infer_chunks
            if self.num_infer_chunks else 0.0)
        recall = (
            self.num_correct_chunks / self.num_label_chunks
            if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(Evaluator):
    """Accumulated average edit distance + instance-error rate
    (evaluator.py:217 EditDistance)."""

    def __init__(self, input, label, normalized=True, input_length=None,
                 label_length=None):
        super(EditDistance, self).__init__()
        distances, seq_num = layers.edit_distance(
            input=input, label=label, normalized=normalized,
            input_length=input_length, label_length=label_length)
        self.metrics = [distances, seq_num]
        self.reset()

    def reset(self, executor=None):
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, fetched):
        distances, seq_num = fetched
        d = np.ravel(np.asarray(distances))
        self.total_distance += float(d.sum())
        self.seq_num += int(np.ravel(np.asarray(seq_num))[0])
        self.instance_error += int((d > 0).sum())

    def eval(self, executor=None):
        if not self.seq_num:
            return 0.0, 0.0
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class DetectionMAP(Evaluator):
    """Accumulated detection mAP (evaluator.py:298 DetectionMAP).

    Unlike ChunkEvaluator/EditDistance, update() takes the raw padded
    arrays, not the fetched ``.metrics`` list — the ground truth is the
    caller's own feed and the detections come from fetching the
    detection-output var the evaluator was built on:

        m_ap_var = ev.cur_map            # per-batch mAP, in-graph
        (dets,) = exe.run(main, feed=f, fetch_list=[detect_res_var])
        ev.update(dets, f["gt_label"], f["gt_box"])
        epoch_map = ev.eval()
    """

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral"):
        super(DetectionMAP, self).__init__()
        from paddle_tpu_torch import metrics as metrics_mod

        self.cur_map = layers.detection_map(
            input, gt_label, gt_box, gt_difficult=gt_difficult,
            class_num=class_num, background_label=background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version)
        # fetch these + the raw inputs' values to accumulate
        self.metrics = [self.cur_map]
        self._accum = metrics_mod.DetectionMAP(
            class_num=class_num, overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version,
            background_label=background_label)

    def reset(self, executor=None):
        self._accum.reset()

    def update(self, detections, gt_labels, gt_boxes, difficult=None):
        self._accum.update(detections, gt_labels, gt_boxes, difficult)

    def eval(self, executor=None):
        return self._accum.eval()
