"""In-graph metric ops: accuracy, auc, chunk_eval, precision_recall,
mean_iou and positive_negative_pair.

Counterpart of ``paddle_tpu/ops/metric_ops.py`` (accuracy_op.cc,
auc_op.cc, chunk_eval_op.cc, precision_recall_op.cc, mean_iou_op.cc,
positive_negative_pair_op.h parity), with the JAX package's state
outputs. Integer counts are int64 (the JAX package narrows them to
int32), float64 stays float64. Nothing here reads a value back to the
host: one-hot rows are comparisons, histograms ``scatter_add``s.
"""

import torch

from paddle_tpu_torch.core.op_registry import register_op
from paddle_tpu_torch.core.types import device_dtype
from paddle_tpu_torch.ops.common import optional_lengths


def _lower_accuracy(ctx, ins, attrs):
    indices, label = ins["Indices"][0], ins["Label"][0]
    if label.dim() > 1 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    hit = (indices == label[:, None].to(indices.dtype)).any(dim=1)
    correct = hit.sum().to(torch.int32).reshape(1)
    total = torch.full((1,), indices.shape[0], dtype=torch.int32,
                       device=indices.device)
    return {"Accuracy": correct.float() / total.float(), "Correct": correct,
            "Total": total}


register_op(
    "accuracy",
    inputs=["Out", "Indices", "Label"],
    outputs=["Accuracy", "Correct", "Total"],
    lower=_lower_accuracy,
    grad=None,
)


def _one_hot(v, n, dtype):
    """``[N, n]`` one-hot rows of the int vector ``v`` (a comparison, so
    the card reads no value back, as ``F.one_hot`` would to check the
    range)."""
    return (v[:, None] == torch.arange(n, device=v.device)[None, :]).to(dtype)


def _lower_auc(ctx, ins, attrs):
    """auc_op.cc: the threshold buckets' confusion counts, accumulated
    into the state outputs (bound to the same persistable variables by
    ``layers.auc``), and the ROC area from them."""
    preds, label = ins["Predict"][0], ins["Label"][0]
    nt = int(attrs.get("num_thresholds", 200))
    pos_prob = preds[:, 1] if preds.dim() == 2 else preds.reshape(-1)
    lbl = label.reshape(-1).to(torch.bool)
    bucket = (pos_prob * nt).to(torch.int32).clamp(0, nt - 1).to(torch.int64)
    idt = device_dtype("int64")
    zero = torch.zeros((nt,), dtype=idt, device=preds.device)
    stat_pos = ins["StatPos"][0] + zero.scatter_add(0, bucket, lbl.to(idt))
    stat_neg = ins["StatNeg"][0] + zero.scatter_add(0, bucket,
                                                    (~lbl).to(idt))
    fdt = device_dtype("float64")
    tp = torch.flip(torch.cumsum(torch.flip(stat_pos, [0]), 0), [0]).to(fdt)
    fp = torch.flip(torch.cumsum(torch.flip(stat_neg, [0]), 0), [0]).to(fdt)
    tpr = tp / torch.clamp_min(tp[0], 1.0)
    fpr = fp / torch.clamp_min(fp[0], 1.0)
    auc = ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()
    return {"AUC": auc.to(torch.float32).reshape(1), "StatPosOut": stat_pos,
            "StatNegOut": stat_neg}


register_op(
    "auc",
    inputs=["Predict", "Label", "StatPos", "StatNeg"],
    outputs=["AUC", "StatPosOut", "StatNegOut"],
    attrs={"curve": "ROC", "num_thresholds": 200},
    lower=_lower_auc,
    grad=None,
)


def _chunk_flags(tags, lens, num_chunk_types, scheme):
    """Per position (inside, begin, end, type) of a tag grid ``[B, T]``
    (metric_ops.py ``_chunk_flags``; tag = chunk_type * num_tag_types +
    tag_type, ids at or above num_chunk_types * num_tag_types are
    outside)."""
    n_tag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    b, t = tags.shape
    dev = tags.device
    valid = torch.arange(t, device=dev)[None, :] < lens[:, None]
    inside = valid & (tags >= 0) & (tags < num_chunk_types * n_tag)
    minus = torch.full_like(tags, -1)
    ctype = torch.where(inside, torch.div(tags, n_tag, rounding_mode="floor"),
                        minus)
    tag_type = torch.where(inside, torch.remainder(tags, n_tag), minus)
    none = torch.zeros_like(inside)
    if scheme == "plain":
        b_mark, e_mark = inside, inside
    elif scheme == "IOB":
        b_mark, e_mark = tag_type == 0, none
    elif scheme == "IOE":
        b_mark, e_mark = none, tag_type == 1
    else:  # IOBES
        b_mark = (tag_type == 0) | (tag_type == 3)
        e_mark = (tag_type == 2) | (tag_type == 3)
    f_col = torch.zeros((b, 1), dtype=torch.bool, device=dev)
    t_col = torch.full((b, 1), -2, dtype=tags.dtype, device=dev)

    def before(x, fill):
        return torch.cat([fill, x[:, :-1]], 1)

    def after(x, fill):
        return torch.cat([x[:, 1:], fill], 1)

    begin = inside & (b_mark | ~before(inside, f_col)
                      | (before(ctype, t_col) != ctype)
                      | before(e_mark, f_col))
    end = inside & (e_mark | ~after(inside, f_col)
                    | (after(ctype, t_col) != ctype) | after(b_mark, f_col))
    return inside, begin, end, ctype


def _next_end(end):
    """For each position, the first position at or after it that ends a
    chunk (``T`` where none does)."""
    t = end.shape[1]
    at = torch.where(end, torch.arange(t, device=end.device)[None, :],
                     torch.full_like(end, t, dtype=torch.int64))
    return torch.flip(torch.cummin(torch.flip(at, [1]), 1).values, [1])


def _lower_chunk_eval(ctx, ins, attrs):
    """chunk_eval_op.cc: precision, recall and F1 over chunks. A matched
    chunk is a label chunk and an inferred chunk that begin together,
    share a type and end together. The JAX op finds them with a scan
    carrying an aligned-chunk flag (``metric_ops.py:159-175``); here,
    without a loop: chunks begin after an end, so a chunk pair opened at
    ``t`` stays aligned exactly until the first end on either side, and
    it matches when both sides' first ends at or after ``t`` coincide."""
    inf_t = ins["Inference"][0]
    lab_t = ins["Label"][0]
    inf = inf_t.reshape(inf_t.shape[0], -1).to(torch.int64)
    lab = lab_t.reshape(lab_t.shape[0], -1).to(torch.int64)
    lens = optional_lengths(ins, inf)
    scheme = attrs.get("chunk_scheme", "IOB")
    nct = int(attrs.get("num_chunk_types", 1))
    excluded = list(attrs.get("excluded_chunk_types", []))
    l_in, l_b, l_e, l_t = _chunk_flags(lab, lens, nct, scheme)
    p_in, p_b, p_e, p_t = _chunk_flags(inf, lens, nct, scheme)
    if excluded:
        ex = torch.tensor(excluded, dtype=torch.int64, device=inf.device)
        l_ok, p_ok = ~torch.isin(l_t, ex), ~torch.isin(p_t, ex)
        l_b, l_e = l_b & l_ok, l_e & l_ok
        p_b, p_e = p_b & p_ok, p_e & p_ok
    both_begin = l_b & p_b & (l_t == p_t)
    idt = device_dtype("int64")
    num_correct = (both_begin & (_next_end(l_e) == _next_end(p_e))).sum() \
        .to(idt)
    num_label = l_b.sum().to(idt)
    num_infer = p_b.sum().to(idt)
    zero = torch.zeros((), dtype=torch.float32, device=inf.device)
    precision = torch.where(
        num_infer > 0, num_correct / torch.clamp_min(num_infer, 1),
        zero).to(torch.float32)
    recall = torch.where(
        num_label > 0, num_correct / torch.clamp_min(num_label, 1),
        zero).to(torch.float32)
    f1 = torch.where(
        precision + recall > 0,
        2 * precision * recall / torch.clamp_min(precision + recall, 1e-12),
        zero).to(torch.float32)
    return {
        "Precision": precision[None], "Recall": recall[None],
        "F1-Score": f1[None], "NumInferChunks": num_infer[None],
        "NumLabelChunks": num_label[None],
        "NumCorrectChunks": num_correct[None],
    }


register_op(
    "chunk_eval",
    inputs=["Inference", "Label", "Length"],
    outputs=["Precision", "Recall", "F1-Score", "NumInferChunks",
             "NumLabelChunks", "NumCorrectChunks"],
    attrs={"num_chunk_types": 1, "chunk_scheme": "IOB",
           "excluded_chunk_types": []},
    lower=_lower_chunk_eval,
    grad=None,
)


def _pr_metrics(st):
    """[macro-P, macro-R, macro-F1, micro-P, micro-R, micro-F1] of the
    per-class [TP, FP, TN, FN] states (precision_recall_op.h: a class
    with no prediction or no instance scores 1.0; macro-F1 from the macro
    averages)."""
    stp, sfp, sfn = st[:, 0], st[:, 1], st[:, 3]
    one = torch.ones((), dtype=st.dtype, device=st.device)
    zero = torch.zeros((), dtype=st.dtype, device=st.device)

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp_min(den, 1e-10), one)

    def f1(p, r):
        return torch.where(p + r > 0, 2 * p * r / torch.clamp_min(
            p + r, 1e-10), zero)

    macro_p = ratio(stp, stp + sfp).mean()
    macro_r = ratio(stp, stp + sfn).mean()
    mtp, mfp, mfn = stp.sum(), sfp.sum(), sfn.sum()
    micro_p, micro_r = ratio(mtp, mtp + mfp), ratio(mtp, mtp + mfn)
    return torch.stack([macro_p, macro_r, f1(macro_p, macro_r), micro_p,
                        micro_r, f1(micro_p, micro_r)])


def _lower_precision_recall(ctx, ins, attrs):
    """precision_recall_op.cc: per sample with predicted class p, gold
    class l, weight w: p == l adds w to TP[l]; else to FP[p] and FN[l];
    the classes not involved get w in TN. The batch's and the
    accumulated metrics, and the accumulated ``[C, 4]`` states."""
    idx = ins["Indices"][0].reshape(-1)
    label = ins["Labels"][0].reshape(-1)
    c = int(attrs["class_number"])
    if ins.get("Weights"):
        w = ins["Weights"][0].reshape(-1).to(torch.float32)
    else:
        w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    one_p = _one_hot(idx, c, torch.float32)
    one_l = _one_hot(label, c, torch.float32)
    correct = (idx == label).to(torch.float32) * w
    wrong = (idx != label).to(torch.float32) * w
    tp = (one_l * correct[:, None]).sum(0)
    fp = (one_p * wrong[:, None]).sum(0)
    fn = (one_l * wrong[:, None]).sum(0)
    tn = ((1.0 - torch.clamp(one_p + one_l, 0.0, 1.0)) * w[:, None]).sum(0)
    batch = torch.stack([tp, fp, tn, fn], 1)
    accum = batch + ins["StatesInfo"][0].to(torch.float32) \
        if ins.get("StatesInfo") else batch
    return {"BatchMetrics": _pr_metrics(batch),
            "AccumMetrics": _pr_metrics(accum), "AccumStatesInfo": accum}


register_op(
    "precision_recall",
    inputs=["MaxProbs", "Indices", "Labels", "Weights", "StatesInfo"],
    outputs=["BatchMetrics", "AccumMetrics", "AccumStatesInfo"],
    attrs={"class_number": 2},
    lower=_lower_precision_recall,
    grad=None,
)


def _lower_mean_iou(ctx, ins, attrs):
    """mean_iou_op.cc: per element a hit adds to Correct[label], a miss
    to Wrong[label] and Wrong[pred]; the In* accumulators are added; the
    mean IoU over the classes with a nonzero union."""
    n = int(attrs["num_classes"])
    pred = ins["Predictions"][0].reshape(-1)
    label = ins["Labels"][0].reshape(-1)
    hit = (pred == label).to(torch.int32)[:, None]
    miss = 1 - hit
    correct = (_one_hot(label, n, torch.int32) * hit).sum(0, dtype=torch.int32)
    wrong = ((_one_hot(label, n, torch.int32) * miss).sum(0, dtype=torch.int32)
             + (_one_hot(pred, n, torch.int32) * miss).sum(0,
                                                         dtype=torch.int32))
    for extra in ins.get("InCorrects", []):
        correct = correct + extra.to(torch.int32)
    for extra in ins.get("InWrongs", []):
        wrong = wrong + extra.to(torch.int32)
    union = correct + wrong
    valid = union > 0
    iou = torch.where(valid, correct / torch.clamp_min(union, 1).to(
        torch.float32), torch.zeros((), device=union.device))
    mean = (iou.sum() / torch.clamp_min(valid.to(torch.float32).sum(),
                                        1.0)).reshape(1)
    for extra in ins.get("InMeanIou", []):
        mean = mean + extra.reshape(1)
    return {"OutMeanIou": mean, "OutWrong": wrong, "OutCorrect": correct}


register_op(
    "mean_iou",
    inputs=["Predictions", "Labels", "*InWrongs", "*InCorrects",
            "*InMeanIou"],
    outputs=["OutMeanIou", "OutWrong", "OutCorrect"],
    attrs={"num_classes": 2},
    lower=_lower_mean_iou,
    grad=None,
)


def _lower_positive_negative_pair(ctx, ins, attrs):
    """positive_negative_pair_op.h: over the item pairs of one query
    whose labels differ, a pair (weighted by the mean of the two rows'
    weights) is positive when score and label agree in order, negative
    otherwise; a score tie counts as negative and as neutral."""
    score = ins["Score"][0][:, attrs.get("column", -1)]
    label = ins["Label"][0].reshape(-1).to(score.dtype)
    query = ins["QueryID"][0].reshape(-1)
    if ins.get("Weight"):
        weight = ins["Weight"][0].reshape(-1).to(score.dtype)
    else:
        weight = torch.ones_like(score)
    n = score.shape[0]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=score.device), diagonal=1)
    consider = upper & (query[:, None] == query[None, :]) & (
        label[:, None] != label[None, :])
    w = (weight[:, None] + weight[None, :]) * 0.5
    sd = score[:, None] - score[None, :]
    agree = sd * (label[:, None] - label[None, :]) > 0
    zero = torch.zeros_like(w)
    pos = torch.where(consider & agree, w, zero).sum()
    neg = torch.where(consider & ~agree, w, zero).sum()
    neu = torch.where(consider & (sd == 0), w, zero).sum()
    if ins.get("AccumulatePositivePair"):
        pos = pos + ins["AccumulatePositivePair"][0].reshape(())
    if ins.get("AccumulateNegativePair"):
        neg = neg + ins["AccumulateNegativePair"][0].reshape(())
    if ins.get("AccumulateNeutralPair"):
        neu = neu + ins["AccumulateNeutralPair"][0].reshape(())
    return {"PositivePair": pos.reshape(1), "NegativePair": neg.reshape(1),
            "NeutralPair": neu.reshape(1)}


register_op(
    "positive_negative_pair",
    inputs=["Score", "Label", "QueryID", "AccumulatePositivePair",
            "AccumulateNegativePair", "AccumulateNeutralPair", "Weight"],
    outputs=["PositivePair", "NegativePair", "NeutralPair"],
    attrs={"column": -1},
    lower=_lower_positive_negative_pair,
    grad=None,
)
