"""Edge-classification metrics (reference utils/metrics.py + train.py:23-54).

numpy implementations (no torch/sklearn in the framework path): confusion
counts at sigmoid >= 0.5, accuracy/precision/recall/F1 and the label-inverted
variants, FPR/FNR, precision-recall curves and average precision (the
reference's "AUC", utils/metrics.py:67-80).
"""
from __future__ import annotations

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def calculate_tfpn(logits, labels):
    """(TP, TN, FP, FN) at round(sigmoid(logit)) (utils/metrics.py:6-12)."""
    pred = np.round(_sigmoid(logits)).astype(np.int8)
    labels = np.asarray(labels)
    tp = int(np.sum((pred == 1) & (labels == 1)))
    tn = int(np.sum((pred == 0) & (labels == 0)))
    fp = int(np.sum((pred == 1) & (labels == 0)))
    fn = int(np.sum((pred == 0) & (labels == 1)))
    return tp, tn, fp, fn


def calculate_metrics(tp, tn, fp, fn):
    precision = tp / (tp + fp) if (tp + fp) else 0
    recall = tp / (tp + fn) if (tp + fn) else 0
    f1 = tp / (tp + 0.5 * (fp + fn)) if (tp + 0.5 * (fp + fn)) else 0
    accuracy = (tp + tn) / (tp + tn + fp + fn)
    return accuracy, precision, recall, f1


def calculate_metrics_inverse(tp, tn, fp, fn):
    """Metrics with the positive class inverted (utils/metrics.py:32-48)."""
    return calculate_metrics(tn, tp, fn, fp)


def compute_fp_fn_rates(tp, tn, fp, fn):
    fp_rate = fp / (fp + tn) if (fp + tn) else 0.0
    fn_rate = fn / (fn + tp) if (fn + tp) else 0.0
    return fp_rate, fn_rate


def compute_metrics(logits, labels, loss: float) -> dict:
    """Per-graph/partition metric dict (reference train.py:30-54), plus the
    threshold-free AP.  With pos_weight = 1/(pos:neg) on the ~85%-positive
    assembly graphs, the loss optimum pins uninformative edges at p=0.5, so
    threshold-0.5 metrics swing wildly early in training while ranking
    quality improves monotonically — AP is the signal that matters (the
    reference has the helper, utils/metrics.py:67-71, but never logs it)."""
    tp, tn, fp, fn = calculate_tfpn(logits, labels)
    acc, precision, recall, f1 = calculate_metrics(tp, tn, fp, fn)
    acc_i, precision_i, recall_i, f1_i = calculate_metrics_inverse(tp, tn, fp, fn)
    fp_rate, fn_rate = compute_fp_fn_rates(tp, tn, fp, fn)
    return {
        "loss": loss, "fp_rate": fp_rate, "fn_rate": fn_rate,
        "acc": acc, "precision": precision, "recall": recall, "f1": f1,
        "acc_inv": acc_i, "precision_inv": precision_i,
        "recall_inv": recall_i, "f1_inv": f1_i,
        "ap": get_aps(logits, labels),
    }


def average_epoch_metrics(metric_dicts: list[dict]) -> dict:
    keys = metric_dicts[0].keys()
    return {k: float(np.mean([m[k] for m in metric_dicts])) for k in keys}


def precision_recall_curve(preds, labels, pos_label=1):
    """(precision, recall, thresholds) — sklearn-compatible ordering
    (utils/metrics.py:51-63 uses sklearn's)."""
    preds = np.asarray(preds, dtype=np.float64)
    labels = (np.asarray(labels) == pos_label).astype(np.int64)
    order = np.argsort(-preds, kind="stable")
    preds_s, labels_s = preds[order], labels[order]
    # collapse duplicate thresholds: keep last index of each distinct value
    distinct = np.nonzero(np.diff(preds_s))[0]
    idx = np.concatenate([distinct, [preds_s.size - 1]])
    tp = np.cumsum(labels_s)[idx]
    fp = (idx + 1) - tp
    precision = tp / (tp + fp)
    total_pos = labels.sum()
    recall = tp / total_pos if total_pos else np.zeros_like(tp, dtype=np.float64)
    # trim after full recall, then append the (1, 0) endpoint, reversed order
    last = tp.searchsorted(tp[-1]) if tp.size else 0
    sl = slice(None, last + 1)
    precision = np.hstack([precision[sl][::-1], 1.0])
    recall = np.hstack([recall[sl][::-1], 0.0])
    thresholds = preds_s[idx][sl][::-1]
    return precision, recall, thresholds


def average_precision(preds, labels, pos_label=1) -> float:
    """AP = sum((R_n - R_{n+1}) * P_n) over the PR curve
    (the reference's get_aps, utils/metrics.py:67-71)."""
    precision, recall, _ = precision_recall_curve(preds, labels, pos_label)
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def get_aps(logits, labels) -> float:
    return average_precision(_sigmoid(logits), labels, pos_label=1)


def get_aps_inverse(logits, labels) -> float:
    return average_precision(1.0 - _sigmoid(logits), labels, pos_label=0)
