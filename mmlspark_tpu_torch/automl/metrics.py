"""Metric computation — the port's copy of ``mmlspark_tpu/automl/metrics.py``
(reference: core/metrics MetricConstants.scala:7-30 +
compute-model-statistics ComputeModelStatistics.scala:110-160). Host numpy
only: the port imports no sklearn."""

from __future__ import annotations

import numpy as np


class MetricConstants:
    AccuracySparkMetric = "accuracy"
    PrecisionSparkMetric = "precision"
    RecallSparkMetric = "recall"
    AucSparkMetric = "AUC"
    F1SparkMetric = "f1"
    MseSparkMetric = "mse"
    RmseSparkMetric = "rmse"
    R2SparkMetric = "r2"
    MaeSparkMetric = "mae"
    AllSparkMetrics = "all"

CLASSIFICATION_METRICS = {"accuracy", "precision", "recall", "AUC", "f1"}
REGRESSION_METRICS = {"mse", "rmse", "r2", "mae"}
# larger-is-better? (EvaluationUtils.getMetricWithOperator analog)
METRIC_MAXIMIZE = {"accuracy": True, "precision": True, "recall": True,
                   "AUC": True, "f1": True,
                   "mse": False, "rmse": False, "r2": True, "mae": False}


def auc_score(y_true: np.ndarray, score: np.ndarray) -> float:
    """Binary AUC via the rank statistic (ties averaged)."""
    y = np.asarray(y_true).astype(np.int64)
    s = np.asarray(score).astype(np.float64)
    n_pos = int((y == 1).sum())
    n_neg = int((y == 0).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), dtype=np.float64)
    sorted_s = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def roc_points(y_true: np.ndarray, score: np.ndarray):
    """(fpr, tpr) arrays swept over every distinct score threshold, for ROC
    plotting (plot.py) — same statistic auc_score integrates."""
    y = np.asarray(y_true).astype(np.int64)
    s = np.asarray(score).astype(np.float64)
    if len(s) == 0:
        return np.array([0.0, 1.0]), np.array([0.0, 1.0])
    order = np.argsort(-s, kind="mergesort")
    y = y[order]
    s = s[order]
    tps = np.cumsum(y == 1).astype(np.float64)
    fps = np.cumsum(y == 0).astype(np.float64)
    # keep only the last point of each tied-threshold run
    keep = np.r_[s[1:] != s[:-1], True]
    tps, fps = tps[keep], fps[keep]
    n_pos = max(tps[-1] if len(tps) else 0.0, 1.0)
    n_neg = max(fps[-1] if len(fps) else 0.0, 1.0)
    tpr = np.r_[0.0, tps / n_pos]
    fpr = np.r_[0.0, fps / n_neg]
    return fpr, tpr


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    y = np.asarray(y_true).astype(np.int64)
    p = np.asarray(y_pred).astype(np.int64)
    k = int(max(y.max(), p.max())) + 1
    cm = np.zeros((k, k), dtype=np.int64)
    np.add.at(cm, (y, p), 1)
    return cm


def classification_metrics(y_true, y_pred, prob=None) -> dict:
    """accuracy/precision/recall/f1 (+AUC for binary with probabilities) +
    confusion matrix. Multiclass precision/recall are macro-averaged."""
    cm = confusion_matrix(y_true, y_pred)
    k = cm.shape[0]
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(axis=1).astype(np.float64)
    predicted = cm.sum(axis=0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec_c = np.where(predicted > 0, tp / predicted, 0.0)
        rec_c = np.where(support > 0, tp / support, 0.0)
    if k == 2:
        precision, recall = float(prec_c[1]), float(rec_c[1])
    else:
        precision, recall = float(prec_c.mean()), float(rec_c.mean())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    out = {"accuracy": float(tp.sum() / max(cm.sum(), 1)),
           "precision": precision, "recall": recall, "f1": f1,
           "confusion_matrix": cm}
    if prob is not None and k == 2:
        p = np.asarray(prob)
        score = p[:, 1] if p.ndim == 2 else p
        out["AUC"] = auc_score(y_true, score)
    return out


def regression_metrics(y_true, y_pred) -> dict:
    y = np.asarray(y_true).astype(np.float64)
    p = np.asarray(y_pred).astype(np.float64)
    err = y - p
    mse = float(np.mean(err ** 2))
    var = float(np.var(y))
    return {"mse": mse, "rmse": float(np.sqrt(mse)),
            "mae": float(np.mean(np.abs(err))),
            "r2": 1.0 - mse / var if var > 0 else float("nan")}
