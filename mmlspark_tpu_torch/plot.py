"""Plotting helpers (reference: src/plot/src/main/python/plot.py).

The reference ships two matplotlib helpers — an annotated, row-normalized
confusion matrix and an ROC curve — that pull columns out of a Spark frame.
Here they pull from the columnar DataFrame and compute the statistics with
the framework's own numpy metrics (automl.metrics) instead of sklearn.
matplotlib is imported only inside the functions, so environments that never
plot (the card's machine has no matplotlib) import this module freely.

The port of ``mmlspark_tpu/plot.py``, over the port's ``automl.metrics``.
"""

from __future__ import annotations

import numpy as np

from .core.dataframe import DataFrame
from .automl.metrics import confusion_matrix as _confusion_counts
from .automl.metrics import roc_points


def _column(df, name):
    if isinstance(df, DataFrame):
        return np.asarray(df.col(name))
    return np.asarray(df[name])  # pandas or dict-like


def confusionMatrix(df, y_col: str, y_hat_col: str, labels=None, ax=None):
    """Row-normalized confusion-matrix heatmap with per-cell counts and an
    accuracy banner (reference plot.py:17-43)."""
    import matplotlib.pyplot as plt

    y = _column(df, y_col)
    y_hat = _column(df, y_hat_col)
    accuracy = float(np.mean(y == y_hat))
    # map arbitrary (possibly string) labels to indices for the count matrix;
    # when `labels` names the class values themselves, its ORDER defines the
    # matrix axes (absent classes get zero rows, sklearn/Spark-style); when
    # it's display text of matching length, it only renames the ticks
    uniq = np.unique(np.concatenate([y, y_hat]))
    if labels is not None:
        if set(labels) >= set(uniq.tolist()):
            uniq = np.asarray(labels)
        elif len(labels) != len(uniq):
            raise ValueError(f"labels {list(labels)} neither covers the data "
                             f"values {uniq.tolist()} nor matches their count")
    lut = {v: i for i, v in enumerate(uniq)}
    y_idx = np.array([lut[v] for v in y], dtype=np.int64)
    yh_idx = np.array([lut[v] for v in y_hat], dtype=np.int64)
    cm = _confusion_counts(y_idx, yh_idx)
    if cm.shape[0] < len(uniq):       # classes listed but absent from data
        k = len(uniq)
        cm = np.pad(cm, ((0, k - cm.shape[0]), (0, k - cm.shape[1])))
    row_sums = cm.sum(axis=1, keepdims=True)
    cmn = cm.astype(float) / np.maximum(row_sums, 1)

    if ax is None:
        ax = plt.gca()
    if labels is None:
        labels = [str(v) for v in uniq]
    ticks = np.arange(len(labels))
    im = ax.imshow(cmn, interpolation="nearest", cmap="Blues", vmin=0, vmax=1)
    ax.set_xticks(ticks, labels=labels)
    ax.set_yticks(ticks, labels=labels)
    ax.set_title(f"Accuracy = {accuracy * 100:.1f}%")
    thresh = 0.1
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(int(cm[i, j])), ha="center",
                    color="white" if cmn[i, j] > thresh else "black")
    ax.figure.colorbar(im, ax=ax)
    ax.set_xlabel("Predicted Label")
    ax.set_ylabel("True Label")
    return ax


def roc(df, y_col: str, y_hat_col: str, thresh: float = 0.5, ax=None):
    """ROC curve: y binarized at ``thresh``, scores from ``y_hat_col``
    (reference plot.py:45-60)."""
    import matplotlib.pyplot as plt

    y = (_column(df, y_col).astype(float) > thresh).astype(int)
    score = _column(df, y_hat_col).astype(float)
    fpr, tpr = roc_points(y, score)
    if ax is None:
        ax = plt.gca()
    ax.plot(fpr, tpr)
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=0.8)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    return ax
