"""The port's ``plot`` against the JAX package's: the confusion matrix and
the ROC curve of the same numpy-seeded frame draw the same data on
matplotlib's Agg backend. Compared: the heatmap's array, the per-cell count
texts, the title, the tick labels and the ROC lines' data, exactly (both
packages compute them with the same host numpy); no pixels."""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from mmlspark_tpu import plot as jax_plot  # noqa: E402
from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame  # noqa: E402
from mmlspark_tpu_torch import DataFrame, plot  # noqa: E402


def _frames(seed=0, n=200, labels=("a", "b", "c")):
    rng = np.random.default_rng(seed)
    y = np.array(labels, dtype=object)[rng.integers(0, len(labels), n)]
    flip = rng.random(n) < 0.3
    y_hat = np.where(flip, np.array(labels, dtype=object)[
        rng.integers(0, len(labels), n)], y)
    score = rng.random(n) * 0.6 + (y == labels[0]) * 0.4
    binary = (y == labels[0]).astype(np.float64)
    cols = {"y": y, "y_hat": y_hat, "score": score, "binary": binary}
    return (DataFrame({k: v.copy() for k, v in cols.items()}),
            JaxDataFrame({k: v.copy() for k, v in cols.items()}))


def _drawn_confusion(mod, df, **kw):
    fig, ax = plt.subplots()
    mod.confusionMatrix(df, "y", "y_hat", ax=ax, **kw)
    out = {"image": np.asarray(ax.images[0].get_array()),
           "texts": [t.get_text() for t in ax.texts],
           "title": ax.get_title(),
           "xticks": [t.get_text() for t in ax.get_xticklabels()],
           "yticks": [t.get_text() for t in ax.get_yticklabels()]}
    plt.close(fig)
    return out


@pytest.mark.parametrize("labels", [None, ["c", "b", "a", "d"],
                                    ["one", "two", "three"]])
def test_confusion_matrix_draws_the_same_data(labels):
    df, jdf = _frames()
    kw = {} if labels is None else {"labels": labels}
    got, want = _drawn_confusion(plot, df, **kw), \
        _drawn_confusion(jax_plot, jdf, **kw)
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["texts"] == want["texts"]
    assert sum(int(t) for t in got["texts"]) == 200
    assert (got["title"], got["xticks"], got["yticks"]) == \
        (want["title"], want["xticks"], want["yticks"])


def test_confusion_matrix_rejects_mismatched_labels():
    df, _ = _frames()
    with pytest.raises(ValueError):
        plot.confusionMatrix(df, "y", "y_hat", labels=["x"])


def test_roc_draws_the_same_lines():
    df, jdf = _frames(seed=3)
    lines = []
    for mod, frame in ((plot, df), (jax_plot, jdf)):
        fig, ax = plt.subplots()
        mod.roc(frame, "binary", "score", ax=ax)
        lines.append([(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
                      for ln in ax.get_lines()])
        plt.close(fig)
    got, want = lines
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
