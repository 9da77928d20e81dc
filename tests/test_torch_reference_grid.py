"""The reference's correctness bar on the port, and its datasets.

``mmlspark_tpu_torch/testing/reference_datasets.py`` must give the JAX
package's arrays bit for bit (the same seed, the same numpy draws). The
reference grid's PimaIndian rows (``tests/test_reference_goldens.py``'s
exact configs) run through the port's TrainClassifier on the CPU and must
reach the reference's committed train AUC - 0.02 (that test's own bar),
the LightGBM floor its committed value - 0.05 (likewise). AUC is the
port's own ``automl.metrics.auc_score``: the port imports no sklearn.
"""

import numpy as np
import pytest

from mmlspark_tpu.testing import reference_datasets as jax_ref
from mmlspark_tpu_torch.automl import metrics
from mmlspark_tpu_torch.automl import train_classifier as tc
from mmlspark_tpu_torch.models import classical
from mmlspark_tpu_torch.models.gbdt import stages as gbdt
from mmlspark_tpu_torch.testing import reference_datasets as ref


def _binary_y(df, label):
    vals = np.asarray(df.col(label))
    uniq = sorted(set(vals.tolist()))
    return (vals == uniq[1]).astype(np.int64), uniq


_GRID = {
    "LogisticRegression": (
        lambda: classical.LogisticRegression(device="cpu", maxIter=80),
        "scores"),
    "DecisionTreeClassification": (
        lambda: classical.DecisionTreeClassifier(device="cpu", maxBin=63),
        "scores"),
    "RandomForestClassification": (
        lambda: classical.RandomForestClassifier(
            device="cpu", numIterations=20, maxBin=63), "scores"),
    "GradientBoostedTreesClassification": (
        lambda: classical.GBTClassifier(device="cpu", numIterations=20,
                                        maxBin=63), "labels"),
    "NaiveBayesClassifier": (lambda: classical.NaiveBayes(device="cpu"),
                             "labels"),
    "MultilayerPerceptronClassifier": (
        lambda: classical.MultilayerPerceptronClassifier(device="cpu",
                                                         maxIter=120),
        "labels"),
}


@pytest.mark.parametrize("algo", sorted(
    a for d, a in ref.TRAIN_CLASSIFIER_REFERENCE_AUC if d == "PimaIndian.csv"))
def test_reference_grid_pima(algo):
    """tests/test_reference_goldens.py's grid configs on the port: train
    AUC from probability scores (LR/DT/RF) or scored labels (GBT/NB/MLP),
    at least the reference's committed value - 0.02."""
    gen, label = ref.REFERENCE_DATASETS["PimaIndian.csv"]
    df = gen()
    make, mode = _GRID[algo]
    y, uniq = _binary_y(df, label)
    out = tc.TrainClassifier(labelCol=label, model=make()).fit(df) \
        .transform(df)
    if mode == "scores":
        auc = metrics.auc_score(y, np.stack(out.col("probability"))[:, 1])
    else:
        auc = metrics.auc_score(
            y, (np.asarray(out.col("scored_labels")) == uniq[1]).astype(float))
    want = ref.TRAIN_CLASSIFIER_REFERENCE_AUC[("PimaIndian.csv", algo)]
    assert auc >= want - 0.02


def test_lightgbm_reference_floor_pima():
    """VerifyLightGBMClassifier.scala:40-56's config: numLeaves=5,
    numIterations=10, every column featurized, train AUC from scores."""
    gen, label = ref.REFERENCE_DATASETS["PimaIndian.csv"]
    df = gen()
    y, _ = _binary_y(df, label)
    out = tc.TrainClassifier(labelCol=label, model=gbdt.LightGBMClassifier(
        device="cpu", numLeaves=5, numIterations=10)).fit(df).transform(df)
    auc = metrics.auc_score(y, np.stack(out.col("probability"))[:, 1])
    assert auc >= ref.LIGHTGBM_REFERENCE_AUC["PimaIndian.csv"] - 0.05


@pytest.mark.parametrize("table", [
    "REFERENCE_DATASETS", "REGRESSION_DATASETS", "MULTICLASS_DATASETS"])
def test_reference_datasets_same_bits(table):
    ours, theirs = getattr(ref, table), getattr(jax_ref, table)
    assert sorted(ours) == sorted(theirs)
    for name, (gen, label) in ours.items():
        jgen, jlabel = theirs[name]
        assert label == jlabel
        for seed in (0, 3):
            df, jdf = gen(seed), jgen(seed)
            assert df.columns == jdf.columns
            for c in df.columns:
                a, b = df.col(c), jdf.col(c)
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, c)


def test_reference_tables_equal():
    for t in ("LIGHTGBM_REFERENCE_AUC", "TRAIN_CLASSIFIER_REFERENCE_AUC",
              "LIGHTGBM_REFERENCE_RMSE", "TRAIN_CLASSIFIER_MULTICLASS_ACC"):
        assert getattr(ref, t) == getattr(jax_ref, t)
