"""TrainClassifier / TrainRegressor: the AutoML convenience estimators —
the port of ``mmlspark_tpu/automl/train_classifier.py`` (reference:
train-classifier/.../TrainClassifier.scala:40,102-182,288-388;
train-regressor/.../TrainRegressor.scala:20,149).

Flow mirrors the reference: reindex labels (ValueIndexer policy,
TrainClassifier.scala:141-172) -> auto-featurize every non-label column
(Featurize) -> fit the chosen algorithm -> wrap a model that adds scored
columns with schema role tags and decodes labels back to original values.
The default learners are the port's ``LogisticRegression`` and
``LinearRegression`` (``models/classical.py``), on ``device="cuda"``.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import (BooleanParam, ComplexParam, HasLabelCol, IntParam,
                           StringParam)
from ..core.pipeline import Estimator, Model
from ..core.schema import SparkSchema
from .featurize import Featurize
from .value_indexer import ValueIndexer


def _needs_indexing(col: np.ndarray) -> bool:
    if col.dtype.kind not in "bifu":
        return True
    vals = np.unique(col)
    return not np.array_equal(vals, np.arange(len(vals)))


class TrainedClassifierModel(Model, HasLabelCol):
    """Featurize + inner model + label decode (reference
    TrainClassifier.scala:288-388)."""
    featurizeModel = ComplexParam("fitted FeaturizeModel", default=None)
    innerModel = ComplexParam("fitted classifier", default=None)
    labelLevels = ComplexParam("original label values, index order", default=None)
    scoredLabelsCol = StringParam("decoded predicted label column",
                                  default="scored_labels")

    def featureImportances(self, n_features=None) -> np.ndarray:
        """Split-count importances from a tree-backed inner model
        (DT/RF/GBT/LightGBM), per ASSEMBLED feature slot — interpret slots
        via the featurize model's column layout."""
        inner = self.getInnerModel()
        if not hasattr(inner, "featureImportances"):
            raise AttributeError(
                f"{type(inner).__name__} exposes no featureImportances "
                f"(tree-backed models only)")
        return inner.featureImportances(n_features)

    def transform(self, df: DataFrame) -> DataFrame:
        feat = self.getFeaturizeModel().transform(df)
        out = self.getInnerModel().transform(feat)
        pred_col = self.getInnerModel().getOrDefault("predictionCol")
        levels = self.getLabelLevels()
        preds = out.col(pred_col).astype(np.int64)
        if levels is not None:
            decoded = np.array([levels[i] for i in preds], dtype=object)
        else:
            decoded = preds.astype(np.float64)
        out = out.withColumn(self.getScoredLabelsCol(), decoded)
        out = out.drop("features")
        # the inner model's raw prediction column keeps its values but loses
        # the scored-labels role tag — the DECODED column is the one
        # evaluators must find
        out = SparkSchema.clearColumnKind(out, pred_col)
        return SparkSchema.setScoredLabelsColumnName(
            out, self.getScoredLabelsCol(), "classification")


class TrainClassifier(Estimator, HasLabelCol):
    model = ComplexParam("untrained classifier estimator", default=None)
    numFeatures = IntParam("hash dim for text features", default=0, min=0)
    oneHotEncodeCategoricals = BooleanParam("one-hot categoricals", default=True)

    def _algo(self):
        if self.getModel() is not None:
            return self.getModel()
        from ..models.classical import LogisticRegression
        return LogisticRegression()

    def fit(self, df: DataFrame) -> TrainedClassifierModel:
        label = self.getLabelCol()
        algo = self._algo().copy()
        # label policy (reference doc TrainClassifier.scala:20-38): non-numeric
        # or non-contiguous labels are dictionary-indexed; levels retained to
        # decode predictions
        levels = None
        work = df.dropna(subset=[label])
        if _needs_indexing(work.col(label)):
            vim = ValueIndexer().setInputCol(label).setOutputCol(label).fit(work)
            work = vim.transform(work)
            levels = list(vim.getLevels())
        # per-algorithm feature budget (reference :114-140 picks smaller hash
        # dims for tree learners)
        nf = self.getNumFeatures()
        if nf == 0:
            nf = 1 << 12
        featurizer = (Featurize().setOutputCol("features")
                      .setExcludeCols((label,))
                      .setOneHotEncodeCategoricals(
                          self.getOneHotEncodeCategoricals())
                      .setNumberOfFeatures(nf))
        fmodel = featurizer.fit(work)
        featurized = fmodel.transform(work)
        algo.set(featuresCol="features", labelCol=label)
        inner = algo.fit(featurized)
        return (TrainedClassifierModel()
                .setLabelCol(label)
                .setFeaturizeModel(fmodel)
                .setInnerModel(inner)
                .setLabelLevels(levels))


class TrainedRegressorModel(Model, HasLabelCol):
    featurizeModel = ComplexParam("fitted FeaturizeModel", default=None)
    innerModel = ComplexParam("fitted regressor", default=None)

    featureImportances = TrainedClassifierModel.featureImportances

    def transform(self, df: DataFrame) -> DataFrame:
        feat = self.getFeaturizeModel().transform(df)
        out = self.getInnerModel().transform(feat)
        return out.drop("features")


class TrainRegressor(Estimator, HasLabelCol):
    model = ComplexParam("untrained regressor estimator", default=None)
    numFeatures = IntParam("hash dim for text features", default=0, min=0)

    def _algo(self):
        if self.getModel() is not None:
            return self.getModel()
        from ..models.classical import LinearRegression
        return LinearRegression()

    def fit(self, df: DataFrame) -> TrainedRegressorModel:
        label = self.getLabelCol()
        work = df.dropna(subset=[label])
        nf = self.getNumFeatures() or (1 << 12)
        featurizer = (Featurize().setOutputCol("features")
                      .setExcludeCols((label,))
                      .setNumberOfFeatures(nf))
        fmodel = featurizer.fit(work)
        featurized = fmodel.transform(work)
        algo = self._algo().copy()
        algo.set(featuresCol="features", labelCol=label)
        inner = algo.fit(featurized)
        return (TrainedRegressorModel()
                .setLabelCol(label)
                .setFeaturizeModel(fmodel)
                .setInnerModel(inner))
