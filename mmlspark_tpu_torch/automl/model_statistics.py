"""ComputeModelStatistics + ComputePerInstanceStatistics — the port of
``mmlspark_tpu/automl/model_statistics.py`` (reference:
compute-model-statistics/.../ComputeModelStatistics.scala:56-160,
compute-per-instance-statistics/.../ComputePerInstanceStatistics.scala:42).

Finds label/score columns by schema role tags (SparkSchema) when not set
explicitly, computes the metric table as a 1-row DataFrame (the reference
emits a metrics dataframe + spray-json payload). Host numpy, as in the JAX
package."""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import StringParam
from ..core.pipeline import Transformer
from ..core.schema import SchemaConstants, SparkSchema
from ..ops.text_ops import rows_to_matrix
from . import metrics as M


def _find(df: DataFrame, explicit: str, kind: str, fallbacks: tuple) -> str:
    if explicit:
        return explicit
    tagged = SparkSchema.findColumnByKind(df, kind)
    if tagged:
        return tagged
    for f in fallbacks:
        if f in df.columns:
            return f
    raise ValueError(f"cannot locate a column of kind {kind!r}; "
                     f"set it explicitly (have {df.columns})")


class ComputeModelStatistics(Transformer):
    evaluationMetric = StringParam("classification|regression|all",
                                   default="all")
    labelCol = StringParam("true label column ('' = by tag)", default="")
    scoresCol = StringParam("scores/probability column ('' = by tag)", default="")
    scoredLabelsCol = StringParam("predicted label column ('' = by tag)",
                                  default="")

    def transform(self, df: DataFrame) -> DataFrame:
        label = _find(df, self.getLabelCol(),
                      SchemaConstants.TrueLabelsColumnKind, ("label",))
        y = df.col(label)
        is_classification = self.getEvaluationMetric() == "classification"
        if self.getEvaluationMetric() == "all":
            # regression if predictions are continuous, else classification
            try:
                pred_col = _find(df, self.getScoredLabelsCol(),
                                 SchemaConstants.ScoredLabelsColumnKind,
                                 ("scored_labels", "prediction"))
                is_classification = True
            except ValueError:
                is_classification = False
        if is_classification:
            pred_col = _find(df, self.getScoredLabelsCol(),
                             SchemaConstants.ScoredLabelsColumnKind,
                             ("scored_labels", "prediction"))
            preds = df.col(pred_col)
            if preds.dtype.kind == "O" or y.dtype.kind == "O":
                # decoded labels: index both against shared levels
                levels = sorted({str(v) for v in y} | {str(v) for v in preds})
                idx = {v: i for i, v in enumerate(levels)}
                y_i = np.array([idx[str(v)] for v in y])
                p_i = np.array([idx[str(v)] for v in preds])
            else:
                y_i = y.astype(np.int64)
                p_i = preds.astype(np.int64)
            prob = None
            try:
                scores_col = _find(df, self.getScoresCol(),
                                   SchemaConstants.ScoresColumnKind,
                                   ("probability", "scores"))
                prob = rows_to_matrix(df.col(scores_col))
                if hasattr(prob, "toarray"):
                    prob = prob.toarray()
            except (ValueError, KeyError):
                pass
            stats = M.classification_metrics(y_i, p_i, prob)
            cm = stats.pop("confusion_matrix")
            cols = {k: np.array([v]) for k, v in stats.items()}
            cols["confusion_matrix"] = np.array([cm], dtype=object)
            return DataFrame(cols)
        pred_col = _find(df, self.getScoredLabelsCol() or self.getScoresCol(),
                         SchemaConstants.ScoresColumnKind, ("prediction",))
        stats = M.regression_metrics(y.astype(np.float64),
                                     df.col(pred_col).astype(np.float64))
        return DataFrame({k: np.array([v]) for k, v in stats.items()})


class ComputePerInstanceStatistics(Transformer):
    """Per-row errors: log-loss for classification, L1/L2 for regression
    (reference ComputePerInstanceStatistics.scala:42)."""

    evaluationMetric = StringParam("classification|regression", default="regression")
    labelCol = StringParam("true label column ('' = by tag)", default="")
    scoresCol = StringParam("scores column ('' = by tag)", default="")

    def transform(self, df: DataFrame) -> DataFrame:
        label = _find(df, self.getLabelCol(),
                      SchemaConstants.TrueLabelsColumnKind, ("label",))
        y = df.col(label).astype(np.float64)
        if self.getEvaluationMetric() == "classification":
            scores_col = _find(df, self.getScoresCol(),
                               SchemaConstants.ScoresColumnKind,
                               ("probability", "scores"))
            prob = rows_to_matrix(df.col(scores_col))
            if hasattr(prob, "toarray"):
                prob = prob.toarray()
            p_true = prob[np.arange(len(y)), y.astype(np.int64)]
            return df.withColumn("log_loss",
                                 -np.log(np.clip(p_true, 1e-15, 1.0)))
        scores_col = _find(df, self.getScoresCol(),
                           SchemaConstants.ScoresColumnKind, ("prediction",))
        pred = df.col(scores_col).astype(np.float64)
        return (df.withColumn("L1_loss", np.abs(y - pred))
                  .withColumn("L2_loss", (y - pred) ** 2))
