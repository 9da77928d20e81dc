"""ValueIndexer / ValueIndexerModel / IndexToValue — the port of
``mmlspark_tpu/automl/value_indexer.py`` (reference:
value-indexer/.../ValueIndexer.scala:54,100, IndexToValue.scala:26).

Fits a dictionary over a column's distinct values, transforms values to
indices, and records the levels in column metadata (the reference's
categorical-levels contract, Categoricals.scala) so downstream learners and
IndexToValue can decode. A sharded frame (``parallel.dataplane``) in a
world of more than one rank fits the fleet-wide dictionary: the union of
every rank's levels, gathered once, so every rank holds the same model."""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasInputCol, HasOutputCol
from ..core.pipeline import Estimator, Model, Transformer
from ..core.schema import CategoricalUtilities


def _sorted_levels(col: np.ndarray) -> list:
    vals = [v for v in set(col.tolist()) if v is not None and v == v]
    try:
        return sorted(vals)
    except TypeError:
        return sorted(vals, key=str)


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    levels = ComplexParam("ordered distinct values", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        levels = list(self.getLevels())
        index = {v: i for i, v in enumerate(levels)}
        col = df.col(self.getInputCol())
        out = np.array([index.get(v, -1) for v in col], dtype=np.float64)
        if (out < 0).any():
            missing = sorted({str(v) for v in col if v not in index})[:5]
            raise ValueError(
                f"unseen values in {self.getInputCol()!r}: {missing}")
        res = df.withColumn(self.getOutputCol(), out)
        return CategoricalUtilities.setLevels(res, self.getOutputCol(), levels)


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    def fit(self, df: DataFrame) -> ValueIndexerModel:
        levels = _sorted_levels(df.col(self.getInputCol()))
        from ..parallel import dataplane
        if dataplane.is_sharded(df):
            # fleet-wide dictionary: union of every shard's local levels
            merged = set().union(*dataplane.allgather_pyobj(set(levels)))
            try:
                levels = sorted(merged)
            except TypeError:
                levels = sorted(merged, key=str)
        return (ValueIndexerModel()
                .setInputCol(self.getInputCol())
                .setOutputCol(self.getOutputCol())
                .setLevels(levels))


class IndexToValue(Transformer, HasInputCol, HasOutputCol):
    """Inverse transform: index column (+ levels metadata) -> original values."""

    def transform(self, df: DataFrame) -> DataFrame:
        levels = CategoricalUtilities.getLevels(df, self.getInputCol())
        if levels is None:
            raise ValueError(
                f"column {self.getInputCol()!r} has no categorical levels "
                "metadata (was it produced by ValueIndexer?)")
        col = df.col(self.getInputCol()).astype(np.int64)
        out = np.array([levels[i] for i in col], dtype=object)
        return df.withColumn(self.getOutputCol(), out)
