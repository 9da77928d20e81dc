"""Featurize: automatic feature assembly — the port of
``mmlspark_tpu/automl/featurize.py`` (reference: featurize/.../
Featurize.scala:24, AssembleFeatures.scala:93). Host work, as in the JAX
package.

Per input column the fitted plan mirrors the reference's AssembleFeatures:
numerics cast to f32; categoricals (metadata levels, or low-cardinality
strings) one-hot encoded (StringIndexer+OneHotEncoder analog,
AssembleFeatures.scala:442); free text hashed (HashingTF, :232-240); image
structs unrolled to CHW pixels; vector columns passed through — then all
parts concatenate into ONE dense f32 matrix (FastVectorAssembler analog,
core/spark/FastVectorAssembler.scala:18-34), built column-block-wise.

Not ported yet: merging per-process plans of a sharded frame
(``_merge_sharded_plans``, ROADMAP.md Queue 1 item 12b); a sharded frame
fits as its local shard.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import (BooleanParam, ComplexParam, HasOutputCol,
                           IntParam, ListParam)
from ..core.pipeline import Estimator, Model
from ..core.schema import CategoricalUtilities, is_image_column
from ..ops import text_ops

MAX_ONE_HOT = 32  # low-cardinality threshold for treating strings as categorical


def _plan_column(df: DataFrame, name: str, one_hot: bool, num_features: int):
    col = df.col(name)
    levels = CategoricalUtilities.getLevels(df, name)
    if levels is not None:
        return {"kind": "categorical" if one_hot else "index",
                "levels": list(levels)}
    if col.dtype.kind in "bifu":
        return {"kind": "numeric"}
    if is_image_column(df, name):
        return {"kind": "image"}
    if col.dtype.kind == "O" and len(col):
        first = col[0]
        if isinstance(first, str):
            uniq = {v for v in col.tolist()}
            if len(uniq) <= MAX_ONE_HOT:
                # "inferred" marks levels discovered from the data (vs
                # schema metadata), as in the JAX package's plans
                return {"kind": "categorical" if one_hot else "index",
                        "levels": sorted(uniq), "inferred": True}
            return {"kind": "text", "num_features": num_features}
        if np.ndim(first) >= 1 or hasattr(first, "toarray"):
            return {"kind": "vector"}
    raise ValueError(f"cannot featurize column {name!r} (dtype {col.dtype})")


def _apply_plan(df: DataFrame, name: str, plan: dict) -> np.ndarray:
    col = df.col(name)
    kind = plan["kind"]
    if kind == "numeric":
        return col.astype(np.float32).reshape(-1, 1)
    if kind in ("categorical", "index"):
        index = {v: i for i, v in enumerate(plan["levels"])}
        ids = np.array([index.get(v, -1) for v in col], dtype=np.int64)
        if kind == "index":
            return ids.astype(np.float32).reshape(-1, 1)
        k = len(plan["levels"])
        out = np.zeros((len(col), k), dtype=np.float32)
        valid = ids >= 0
        out[np.arange(len(col))[valid], ids[valid]] = 1.0
        return out
    if kind == "text":
        docs = text_ops.tokenize(["" if v is None else str(v) for v in col])
        return text_ops.hashing_tf(docs, plan["num_features"]).toarray() \
            .astype(np.float32)
    if kind == "image":
        from ..ops.image_stages import UnrollImage
        tmp = UnrollImage().setInputCol(name).setOutputCol("__u").transform(df)
        return np.stack([v.astype(np.float32) for v in tmp.col("__u")])
    if kind == "vector":
        mat = text_ops.rows_to_matrix(col)
        if hasattr(mat, "toarray"):
            mat = mat.toarray()
        return np.asarray(mat, dtype=np.float32)
    raise ValueError(kind)


class FeaturizeModel(Model, HasOutputCol):
    inputPlans = ComplexParam("per-column featurization plans", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        plans = self.getInputPlans()
        blocks = [_apply_plan(df, name, plan) for name, plan in plans]
        mat = np.concatenate(blocks, axis=1) if blocks else \
            np.zeros((df.count(), 0), np.float32)
        out = np.empty(len(mat), dtype=object)
        for i in range(len(mat)):
            out[i] = mat[i]
        return df.withColumn(self.getOutputCol(), out)


class Featurize(Estimator, HasOutputCol):
    """Fit featurization plans over the chosen columns (default: all except
    excluded)."""

    inputCols = ListParam("columns to featurize ([] = all but excluded)",
                          default=())
    excludeCols = ListParam("columns to skip (e.g. the label)", default=())
    oneHotEncodeCategoricals = BooleanParam("one-hot categoricals",
                                            default=True)
    numberOfFeatures = IntParam("hash dimension for text columns",
                                default=1 << 12, min=1)

    def fit(self, df: DataFrame) -> FeaturizeModel:
        cols = list(self.getInputCols()) or \
            [c for c in df.columns if c not in set(self.getExcludeCols())]
        plans = []
        for name in cols:
            plans.append((name, _plan_column(
                df, name, self.getOneHotEncodeCategoricals(),
                self.getNumberOfFeatures())))
        return (FeaturizeModel().setOutputCol(self.getOutputCol())
                .setInputPlans(plans))

