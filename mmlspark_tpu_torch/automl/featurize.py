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

A sharded frame (``parallel.dataplane``) in a world of more than one rank
fits one fleet-wide plan: every rank plans its local shard (an empty shard
plans its object columns as ``unknown``), the plans are gathered once for
all columns, and ``_merge_sharded_plans`` merges them as a fit over the
whole frame would plan (levels unioned, an inferred categorical past
MAX_ONE_HOT levels hashed as text).
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


def _plan_column(df: DataFrame, name: str, one_hot: bool, num_features: int,
                 allow_unknown: bool = False):
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
                # schema metadata): a sharded fit may revise the decision
                # once every shard's levels are pooled
                return {"kind": "categorical" if one_hot else "index",
                        "levels": sorted(uniq), "inferred": True}
            return {"kind": "text", "num_features": num_features}
        if np.ndim(first) >= 1 or hasattr(first, "toarray"):
            return {"kind": "vector"}
    if allow_unknown and col.dtype.kind == "O" and not len(col):
        # empty local shard of a sharded frame: another rank's plan
        # decides at the merge
        return {"kind": "unknown"}
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
        from ..parallel import dataplane
        sharded = dataplane.is_sharded(df)
        cols = list(self.getInputCols()) or \
            [c for c in df.columns if c not in set(self.getExcludeCols())]
        plans = []
        for name in cols:
            plans.append((name, _plan_column(
                df, name, self.getOneHotEncodeCategoricals(),
                self.getNumberOfFeatures(), allow_unknown=sharded)))
        if sharded:
            plans = _merge_sharded_plans(
                plans, self.getOneHotEncodeCategoricals(),
                self.getNumberOfFeatures())
        return (FeaturizeModel().setOutputCol(self.getOutputCol())
                .setInputPlans(plans))


def _merge_sharded_plans(local_plans, one_hot: bool, num_features: int):
    """Combine per-rank featurization plans into one fleet-wide plan: the
    fitted statistics a fit over the whole frame would have computed
    (reference: Spark aggregates these cluster-wide inside StringIndexer
    etc., AssembleFeatures.scala:442). One gather for all columns.

    Merge rules per column: categorical levels union across shards; an
    INFERRED string categorical whose pooled cardinality exceeds
    MAX_ONE_HOT degrades to hashed text (the decision a global fit makes);
    any shard seeing text makes the column text; 'unknown' (empty local
    shard) defers to whichever shard had data."""
    from ..parallel import dataplane
    all_plans = dataplane.allgather_pyobj(local_plans)
    merged = []
    for i, (name, _) in enumerate(local_plans):
        variants = [p[i][1] for p in all_plans]
        known = [v for v in variants if v["kind"] != "unknown"]
        kinds = {v["kind"] for v in known}
        if not kinds:
            raise ValueError(f"column {name!r} is empty on every shard")
        if kinds <= {"categorical", "index"}:
            inferred = any(v.get("inferred") for v in variants)
            if inferred:
                levels = sorted(set().union(*[set(v.get("levels", ()))
                                              for v in known]))
            else:
                # schema-provided levels: every shard read the same column
                # metadata — keep its order (re-sorting would scramble
                # category indices against a single-frame fit)
                levels = list(known[0]["levels"])
            if inferred and len(levels) > MAX_ONE_HOT:
                merged.append((name, {"kind": "text",
                                      "num_features": num_features}))
            else:
                plan = {"kind": "categorical" if one_hot else "index",
                        "levels": levels}
                if inferred:
                    plan["inferred"] = True
                merged.append((name, plan))
        elif "text" in kinds:
            merged.append((name, {"kind": "text",
                                  "num_features": num_features}))
        elif len(kinds) == 1:
            merged.append((name, dict(known[0])))
        else:
            raise ValueError(f"column {name!r} plans disagree across "
                             f"shards: {sorted(kinds)}")
    return merged

