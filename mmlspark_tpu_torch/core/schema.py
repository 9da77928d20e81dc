"""Column metadata conventions: the PyTorch port's subset of
``mmlspark_tpu/core/schema.py``.

* image rows are structs (reference:
  src/core/schema/src/main/scala/ImageSchema.scala:11-22), and a column is
  an image column when its metadata says so or its cells carry every
  ImageSchema field;
* categorical levels ride in column metadata under ``MML_TAG`` (reference:
  Categoricals.scala:16-60);
* score columns are tagged by role, so evaluators find scores and labels
  without their names (reference: SparkSchema.scala:13-80);
* ``findUnusedColumnName`` (reference: DatasetExtensions.scala).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .dataframe import DataFrame

MML_TAG = "mml"

IMAGE_FIELDS = ("path", "height", "width", "type", "bytes")


def make_image_row(path: str, height: int, width: int, channels: int,
                   data: bytes | np.ndarray) -> dict:
    """One image as a struct-row; `type` is the channel count, `bytes` is the
    HWC uint8 buffer (matching the reference's OpenCV byte layout)."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8).tobytes()
    return {"path": path, "height": int(height), "width": int(width),
            "type": int(channels), "bytes": data}


def make_binary_row(path: str, data: bytes) -> dict:
    """One file as a BinaryFileSchema struct-row."""
    return {"path": path, "bytes": data}


def image_to_array(row: dict) -> np.ndarray:
    """ImageSchema struct → HWC uint8 ndarray."""
    h, w, c = row["height"], row["width"], row["type"]
    return np.frombuffer(row["bytes"], dtype=np.uint8).reshape(h, w, c)


def is_image_column(df: DataFrame, name: str) -> bool:
    md = df.metadata(name).get(MML_TAG, {})
    if md.get("image"):
        return True
    col = df.col(name)
    if col.dtype.kind == "O" and len(col) and isinstance(col[0], dict):
        return set(IMAGE_FIELDS).issubset(col[0].keys())
    return False


def tag_image_column(df: DataFrame, name: str) -> DataFrame:
    md = df.metadata(name)
    md.setdefault(MML_TAG, {})["image"] = True
    return df.withMetadata(name, md)


class CategoricalUtilities:
    """Store/retrieve categorical level arrays on column metadata."""

    @staticmethod
    def setLevels(df: DataFrame, column: str, levels: Sequence,
                  ordinal: bool = False) -> DataFrame:
        md = df.metadata(column)
        md.setdefault(MML_TAG, {})["categorical"] = {
            "levels": list(levels), "ordinal": bool(ordinal)}
        return df.withMetadata(column, md)

    @staticmethod
    def getLevels(df: DataFrame, column: str) -> Optional[list]:
        cat = df.metadata(column).get(MML_TAG, {}).get("categorical")
        return None if cat is None else list(cat["levels"])

    @staticmethod
    def isCategorical(df: DataFrame, column: str) -> bool:
        return "categorical" in df.metadata(column).get(MML_TAG, {})


class SchemaConstants:
    ScoresColumnKind = "scores"
    ScoredLabelsColumnKind = "scored_labels"
    ScoredProbabilitiesColumnKind = "scored_probabilities"
    TrueLabelsColumnKind = "true_labels"
    ClassificationKind = "classification"
    RegressionKind = "regression"


class SparkSchema:
    """Role-tagging helpers (reference: SparkSchema.scala:13-80)."""

    @staticmethod
    def setColumnKind(df: DataFrame, column: str, kind: str,
                      model_kind: Optional[str] = None) -> DataFrame:
        md = df.metadata(column)
        tag = md.setdefault(MML_TAG, {})
        tag["kind"] = kind
        if model_kind is not None:
            tag["model_kind"] = model_kind
        return df.withMetadata(column, md)

    @staticmethod
    def clearColumnKind(df: DataFrame, column: str) -> DataFrame:
        md = df.metadata(column)
        md.get(MML_TAG, {}).pop("kind", None)
        return df.withMetadata(column, md)

    @staticmethod
    def getColumnKind(df: DataFrame, column: str) -> Optional[str]:
        return df.metadata(column).get(MML_TAG, {}).get("kind")

    @staticmethod
    def findColumnByKind(df: DataFrame, kind: str) -> Optional[str]:
        for c in df.columns:
            if SparkSchema.getColumnKind(df, c) == kind:
                return c
        return None

    @staticmethod
    def setLabelColumnName(df, column, model_kind=None):
        return SparkSchema.setColumnKind(
            df, column, SchemaConstants.TrueLabelsColumnKind, model_kind)

    @staticmethod
    def setScoresColumnName(df, column, model_kind=None):
        return SparkSchema.setColumnKind(
            df, column, SchemaConstants.ScoresColumnKind, model_kind)

    @staticmethod
    def setScoredLabelsColumnName(df, column, model_kind=None):
        return SparkSchema.setColumnKind(
            df, column, SchemaConstants.ScoredLabelsColumnKind, model_kind)

    @staticmethod
    def setScoredProbabilitiesColumnName(df, column, model_kind=None):
        return SparkSchema.setColumnKind(
            df, column, SchemaConstants.ScoredProbabilitiesColumnKind,
            model_kind)


def findUnusedColumnName(prefix: str, df: DataFrame) -> str:
    """reference: DatasetExtensions.findUnusedColumnName."""
    name, i = prefix, 0
    existing = set(df.columns)
    while name in existing:
        i += 1
        name = f"{prefix}_{i}"
    return name
