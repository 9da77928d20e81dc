"""Image-column conventions the model input path needs.

The PyTorch port's subset of ``mmlspark_tpu/core/schema.py``: image rows are
structs (reference: src/core/schema/src/main/scala/ImageSchema.scala:11-22)
and a column is an image column when its metadata says so or its cells carry
every ImageSchema field. Categorical and score-column tagging come with the
stages that use them.
"""

from __future__ import annotations

import numpy as np

from .dataframe import DataFrame

MML_TAG = "mml"

IMAGE_FIELDS = ("path", "height", "width", "type", "bytes")


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
