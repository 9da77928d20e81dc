"""Column helper functions (reference: src/udf/src/main/scala/udfs.scala:15-28).

The reference ships two tiny Spark SQL UDFs — ``get_value_at`` (extract one
slot of an ML Vector column as a Double) and ``to_vector`` (Array[Double] →
dense ML Vector). Here the data plane is columnar numpy (core.dataframe), so
the vector-valued representation is an object column of per-row float arrays;
these helpers are vectorized column transforms usable directly or through
``UDFTransformer``. The port of ``mmlspark_tpu/stages/udfs.py``.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.utils import object_column


def get_value_at(df: DataFrame, col: str, index: int,
                 output_col: str | None = None) -> DataFrame:
    """Extract element ``index`` of each row of a vector column as float64
    (reference udfs.scala:17-21)."""
    vec = df.col(col)
    out = np.array([float(np.asarray(v)[index]) for v in vec], dtype=np.float64)
    return df.withColumn(output_col or f"{col}_{index}", out)


def to_vector(df: DataFrame, col: str,
              output_col: str | None = None) -> DataFrame:
    """Coerce a column of python lists / arrays into the canonical
    vector-column representation (object column of float32 arrays) so it can
    feed TorchModel/GBDT featurization in one copy to the device
    (reference udfs.scala:23-27)."""
    vals = [np.asarray(v, dtype=np.float32) for v in df.col(col)]
    return df.withColumn(output_col or col, object_column(vals))


def get_value_at_fn(index: int):
    """Row-level callable form for UDFTransformer: vec -> float(vec[index])."""
    def fn(vec):
        return float(np.asarray(vec)[index])
    return fn


def to_vector_fn():
    """Row-level callable form for UDFTransformer: seq -> float32 ndarray."""
    def fn(seq):
        return np.asarray(seq, dtype=np.float32)
    return fn
