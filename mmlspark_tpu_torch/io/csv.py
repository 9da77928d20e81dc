"""CSV ingest: delimited numeric files -> columnar DataFrame.

The port of ``mmlspark_tpu/io/csv.py``. The GBDT/AutoML fast path — the
reference reads these datasets through Spark's CSV reader and converts rows
to dense native buffers per partition (lightgbm/.../LightGBMUtils.scala:
192-222); here the native threaded parser (``native.read_csv``, C++)
produces one contiguous float32 matrix that maps straight onto columns (and
onto the card in one copy). numpy's parser runs only when the native
runtime is disabled (``MMLSPARK_TPU_NO_NATIVE=1``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import native
from ..core.dataframe import DataFrame


def _read_header(path: str, delim: str) -> list[str]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return [c.strip() for c in f.readline().rstrip("\r\n").split(delim)]


def _looks_like_header(fields: Sequence[str]) -> bool:
    for v in fields:
        try:
            float(v)
            return False  # any numeric first-row field -> data, not header
        except ValueError:
            continue
    return True


def read_csv(path: str, header: Optional[bool] = None, delim: str = ",",
             columns: Optional[Sequence[str]] = None,
             threads: int = 0) -> DataFrame:
    """Numeric CSV -> DataFrame of float32 columns.

    header=None sniffs the first row (all-non-numeric = header). Column
    names come from `columns`, else the header, else c0..cN. Bad/missing
    fields are NaN.
    """
    first = _read_header(path, delim)
    if header is None:
        header = _looks_like_header(first)
    mat = read_csv_matrix(path, skip_header=bool(header), delim=delim,
                          threads=threads)
    if columns is not None:
        names = list(columns)
    elif header:
        names = first
    else:
        names = [f"c{i}" for i in range(mat.shape[1])]
    if len(names) != mat.shape[1]:
        raise ValueError(f"{len(names)} column names for {mat.shape[1]} "
                         f"columns in {path}")
    return DataFrame({n: mat[:, i].copy() for i, n in enumerate(names)})


def read_csv_matrix(path: str, skip_header: Optional[bool] = None,
                    delim: str = ",", threads: int = 0) -> np.ndarray:
    """Numeric CSV -> raw float32 matrix (the GBDT/trainer ingest form)."""
    if skip_header is None:
        skip_header = _looks_like_header(_read_header(path, delim))
    mat = native.read_csv(path, skip_header=bool(skip_header), delim=delim,
                          threads=threads)
    if mat is None:  # MMLSPARK_TPU_NO_NATIVE
        mat = np.genfromtxt(path, delimiter=delim,
                            skip_header=1 if skip_header else 0,
                            dtype=np.float32)
        if mat.ndim == 1:  # one row or one column — disambiguate by file
            n_cols = len(_read_header(path, delim))
            mat = mat.reshape(-1, n_cols)
    return mat
