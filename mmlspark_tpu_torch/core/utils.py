"""Small shared utilities (reference: core/env Logging, core/utils
CastUtilities); the port's copy of the parts of ``mmlspark_tpu/core/utils.py``
that the serving path uses."""

from __future__ import annotations

import logging
import os

import numpy as np


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"mmlspark_tpu_torch.{name}")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("MMLSPARK_TPU_LOGLEVEL", "WARNING"))
    return logger


def object_column(values) -> np.ndarray:
    """Build a 1-D object ndarray holding one (possibly vector) value per
    row — the canonical representation of vector-valued columns."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def to_float32_matrix(col: np.ndarray) -> np.ndarray:
    """Coerce a column of scalars / vectors / lists into an (n, d) float32
    matrix — the device-feed analog of the reference's input coercion UDF
    (CNTKModel.scala:232-241), done once per column instead of per element."""
    if col.dtype.kind in "bifu":
        if col.ndim == 1:
            return col.astype(np.float32).reshape(-1, 1)
        return col.astype(np.float32).reshape(len(col), -1)
    if len(col) == 0:
        return np.zeros((0, 0), np.float32)
    return np.stack([np.asarray(v, dtype=np.float32).ravel() for v in col])
