"""Host-side text helpers: the port's copy of what the GBDT stages use from
``mmlspark_tpu/ops/text_ops.py`` (the text stages themselves are ROADMAP
Queue 1 item 9)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rows_to_matrix(col: np.ndarray):
    """Column of sparse row vectors / dense vectors -> single matrix
    (CSR if sparse, dense float32 otherwise)."""
    if len(col) and sp.issparse(col[0]):
        return sp.vstack(list(col), format="csr")
    from ..core.utils import to_float32_matrix
    return to_float32_matrix(np.asarray(col))
