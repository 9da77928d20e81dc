"""MiniBatchTransformer / FlattenBatch (reference: io/http/.../
MiniBatchTransformer.scala:28-50): rows <-> batched rows. Batching feeds the
serving path so inference always hits the device with full blocks. The port
of ``mmlspark_tpu/stages/minibatch.py``; host numpy, as there."""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import IntParam
from ..core.pipeline import Transformer


class MiniBatchTransformer(Transformer):
    """Pack every column into lists of up to batchSize elements; output has
    ceil(n / batchSize) rows, each cell a list."""
    _uncapturable = True        # host row re-packing (row count changes)
    batchSize = IntParam("max rows per batch", default=10, min=1)

    def transform(self, df: DataFrame) -> DataFrame:
        bs = self.getBatchSize()
        n = df.count()
        bounds = list(range(0, n, bs)) + [n]
        data = {}
        for c in df.columns:
            col = df.col(c)
            out = np.empty(len(bounds) - 1, dtype=object)
            for i in range(len(bounds) - 1):
                out[i] = list(col[bounds[i]:bounds[i + 1]])
            data[c] = out
        return DataFrame(data)


class FlattenBatch(Transformer):
    """Inverse of MiniBatchTransformer: explode list-valued cells back to
    one row per element."""
    _uncapturable = True        # host row re-packing (row count changes)

    def transform(self, df: DataFrame) -> DataFrame:
        cols = df.columns
        if not cols:
            return df
        lengths = [len(v) for v in df.col(cols[0])]
        data = {}
        for c in cols:
            col = df.col(c)
            flat = []
            for i, cell in enumerate(col):
                if not isinstance(cell, (list, tuple, np.ndarray)):
                    raise ValueError(f"column {c!r} row {i} is not a batch")
                if len(cell) != lengths[i]:
                    raise ValueError(f"ragged batch at column {c!r} row {i}")
                flat.extend(cell)
            data[c] = np.array(flat, dtype=object) \
                if col.dtype.kind == "O" and flat and \
                not np.isscalar(flat[0]) else np.array(flat)
        return DataFrame(data)
