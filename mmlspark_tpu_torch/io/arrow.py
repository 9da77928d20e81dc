"""Arrow -> device ingest bridge: record batches to the card without Python
rows. The port of ``mmlspark_tpu/io/arrow.py``.

The reference crosses its columnar->native gap per element: Spark rows are
copied value-by-value into JNI FloatVectorVectors (cntk-model/.../
CNTKModel.scala:67-74) and training data leaves the cluster as text files
over scp (cntk-train/.../CommandBuilders.scala:200-228). Here the path is:

  pyarrow RecordBatch -> zero-copy numpy views of the column buffers
    -> threaded C++ transpose into a row-major staging matrix in pinned
       host memory (``native.interleave_f32``)
    -> a non-blocking copy to the card on a side stream, from two staging
       matrices in turn (``io.loader.StagingRing``), so the next batch's
       interleave overlaps the previous batch's copy and compute.

No Python object ever wraps a cell. Feeds ``TorchLearner.fitStream`` via
:func:`arrow_feature_batches` and the relational layer via
:func:`arrow_frames` (``DataFrame.fromArrowStream``). ``pyarrow`` is
imported only inside the functions that read a stream (the card's machine
has none).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..core.dataframe import DataFrame
from ..core.env import resolve_device
from .loader import StagingRing


def _field_index(batch, name: str) -> int:
    i = batch.schema.get_field_index(name)
    if i < 0:  # pyarrow returns -1, and column(-1) is the LAST column
        raise KeyError(f"no column {name!r} in record batch; have "
                       f"{batch.schema.names}")
    return i


def _column_f32(col) -> np.ndarray:
    """One arrow column -> contiguous float32 numpy (zero-copy when the
    buffer is already f32 and null-free; one cast otherwise)."""
    arr = col.to_numpy(zero_copy_only=False)
    if arr.dtype != np.float32 or not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr, dtype=np.float32)
    return arr


def batch_to_matrix(batch, columns: Optional[Sequence[str]] = None,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """RecordBatch -> row-major (n, d) float32 matrix.

    ``out`` is the persistent staging buffer (first n rows are written);
    allocated when absent. The interleave runs in C++ threads
    (``np.stack`` only when the native runtime is disabled)."""
    names = list(columns) if columns is not None else batch.schema.names
    cols = [_column_f32(batch.column(_field_index(batch, c)))
            for c in names]
    n, d = batch.num_rows, len(cols)
    if out is None:
        out = np.empty((n, d), dtype=np.float32)
    if out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError("staging buffer must be C-contiguous float32 "
                         f"(got {out.dtype})")
    if out.shape[1] != d:
        raise ValueError(f"staging buffer has {out.shape[1]} columns for "
                         f"{d} features")
    if out.shape[0] < n:
        raise ValueError(f"staging buffer {out.shape} too small for "
                         f"({n}, {d}) rows")
    if not native.interleave_f32(cols, out[:n]):
        np.stack(cols, axis=1, out=out[:n])
    return out[:n]


def arrow_frames(source) -> Iterator[DataFrame]:
    """Stream of DataFrames, one per record batch — the out-of-core
    relational surface (``DataFrame.fromArrowStream``). Columns are
    zero-copy numpy views where dtypes allow."""
    for batch in _iter_batches(source):
        yield DataFrame({name: batch.column(i).to_numpy(
            zero_copy_only=False)
            for i, name in enumerate(batch.schema.names)})


def _iter_batches(source) -> Iterator:
    """Accept a RecordBatchReader, a Table, an iterable of RecordBatches,
    or a feather/arrow-IPC file path."""
    import pyarrow as pa
    if isinstance(source, str):
        reader = pa.ipc.open_file(pa.memory_map(source))
        for i in range(reader.num_record_batches):
            yield reader.get_batch(i)
        return
    if isinstance(source, pa.Table):
        yield from source.to_batches()
        return
    yield from source


def arrow_feature_batches(source, feature_cols: Sequence[str],
                          label_col: str, max_batch_rows: int = 1 << 16,
                          device: str = "cuda") -> Iterator[tuple]:
    """``(features, labels)`` tensors on ``device`` for
    ``TorchLearner.fitStream``: features a float32 (n, d) matrix, labels
    the label column. On a card the features are interleaved into one of
    two pinned staging matrices in turn and copied on a side stream; a
    matrix is refilled only after its previous copy has landed. On the CPU
    each batch is its own matrix."""
    dev = resolve_device(device, "arrow_feature_batches")
    d = len(feature_cols)
    ring = (StagingRing(dev, (max(max_batch_rows, 1), d), torch.float32)
            if dev.type == "cuda" else None)
    for k, batch in enumerate(_iter_batches(source)):
        n = batch.num_rows
        if n > max_batch_rows:
            raise ValueError(f"record batch of {n} rows exceeds "
                             f"max_batch_rows={max_batch_rows}; re-chunk "
                             f"the stream")
        # a copy: the column's buffer is read-only
        y = np.array(batch.column(_field_index(batch, label_col))
                     .to_numpy(zero_copy_only=False))
        if ring is None:
            yield (torch.from_numpy(batch_to_matrix(batch, feature_cols)),
                   torch.from_numpy(y))
            continue
        staged = ring.slot(k)
        batch_to_matrix(batch, feature_cols, out=staged.numpy())
        x_dev, ev = ring.copy(k, staged[:n])
        with torch.cuda.stream(ring.stream):
            y_dev = torch.from_numpy(y).pin_memory().to(dev,
                                                        non_blocking=True)
            ev.record(ring.stream)        # after both copies
        yield ring.consume(x_dev, ev), ring.consume(y_dev, ev)


def frame_from_arrow_stream(source) -> DataFrame:
    """Materialize a whole stream into one DataFrame (small data); for
    out-of-core use iterate :func:`arrow_frames` or feed
    :func:`arrow_feature_batches` to fitStream. Columns concatenate ONCE
    over all batches (a pairwise union fold would copy O(B^2))."""
    cols: dict[str, list] = {}
    for batch in _iter_batches(source):
        for i, name in enumerate(batch.schema.names):
            cols.setdefault(name, []).append(
                batch.column(i).to_numpy(zero_copy_only=False))
    if not cols:
        return DataFrame({})
    return DataFrame({k: (v[0] if len(v) == 1 else np.concatenate(v))
                      for k, v in cols.items()})
