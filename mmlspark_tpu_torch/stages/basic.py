"""Generic pipeline stages: the port of ``mmlspark_tpu/stages/basic.py``
(reference: src/pipeline-stages — Cacher.scala:12, DropColumns:19,
SelectColumns:21, RenameColumn:18, Repartition:18, UDFTransformer:21,
ClassBalancer:25, Timer.scala:54; checkpoint-data/...
CheckpointData.scala:47; multi-column-adapter/.../MultiColumnAdapter.scala:17).

Host numpy over the columnar frame, as in the JAX package. Two stages touch
the device's tooling: ``Timer(logToProfiler=True)`` brackets the inner
stage in a ``torch.profiler.record_function`` range (and an NVTX range when
the inner stage runs on a CUDA device), and ``Profiler(traceDir=...)``
records it with ``torch.profiler.profile`` into a Chrome trace.

DropColumns, SelectColumns, RenameColumn and FastVectorAssembler expose a
``capture`` (core/capture.py: their work as tensor code inside a fused
pipeline segment); the host-only stages carry ``_uncapturable = True``.

``ClassBalancer`` over a sharded frame (``parallel.dataplane``) in a world
of more than one rank weighs the fleet-wide class counts: every rank's
counts are gathered once and summed, so every rank holds the same table.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..core.capture import StageCapture
from ..core.dataframe import DataFrame
from ..core.params import (BooleanParam, ComplexParam, HasInputCol,
                           HasOutputCol, IntParam, ListParam, Params,
                           StringParam)
from ..core.pipeline import Estimator, Model, Transformer
from ..core.utils import get_logger, object_column

log = get_logger("stages")


class Cacher(Transformer):
    """Materialize + cache (reference Cacher.scala:12). The columnar frame is
    already materialized; this pins it (no-op hook kept for API parity)."""
    _uncapturable = True        # host materialization point by definition
    disable = BooleanParam("pass through without caching", default=False)

    def transform(self, df: DataFrame) -> DataFrame:
        return df if self.getDisable() else df.cache()


class CheckpointData(Transformer):
    """Persist to memory/disk (reference CheckpointData.scala:47)."""
    _uncapturable = True        # host persistence point
    diskIncluded = BooleanParam("also spill to disk", default=False)
    removeCheckpoint = BooleanParam("unpersist instead", default=False)

    def transform(self, df: DataFrame) -> DataFrame:
        return df.unpersist() if self.getRemoveCheckpoint() else df.cache()


class DropColumns(Transformer):
    cols = ListParam("columns to drop", default=())

    def transform(self, df: DataFrame) -> DataFrame:
        missing = [c for c in self.getCols() if c not in df.columns]
        if missing:
            raise ValueError(f"cannot drop missing columns {missing}")
        return df.drop(*self.getCols())

    def capture(self, columns):
        if any(c not in columns for c in self.getCols()):
            return None     # staged transform raises the real error
        return StageCapture(lambda p, xs: (), drops=tuple(self.getCols()))


class SelectColumns(Transformer):
    cols = ListParam("columns to keep", default=())

    def transform(self, df: DataFrame) -> DataFrame:
        return df.select(*self.getCols())

    def capture(self, columns):
        keep = set(self.getCols())
        if any(c not in columns for c in keep):
            return None     # staged transform raises the real error
        return StageCapture(lambda p, xs: (),
                            drops=tuple(c for c in columns
                                        if c not in keep))


class RenameColumn(Transformer, HasInputCol, HasOutputCol):
    def transform(self, df: DataFrame) -> DataFrame:
        return df.withColumnRenamed(self.getInputCol(), self.getOutputCol())

    def capture(self, columns):
        old, new = self.getInputCol(), self.getOutputCol()
        if old not in columns:
            return None
        return StageCapture(lambda p, xs: (xs[0],), inputs=(old,),
                            outputs=(new,), drops=(old,), tag="rename")


class Repartition(Transformer):
    """Adjust logical partition count (reference Repartition.scala:18 with its
    `disable` flag)."""
    _uncapturable = True        # host partition bookkeeping
    n = IntParam("target partition count", default=1, min=1)
    disable = BooleanParam("pass through unchanged", default=False)

    def transform(self, df: DataFrame) -> DataFrame:
        return df if self.getDisable() else df.repartition(self.getN())


class UDFTransformer(Transformer, HasInputCol, HasOutputCol):
    """Apply a python function per row value, or to the whole column when
    vectorized=True (reference UDFTransformer.scala:21; the python-UDF path
    of UDPyFParam)."""
    _uncapturable = True        # arbitrary python — untraceable by contract
    udf = ComplexParam("function value->value (or column->column)", default=None)
    vectorized = BooleanParam("udf takes the whole column array", default=False)

    def transform(self, df: DataFrame) -> DataFrame:
        fn = self.getUdf()
        col = df.col(self.getInputCol())
        if self.getVectorized():
            out = fn(col)
        else:
            # hand the raw row results to withColumn's canonical column
            # builder: sequence/array results become an object column (ragged
            # rows included), scalars a typed array — never a 2D matrix
            out = [fn(v) for v in col]
        return df.withColumn(self.getOutputCol(), out)


class ClassBalancer(Estimator, HasInputCol, HasOutputCol):
    """Inverse-frequency instance weights (reference ClassBalancer.scala:25):
    weight = max_count / count(class), so the largest class gets 1.0."""
    broadcastJoin = BooleanParam("kept for API parity", default=True)

    def fit(self, df: DataFrame) -> "ClassBalancerModel":
        col = df.col(self.getInputCol())
        values, counts = np.unique(col, return_counts=True)
        from ..parallel import dataplane
        if dataplane.is_sharded(df):
            # fleet-wide class frequencies: merge each shard's histogram
            totals: dict = {}
            for part in dataplane.allgather_pyobj(
                    dict(zip(values.tolist(), counts.tolist()))):
                for v, n in part.items():
                    totals[v] = totals.get(v, 0) + n
            values = np.array(sorted(totals, key=str))
            counts = np.array([totals[v] for v in values.tolist()])
        weights = counts.max() / counts.astype(np.float64)
        return (ClassBalancerModel()
                .setInputCol(self.getInputCol())
                .setOutputCol(self.getOutputCol() or "weight")
                .setWeightTable({v: float(w) for v, w in zip(values.tolist(),
                                                             weights)}))


class ClassBalancerModel(Model, HasInputCol, HasOutputCol):
    _uncapturable = True        # dict lookup over arbitrary (string) keys
    weightTable = ComplexParam("class value -> weight", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        table = self.getWeightTable()
        col = df.col(self.getInputCol())
        out = np.array([table.get(v, 1.0) for v in col.tolist()],
                       dtype=np.float64)
        return df.withColumn(self.getOutputCol(), out)


class MultiColumnAdapter(Transformer):
    """Map a unary stage over (inputCol, outputCol) pairs (reference
    MultiColumnAdapter.scala:17)."""
    _uncapturable = True        # meta-stage: fit-and-transform inner stages
    baseStage = ComplexParam("unary PipelineStage to replicate", default=None)
    inputCols = ListParam("input columns", default=())
    outputCols = ListParam("output columns", default=())

    def _pairs(self):
        ins, outs = self.getInputCols(), self.getOutputCols()
        if len(ins) != len(outs):
            raise ValueError("inputCols and outputCols must align")
        return list(zip(ins, outs))

    def transform(self, df: DataFrame) -> DataFrame:
        for i, o in self._pairs():
            stage = self.getBaseStage().copy({"inputCol": i, "outputCol": o})
            df = _run_stage(stage, df)
        return df


def _run_stage(stage, df: DataFrame) -> DataFrame:
    """Fit-then-transform an Estimator, or transform a Transformer."""
    if isinstance(stage, Estimator):
        return stage.fit(df).transform(df)
    return stage.transform(df)


def uses_cuda(stage) -> bool:
    """Whether ``stage`` or a stage it holds (a pipeline's stages, a
    wrapper's inner stage or model) runs on a CUDA device, read from their
    ``device`` params."""
    seen = set()

    def walk(v) -> bool:
        if isinstance(v, (list, tuple)):
            return any(walk(x) for x in v)
        if not isinstance(v, Params) or id(v) in seen:
            return False
        seen.add(id(v))
        if v.hasParam("device") and str(v.get("device") or "") \
                .startswith("cuda"):
            return True
        return any(walk(x) for x in v._paramMap.values())
    return walk(stage)


class Timer(Transformer):
    """Wrap a stage, log wall-clock of fit/transform (reference
    Timer.scala:36-70 materializes to defeat laziness; our frames are eager so
    timing is direct). ``logToProfiler=True`` brackets the stage in a
    ``torch.profiler.record_function`` range named
    ``Timer/<inner class>`` — what a running ``torch.profiler`` trace
    shows — and, when the inner stage runs on a CUDA device, an NVTX range
    of the same name for external GPU tools."""
    _uncapturable = True        # wrapping semantics (times the inner stage)
    stage = ComplexParam("inner PipelineStage", default=None)
    logToConsole = BooleanParam("print timing", default=True)
    logToProfiler = BooleanParam(
        "emit a torch.profiler range (and an NVTX range on CUDA)",
        default=False)

    def transform(self, df: DataFrame) -> DataFrame:
        inner = self.getStage()
        t0 = time.perf_counter()
        if self.getLogToProfiler():
            import torch
            name = f"Timer/{type(inner).__name__}"
            nvtx = uses_cuda(inner) and torch.cuda.is_available()
            if nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                with torch.profiler.record_function(name):
                    out = _run_stage(inner, df)
            finally:
                if nvtx:
                    torch.cuda.nvtx.range_pop()
        else:
            out = _run_stage(inner, df)
        dt = time.perf_counter() - t0
        if self.getLogToConsole():
            log.warning("%s took %.3fs", type(inner).__name__, dt)
        self._last_seconds = dt
        return out


class Profiler(Transformer):
    """Record an inner stage with ``torch.profiler.profile`` and write a
    Chrome trace (``trace_<pid>_<n>.json``) into ``traceDir`` — the
    first-class profiling stage the reference lacks (SURVEY.md §5:
    reference tracing is only the wall-clock Timer,
    pipeline-stages/.../Timer.scala:36-70). It records CPU activity, and
    CUDA activity too when the inner stage runs on a CUDA device. The
    written path lands on ``_last_trace``."""
    _uncapturable = True        # wrapping semantics (profiles the inner stage)
    stage = ComplexParam("inner PipelineStage", default=None)
    traceDir = StringParam("directory for the Chrome trace", default="")

    def transform(self, df: DataFrame) -> DataFrame:
        import torch
        inner = self.getStage()
        trace_dir = self.getTraceDir() or None
        if trace_dir is None:
            return _run_stage(inner, df)
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if uses_cuda(inner) and torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            out = _run_stage(inner, df)
        n = len(os.listdir(trace_dir))
        path = os.path.join(trace_dir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(path)
        self._last_trace = path
        return out


class FastVectorAssembler(Transformer, HasOutputCol):
    """Assemble numeric / vector columns into one vector column (reference:
    core/spark/.../FastVectorAssembler.scala:18-34). The reference exists
    because Spark's VectorAssembler copies per-slot ML attributes and chokes
    at millions of columns; it keeps only categorical attributes. Here
    assembly is a single numpy concatenation per row batch, and only
    categorical metadata is propagated (as slot ranges under the MML tag) —
    same contract, columnar speed.
    """
    inputCols = ListParam("columns to assemble, in order", default=())

    def transform(self, df: DataFrame) -> DataFrame:
        from ..core.schema import MML_TAG
        cols = self.getInputCols()
        if not cols:
            raise ValueError("FastVectorAssembler needs inputCols")
        n = len(df)
        parts = []          # (name, 2D float32 block)
        for name in cols:
            col = df.col(name)
            if col.dtype == object:
                block = np.stack([np.asarray(v, dtype=np.float32).ravel()
                                  for v in col]) if n else \
                    np.zeros((0, 0), np.float32)
            else:
                # explicit trailing width so n == 0 frames assemble too
                width = int(np.prod(col.shape[1:])) if col.ndim > 1 else 1
                block = col.astype(np.float32).reshape(n, width)
            parts.append((name, block))
        mat = np.concatenate([b for _, b in parts], axis=1) if parts else \
            np.zeros((n, 0), np.float32)
        out = object_column(mat)
        # propagate ONLY categorical attributes, as slot ranges
        slots = {}
        offset = 0
        for name, block in parts:
            width = block.shape[1]
            cat = df.metadata(name).get(MML_TAG, {}).get("categorical")
            if cat is not None:
                slots[name] = {"start": offset, "width": width,
                               "categorical": cat}
            offset += width
        meta = {MML_TAG: {"assembled": {"size": offset, "slots": slots}}}
        return df.withColumn(self.getOutputCol(), out, metadata=meta)

    def capture(self, columns):
        """Assembly is one concatenation — pure device work. The fused
        form skips the categorical slot-range metadata: on the transform
        side nothing downstream reads it, and the fit side gets it from
        :meth:`capture_metadata` (no staged frame needed)."""
        cols = tuple(self.getInputCols())
        if not cols or any(c not in columns for c in cols):
            return None

        def fn(p, xs):
            import torch
            parts = [x.to(torch.float32).reshape(x.shape[0], -1)
                     for x in xs]
            return (torch.cat(parts, dim=1),)

        return StageCapture(fn, inputs=cols,
                            outputs=(self.getOutputCol(),))

    def capture_metadata(self, df):
        """The assembled categorical slot-range metadata, computed from
        the RAW frame for the fit-side capture (GBDT auto-categorical
        detection reads it while the fused fit never materializes the
        assembled column on the host). Best-effort: None when an input
        column is absent from the raw frame (a prefix stage produced or
        renamed it — widths and attributes are then unknowable without
        staging) or when an object column is empty."""
        from ..core.schema import MML_TAG
        cols = self.getInputCols()
        if not cols or any(c not in df.columns for c in cols):
            return None
        slots = {}
        offset = 0
        for name in cols:
            col = df.col(name)
            if col.dtype == object:
                if not len(col):
                    return None
                width = int(np.asarray(col[0]).size)
            else:
                width = int(np.prod(col.shape[1:])) if col.ndim > 1 else 1
            cat = df.metadata(name).get(MML_TAG, {}).get("categorical")
            if cat is not None:
                slots[name] = {"start": offset, "width": width,
                               "categorical": cat}
            offset += width
        return {MML_TAG: {"assembled": {"size": offset, "slots": slots}}}
