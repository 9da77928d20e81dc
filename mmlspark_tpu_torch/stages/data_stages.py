"""Data-shaping stages (reference: clean-missing-data/.../
CleanMissingData.scala:46, data-conversion/.../DataConversion.scala:23,
partition-sample/.../PartitionSample.scala:131, summarize-data/...
SummarizeData.scala:98, ensemble/.../EnsembleByKey.scala:21,
pipeline-stages TextPreprocessor.scala:97); the port of
``mmlspark_tpu/stages/data_stages.py``.

Host numpy over the columnar frame, as in the JAX package.
CleanMissingDataModel and DataConversion also expose a ``capture``
(core/capture.py): their work as tensor code inside a fused pipeline
segment, in device dtypes. Not ported: the sharded-frame branches of
CleanMissingData and SummarizeData (the fleet-wide merges of ROADMAP.md
Queue 1 item 12b): every statistic here is the exact one of the frame it
is given (a sharded frame's local shard)."""

from __future__ import annotations

import numpy as np

from ..core.capture import StageCapture
from ..core.dataframe import DataFrame
from ..core.params import (BooleanParam, ComplexParam, DictParam, FloatParam,
                           HasInputCol, HasOutputCol, IntParam, ListParam,
                           StringParam)
from ..core.pipeline import Estimator, Model, Transformer


class CleanMissingData(Estimator):
    """Impute missing values: mean/median/custom (reference
    CleanMissingData.scala:46)."""
    inputCols = ListParam("columns to clean", default=())
    outputCols = ListParam("output columns (default: in place)", default=())
    cleaningMode = StringParam("Mean|Median|Custom", default="Mean",
                               choices=("Mean", "Median", "Custom"))
    customValue = FloatParam("fill value for Custom mode", default=0.0)

    def fit(self, df: DataFrame) -> "CleanMissingDataModel":
        cols = list(self.getInputCols()) or [
            c for c in df.columns if df.col(c).dtype.kind == "f"]
        mode = self.getCleaningMode()
        fills = {}
        for c in cols:
            vals = df.col(c).astype(np.float64)
            ok = vals[~np.isnan(vals)]
            if mode == "Mean":
                fills[c] = float(ok.mean()) if len(ok) else 0.0
            elif mode == "Median":
                fills[c] = float(np.median(ok)) if len(ok) else 0.0
            else:
                fills[c] = self.getCustomValue()
        outs = list(self.getOutputCols()) or cols
        return (CleanMissingDataModel().setFillValues(fills)
                .setOutputCols(tuple(outs)).setInputCols(tuple(cols)))


class CleanMissingDataModel(Model):
    inputCols = ListParam("columns to clean", default=())
    outputCols = ListParam("output columns", default=())
    fillValues = ComplexParam("column -> fill value", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        fills = self.getFillValues()
        for c, o in zip(self.getInputCols(), self.getOutputCols()):
            vals = df.col(c).astype(np.float64)
            df = df.withColumn(o, np.where(np.isnan(vals), fills[c], vals))
        return df

    def capture(self, columns):
        """Imputation as one ``where(isnan)`` per column against the fill
        as a device constant. The fused path computes in float32 (device
        dtype) where the host path returns float64; values are identical
        at float32 precision."""
        ins = tuple(self.getInputCols())
        outs = tuple(self.getOutputCols())
        if not ins or len(ins) != len(outs) \
                or any(c not in columns for c in ins):
            return None
        fills = self.getFillValues()
        if fills is None or any(c not in fills for c in ins):
            return None

        def fn(p, xs):
            import torch
            out = []
            for x, f in zip(xs, p["fills"]):
                xf = x.to(torch.float32)
                out.append(torch.where(torch.isnan(xf), f, xf))
            return tuple(out)

        return StageCapture(fn, inputs=ins, outputs=outs,
                            params={"fills": [float(fills[c])
                                              for c in ins]},
                            host_cast={o: np.float64 for o in outs})


class DataConversion(Transformer):
    """Column type casts + date reformat (reference DataConversion.scala:23).
    convertTo: boolean|byte|short|integer|long|float|double|string|date."""
    cols = ListParam("columns to convert", default=())
    convertTo = StringParam("target type", default="double")
    dateTimeFormat = StringParam("strftime format for date conversion",
                                 default="%Y-%m-%d %H:%M:%S")

    _NUMPY_TYPES = {"boolean": np.bool_, "byte": np.int8, "short": np.int16,
                    "integer": np.int32, "long": np.int64,
                    "float": np.float32, "double": np.float64}

    def transform(self, df: DataFrame) -> DataFrame:
        target = self.getConvertTo()
        for c in self.getCols():
            col = df.col(c)
            if target in self._NUMPY_TYPES:
                df = df.withColumn(c, col.astype(self._NUMPY_TYPES[target]))
            elif target == "string":
                df = df.withColumn(
                    c, np.array([str(v) for v in col], dtype=object))
            elif target == "date":
                import datetime
                fmt = self.getDateTimeFormat()
                out = np.array([datetime.datetime.strptime(str(v), fmt)
                                for v in col], dtype=object)
                df = df.withColumn(c, out)
            elif target == "toCategorical":
                from ..core.schema import CategoricalUtilities
                levels = sorted({v for v in col.tolist()}, key=str)
                df = CategoricalUtilities.setLevels(df, c, levels)
            else:
                raise ValueError(f"unknown conversion target {target!r}")
        return df

    #: numeric targets the fused path covers: device compute dtypes are
    #: float32/int32, so wide targets cast at readback (host_cast) —
    #: values identical wherever they fit the device dtype
    _CAPTURE_TARGETS = {"float": (np.float32, np.float32),
                        "double": (np.float32, np.float64),
                        "integer": (np.int32, np.int32),
                        "boolean": (np.bool_, np.bool_)}

    def capture(self, columns):
        target = self.getConvertTo()
        cols = tuple(self.getCols())
        if target not in self._CAPTURE_TARGETS or not cols \
                or any(c not in columns for c in cols):
            return None
        dev_dtype, host_dtype = self._CAPTURE_TARGETS[target]

        def fn(p, xs):
            import torch
            dt = torch.from_numpy(np.zeros(0, dev_dtype)).dtype
            return tuple(x.to(dt) for x in xs)

        return StageCapture(fn, inputs=cols, outputs=cols,
                            host_cast={c: host_dtype for c in cols})


class PartitionSample(Transformer):
    """head / random % / assign-to-partition sampling (reference
    PartitionSample.scala:131)."""
    _uncapturable = True        # host RNG + row-count-changing semantics
    mode = StringParam("Head|RandomSample|AssignToPartition",
                       default="RandomSample",
                       choices=("Head", "RandomSample", "AssignToPartition"))
    count = IntParam("rows for Head mode", default=1000, min=0)
    percent = FloatParam("fraction for RandomSample", default=0.1)
    seed = IntParam("random seed", default=0)
    newColName = StringParam("partition-id column for AssignToPartition",
                             default="Partition")
    numParts = IntParam("partitions for AssignToPartition", default=10, min=1)

    def transform(self, df: DataFrame) -> DataFrame:
        mode = self.getMode()
        if mode == "Head":
            return df.limit(self.getCount())
        if mode == "RandomSample":
            return df.sample(self.getPercent(), seed=self.getSeed())
        rng = np.random.default_rng(self.getSeed())
        ids = rng.integers(0, self.getNumParts(), df.count())
        return df.withColumn(self.getNewColName(), ids.astype(np.int64))


class SummarizeData(Transformer):
    """Per-column stats table (reference SummarizeData.scala:98): counts,
    basic moments, percentiles, error-count toggles."""
    _uncapturable = True        # emits a fresh stats table
    counts = BooleanParam("row/missing counts", default=True)
    basic = BooleanParam("mean/std/min/max", default=True)
    percentiles = BooleanParam("p25/p50/p75", default=True)
    errorThreshold = FloatParam("kept for parity", default=0.0)

    def _local_stats(self, col: np.ndarray) -> dict:
        """Per-column stat components (exact distincts and percentiles)."""
        numeric = col.dtype.kind in "bifu"
        s: dict = {"numeric": numeric, "n": float(len(col))}
        if numeric:
            vals = col.astype(np.float64)
            ok = vals[~np.isnan(vals)]
            s["missing"] = float(np.isnan(vals).sum())
        else:
            cells = col.tolist()
            s["missing"] = float(sum(v is None for v in cells))
        if self.getCounts():  # distinct values are only worked out if asked
            uniq = (np.unique(ok).tolist() if numeric
                    else list({v for v in cells}))
            s["distinct"] = float(len(uniq))
        if numeric:
            s["ok_n"] = float(len(ok))
            s["sum"] = float(ok.sum())
            s["min"] = float(ok.min()) if len(ok) else np.inf
            s["max"] = float(ok.max()) if len(ok) else -np.inf
            s["sample"] = ok
        return s

    def transform(self, df: DataFrame) -> DataFrame:
        rows = []
        for c in df.columns:
            s = self._local_stats(df.col(c))
            row = {"Feature": c}
            numeric = s["numeric"]
            if self.getCounts():
                row["Count"] = s["n"]
                row["Unique Value Count"] = s["distinct"]
                row["Missing Value Count"] = s["missing"]
            if self.getBasic():
                ok_n = s.get("ok_n", 0.0) if numeric else 0.0
                mean = s["sum"] / ok_n if numeric and ok_n else np.nan
                row["Mean"] = mean
                if not (numeric and ok_n > 1):
                    row["Standard Deviation"] = np.nan
                else:
                    # exact two-pass std (the moment form cancels
                    # catastrophically at large mean)
                    row["Standard Deviation"] = float(
                        np.std(s["sample"], ddof=1))
                row["Min"] = s["min"] if numeric and ok_n else np.nan
                row["Max"] = s["max"] if numeric and ok_n else np.nan
            if self.getPercentiles():
                ok = s.get("sample") if numeric else None
                for q, name in ((25, "P25"), (50, "Median"), (75, "P75")):
                    row[name] = (float(np.percentile(ok, q))
                                 if numeric and ok is not None and len(ok)
                                 else np.nan)
            rows.append(row)
        return DataFrame.fromRows(rows)


class EnsembleByKey(Transformer):
    """Group rows by key column(s) and aggregate vector/double columns by
    mean or collect (reference EnsembleByKey.scala:21)."""
    _uncapturable = True        # host groupBy over arbitrary key dtypes
    keys = ListParam("key columns", default=())
    cols = ListParam("value columns to aggregate", default=())
    strategy = StringParam("mean|collect", default="mean",
                           choices=("mean", "collect"))
    collapseGroup = BooleanParam("one row per key (vs broadcast back)",
                                 default=True)

    def transform(self, df: DataFrame) -> DataFrame:
        keys = list(self.getKeys())
        vcols = list(self.getCols())
        if not keys or not vcols:
            raise ValueError("keys and cols must both be set")
        fn = "collect_list" if self.getStrategy() == "collect" else "mean"
        grouped = df.groupBy(*keys)
        out = grouped.agg(**{c: (c, fn) for c in vcols})
        if self.getCollapseGroup():
            return out
        # broadcast aggregates back onto every original row (one gather)
        ids = grouped.rowGroupIds()
        res = df
        for c in vcols:
            res = res.withColumn(c, out.col(c)[ids])
        return res


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Longest-match substring replacement via a trie (reference
    TextPreprocessor.scala:97 builds a char trie over the map keys)."""
    _uncapturable = True        # python string scanning
    map = DictParam("substring -> replacement", default=None)
    normFunc = StringParam("identity|lowerCase|upperCase", default="identity",
                           choices=("identity", "lowerCase", "upperCase"))

    def _normalize(self, s: str) -> str:
        f = self.getNormFunc()
        return s.lower() if f == "lowerCase" else \
            s.upper() if f == "upperCase" else s

    def transform(self, df: DataFrame) -> DataFrame:
        table = dict(self.getMap() or {})
        # longest-match-first scan (trie semantics without the trie)
        keys = sorted(table, key=len, reverse=True)
        col = df.col(self.getInputCol())
        out = np.empty(len(col), dtype=object)
        for r, text in enumerate(col):
            s = self._normalize("" if text is None else str(text))
            buf, i = [], 0
            while i < len(s):
                for k in keys:
                    if s.startswith(k, i):
                        buf.append(table[k])
                        i += len(k)
                        break
                else:
                    buf.append(s[i])
                    i += 1
            out[r] = "".join(buf)
        return df.withColumn(self.getOutputCol(), out)
