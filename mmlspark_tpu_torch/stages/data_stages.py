"""Data-shaping stages (reference: clean-missing-data/.../
CleanMissingData.scala:46, data-conversion/.../DataConversion.scala:23,
partition-sample/.../PartitionSample.scala:131, summarize-data/...
SummarizeData.scala:98, ensemble/.../EnsembleByKey.scala:21,
pipeline-stages TextPreprocessor.scala:97); the port of
``mmlspark_tpu/stages/data_stages.py``.

Host numpy over the columnar frame, as in the JAX package.
CleanMissingDataModel and DataConversion also expose a ``capture``
(core/capture.py): their work as tensor code inside a fused pipeline
segment, in device dtypes.

A sharded frame (``parallel.dataplane``) in a world of more than one rank
fits and summarizes fleet-wide, as the JAX package does: each rank
computes mergeable per-column partials of its shard, one gather carries
every column's partials, and every rank merges them alike. The means,
counts, minima and maxima are exact; CleanMissingData's median and
SummarizeData's percentiles come from a pooled per-shard sample (exact
while every shard holds at most the sample cap), and the distinct count
from a KMV sketch (exact below its size)."""

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

    #: per-shard sample cap for the distributed median (pooled-sample
    #: approximation; exact distributed medians need a full value shuffle)
    _MEDIAN_SAMPLE = 16384

    def fit(self, df: DataFrame) -> "CleanMissingDataModel":
        from ..parallel import dataplane
        sharded = dataplane.is_sharded(df)
        cols = list(self.getInputCols()) or [
            c for c in df.columns if df.col(c).dtype.kind == "f"]
        mode = self.getCleaningMode()
        fills = {}
        partials = {}  # one fleet collective for all columns
        for c in cols:
            vals = df.col(c).astype(np.float64)
            ok = vals[~np.isnan(vals)]
            if mode == "Mean":
                if sharded:
                    partials[c] = (float(ok.sum()), float(len(ok)))
                else:
                    fills[c] = float(ok.mean()) if len(ok) else 0.0
            elif mode == "Median":
                if sharded:
                    # pooled per-shard sample (approximate past
                    # nprocs * cap values, exact below it)
                    if len(ok) > self._MEDIAN_SAMPLE:
                        ok = np.random.default_rng(0).choice(
                            ok, self._MEDIAN_SAMPLE, replace=False)
                    partials[c] = ok
                else:
                    fills[c] = float(np.median(ok)) if len(ok) else 0.0
            else:
                fills[c] = self.getCustomValue()
        if partials:
            fills.update(self._merge_partials(
                mode, dataplane.allgather_pyobj(partials)))
        outs = list(self.getOutputCols()) or cols
        return (CleanMissingDataModel().setFillValues(fills)
                .setOutputCols(tuple(outs)).setInputCols(tuple(cols)))


    @staticmethod
    def _merge_partials(mode: str, gathered: list) -> dict:
        """Every rank's per-column partials (rank order) -> the fill
        values: the pooled mean from (sum, count) pairs, or the median of
        the pooled samples."""
        fills = {}
        for c in gathered[0]:
            if mode == "Mean":
                s = sum(g[c][0] for g in gathered)
                k = sum(g[c][1] for g in gathered)
                fills[c] = s / k if k else 0.0
            else:
                pooled = np.concatenate([g[c] for g in gathered])
                fills[c] = float(np.median(pooled)) if len(pooled) else 0.0
        return fills


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

    #: per-shard caps for the distributed path: pooled percentile sample,
    #: and the KMV distinct-count sketch size (exact below it — Spark's own
    #: summary uses approxCountDistinct, so approximate parity is parity)
    _PCTL_SAMPLE = 16384
    _KMV_K = 4096

    @staticmethod
    def _stable_hash(v) -> int:
        """Process-independent 63-bit value hash (python's hash() is salted
        per process, which would corrupt a cross-process sketch merge)."""
        import hashlib
        h = hashlib.blake2b(repr(v).encode(), digest_size=8).digest()
        return int.from_bytes(h, "little") & 0x7FFFFFFFFFFFFFFF

    def _local_stats(self, col: np.ndarray, sharded: bool = False) -> dict:
        """Per-column stat components; mergeable across shards when
        ``sharded`` (single-frame mode keeps exact distincts and
        percentiles)."""
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
            if sharded:
                # distinct count: exact below the sketch size, else the KMV
                # (k-minimum stable-hash values) sketch — merges by
                # union+truncate
                hashes = np.sort(np.array(
                    [self._stable_hash(v) for v in uniq], dtype=np.uint64))
                s["kmv"] = hashes[:self._KMV_K]
                s["kmv_exact"] = len(hashes) <= self._KMV_K
            else:
                s["distinct"] = float(len(uniq))
        if numeric:
            s["ok_n"] = float(len(ok))
            s["sum"] = float(ok.sum())
            s["sumsq"] = float((ok ** 2).sum())
            s["min"] = float(ok.min()) if len(ok) else np.inf
            s["max"] = float(ok.max()) if len(ok) else -np.inf
            if sharded and len(ok) > self._PCTL_SAMPLE:
                ok = np.random.default_rng(0).choice(
                    ok, self._PCTL_SAMPLE, replace=False)
            s["sample"] = ok
        return s

    @classmethod
    def _merge_stats(cls, parts: list) -> dict:
        """Every rank's components of one column (rank order) -> one set."""
        out = dict(parts[0])
        for p in parts[1:]:
            out["n"] += p["n"]
            out["missing"] += p["missing"]
            if out["numeric"]:
                out["ok_n"] += p["ok_n"]
                out["sum"] += p["sum"]
                out["sumsq"] += p["sumsq"]
                out["min"] = min(out["min"], p["min"])
                out["max"] = max(out["max"], p["max"])
                out["sample"] = np.concatenate([out["sample"], p["sample"]])
            if "kmv" in out:
                out["kmv_exact"] = out["kmv_exact"] and p["kmv_exact"]
                out["kmv"] = np.unique(np.concatenate(
                    [out["kmv"], p["kmv"]]))
        if "kmv" in out:
            # truncating the union to k loses exactness once the pooled
            # cardinality crosses k — the estimator takes over then
            out["kmv_exact"] = (out["kmv_exact"]
                                and len(out["kmv"]) <= cls._KMV_K)
            out["kmv"] = out["kmv"][:cls._KMV_K]
        return out

    @classmethod
    def _distinct_estimate(cls, s: dict) -> float:
        if "distinct" in s:  # single-frame mode: exact
            return s["distinct"]
        kmv = s["kmv"]
        if s["kmv_exact"] or len(kmv) < cls._KMV_K:
            return float(len(kmv))
        # KMV estimator: D ~= (k-1) / (kth smallest hash / hash space)
        return float((cls._KMV_K - 1)
                     / (float(kmv[-1]) / float(0x7FFFFFFFFFFFFFFF)))

    def transform(self, df: DataFrame) -> DataFrame:
        from ..parallel import dataplane
        sharded = dataplane.is_sharded(df)
        local = {c: self._local_stats(df.col(c), sharded)
                 for c in df.columns}
        if sharded:  # one fleet collective for every column's components
            gathered = dataplane.allgather_pyobj(local)
        rows = []
        for c in df.columns:
            s = local[c]
            if sharded:
                s = self._merge_stats([g[c] for g in gathered])
            row = {"Feature": c}
            numeric = s["numeric"]
            if self.getCounts():
                row["Count"] = s["n"]
                row["Unique Value Count"] = self._distinct_estimate(s)
                row["Missing Value Count"] = s["missing"]
            if self.getBasic():
                ok_n = s.get("ok_n", 0.0) if numeric else 0.0
                mean = s["sum"] / ok_n if numeric and ok_n else np.nan
                row["Mean"] = mean
                if not (numeric and ok_n > 1):
                    row["Standard Deviation"] = np.nan
                elif not sharded:
                    # single frame: exact two-pass std (the moment form
                    # below cancels catastrophically at large mean)
                    row["Standard Deviation"] = float(
                        np.std(s["sample"], ddof=1))
                else:
                    row["Standard Deviation"] = float(
                        np.sqrt(max(0.0, (s["sumsq"] - ok_n * mean ** 2)
                                    / (ok_n - 1))))
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
