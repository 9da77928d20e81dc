"""Columnar DataFrame: the framework's data plane.

The reference rides Spark SQL DataFrames (driver plans, executors hold row
partitions, native code is entered per-partition via mapPartitions — see
SURVEY.md §1/§3). This framework is Spark-free: the data plane is an
immutable columnar table of numpy arrays, designed so whole columns can be
shipped to device memory in one copy instead of the reference's element-wise
JNI copies (reference: cntk-model/.../CNTKModel.scala:67-74). The PyTorch
port's copy of ``mmlspark_tpu/core/dataframe.py``.

Key properties:
  * columns are numpy arrays (numeric, string/object, or object-structs for
    images); zero-copy from/to pyarrow and pandas where dtypes allow;
  * per-column metadata dict — carries categorical levels and score-column
    tags the way the reference stores them in Spark column metadata under
    ``MMLTag`` (reference: core/schema/.../Categoricals.scala:16-60);
  * logical partitions (``npartitions``) so partition-parallel semantics
    (LightGBM workers, DistributedHTTP, PartitionSample) survive; batches are
    what actually feed the device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np


def _as_column(values) -> np.ndarray:
    if isinstance(values, np.ndarray):
        return values
    # any python sequence of per-row sequences/arrays becomes an object
    # column — ONE canonical representation for vector-valued columns,
    # regardless of whether rows arrive as lists, tuples, or ndarrays
    if isinstance(values, (list, tuple)) and values and \
            isinstance(values[0], (list, tuple, np.ndarray)):
        from .utils import object_column
        return object_column(values)
    try:
        arr = np.asarray(values)
    except ValueError:
        from .utils import object_column
        return object_column(values)
    if arr.dtype.kind == "U":  # normalize unicode to object for cheap appends
        arr = arr.astype(object)
    if arr.dtype.kind not in "bifuOSU" and arr.ndim == 0:
        raise TypeError(f"cannot build a column from {type(values)}")
    return arr


def _copy_meta(meta: dict[str, dict]) -> dict[str, dict]:
    """Deep-copy column metadata. Metadata is small nested dicts (MML_TAG ->
    {categorical: {...}, kind: ...}); sharing inner dicts across frames lets
    schema taggers mutate upstream frames, so copy all the way down."""
    import copy as _copy
    return {k: _copy.deepcopy(v) for k, v in meta.items()}


class DataFrame:
    """Immutable columnar table. All transforms return new frames (cheap —
    columns are shared, not copied)."""

    def __init__(self, data: dict[str, Any], metadata: Optional[dict[str, dict]] = None,
                 npartitions: int = 1):
        self._cols: dict[str, np.ndarray] = {}
        n = None
        for k, v in data.items():
            col = _as_column(v)
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(f"column {k!r} length {len(col)} != {n}")
            self._cols[k] = col
        self._n = 0 if n is None else n
        self._meta: dict[str, dict] = _copy_meta(metadata or {})
        self.npartitions = max(1, int(npartitions))

    # ---- construction ----
    @staticmethod
    def fromPandas(pdf, npartitions: int = 1) -> "DataFrame":
        return DataFrame({c: pdf[c].to_numpy() for c in pdf.columns},
                         npartitions=npartitions)

    @staticmethod
    def fromArrow(table, npartitions: int = 1) -> "DataFrame":
        data = {}
        for name, col in zip(table.column_names, table.columns):
            data[name] = col.to_numpy(zero_copy_only=False)
        return DataFrame(data, npartitions=npartitions)

    @staticmethod
    def fromArrowStream(source) -> "DataFrame":
        """Materialize an Arrow record-batch stream (reader, table, batch
        iterable, or IPC file path) — columnar all the way, no Python rows
        (io.arrow)."""
        from ..io.arrow import frame_from_arrow_stream
        return frame_from_arrow_stream(source)

    @staticmethod
    def fromRows(rows: Sequence[dict], npartitions: int = 1) -> "DataFrame":
        if not rows:
            return DataFrame({})
        keys = list(rows[0].keys())
        return DataFrame({k: [r[k] for r in rows] for k in keys},
                         npartitions=npartitions)

    # ---- basic introspection ----
    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def count(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def col(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        return self._cols[name]

    __getitem__ = col

    def dtypes(self) -> dict[str, np.dtype]:
        return {k: v.dtype for k, v in self._cols.items()}

    def metadata(self, name: str) -> dict:
        import copy as _copy
        return _copy.deepcopy(self._meta.get(name, {}))

    def schema(self) -> dict[str, dict]:
        return {k: {"dtype": str(v.dtype), "metadata": self.metadata(k)}
                for k, v in self._cols.items()}

    # ---- transforms (all return new DataFrames) ----
    def _derive(self, cols: dict[str, np.ndarray], meta: dict[str, dict]) -> "DataFrame":
        df = DataFrame({}, npartitions=self.npartitions)
        df._cols = cols
        df._n = len(next(iter(cols.values()))) if cols else 0
        df._meta = meta
        return df

    def select(self, *names: str) -> "DataFrame":
        flat: list[str] = []
        for n in names:
            flat.extend(n if isinstance(n, (list, tuple)) else [n])
        return self._derive({n: self.col(n) for n in flat},
                            _copy_meta({n: self._meta[n] for n in flat if n in self._meta}))

    def drop(self, *names: str) -> "DataFrame":
        dropset = set(names)
        return self._derive({k: v for k, v in self._cols.items() if k not in dropset},
                            _copy_meta({k: v for k, v in self._meta.items() if k not in dropset}))

    def withColumn(self, name: str, values, metadata: Optional[dict] = None) -> "DataFrame":
        col = _as_column(values)
        if self._cols and len(col) != self._n:
            raise ValueError(f"new column {name!r} length {len(col)} != {self._n}")
        cols = dict(self._cols)
        cols[name] = col
        meta = _copy_meta(self._meta)
        if metadata is not None:
            meta[name] = _copy_meta({name: metadata})[name]
        elif name in meta:
            del meta[name]  # replaced column loses stale metadata
        return self._derive(cols, meta)

    def withMetadata(self, name: str, metadata: dict) -> "DataFrame":
        self.col(name)
        meta = _copy_meta(self._meta)
        meta[name] = _copy_meta({name: metadata})[name]
        return self._derive(dict(self._cols), meta)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        cols = {}
        for k, v in self._cols.items():
            cols[new if k == old else k] = v
        meta = _copy_meta({(new if k == old else k): v for k, v in self._meta.items()})
        return self._derive(cols, meta)

    def filter(self, mask) -> "DataFrame":
        """mask: boolean array or row-dict predicate."""
        if callable(mask):
            mask = np.fromiter((bool(mask(r)) for r in self.iterRows()),
                               dtype=bool, count=self._n)
        mask = np.asarray(mask, dtype=bool)
        return self._derive({k: v[mask] for k, v in self._cols.items()},
                            _copy_meta(self._meta))

    where = filter

    def limit(self, n: int) -> "DataFrame":
        return self._derive({k: v[:n] for k, v in self._cols.items()},
                            _copy_meta(self._meta))

    def sort(self, name: str, ascending: bool = True) -> "DataFrame":
        order = np.argsort(self.col(name), kind="stable")
        if not ascending:
            order = order[::-1]
        return self._derive({k: v[order] for k, v in self._cols.items()},
                            _copy_meta(self._meta))

    def union(self, other: "DataFrame") -> "DataFrame":
        if set(self.columns) != set(other.columns):
            raise ValueError("union requires identical column sets")
        cols = {k: np.concatenate([self._cols[k], other._cols[k]]) for k in self._cols}
        return self._derive(cols, _copy_meta(self._meta))

    def dropna(self, subset: Optional[Sequence[str]] = None) -> "DataFrame":
        names = list(subset) if subset else self.columns
        mask = np.ones(self._n, dtype=bool)
        for nme in names:
            c = self.col(nme)
            if c.dtype.kind == "f":
                mask &= ~np.isnan(c)
            elif c.dtype.kind == "O":
                mask &= np.array([x is not None and x == x for x in c], dtype=bool)
        return self.filter(mask)

    def randomSplit(self, weights: Sequence[float], seed: int = 0) -> list["DataFrame"]:
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self._n)
        bounds = np.floor(np.cumsum(w) * self._n).astype(int)
        bounds[-1] = self._n  # cumsum rounding must not drop tail rows
        out, start = [], 0
        for b in bounds:
            idx = np.sort(perm[start:b])
            out.append(self._derive({k: v[idx] for k, v in self._cols.items()},
                                    _copy_meta(self._meta)))
            start = b
        return out

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        rng = np.random.default_rng(seed)
        mask = rng.random(self._n) < fraction
        return self.filter(mask)

    # ---- relational ops (Spark surface; numpy-vectorized host ops — the
    # data plane's job is shaping tables, device kernels do the heavy math) --
    def _key_ids(self, names: Sequence[str]):
        """Factorize composite keys -> (int group id per row,
        first-occurrence row per group id)."""
        cols = [self.col(n) for n in names]
        seen: dict[tuple, int] = {}
        ids = np.empty(self._n, dtype=np.int64)
        firsts: list[int] = []
        rows = zip(*[[_hashable(v) for v in c.tolist()] for c in cols])
        for i, t in enumerate(rows):
            g = seen.setdefault(t, len(seen))
            if g == len(firsts):
                firsts.append(i)
            ids[i] = g
        return ids, np.asarray(firsts, dtype=np.int64)

    def groupBy(self, *names: str) -> "GroupedData":
        return GroupedData(self, list(names))

    def distinct(self) -> "DataFrame":
        _, firsts = self._key_ids(self.columns)
        return self._derive({k: v[firsts] for k, v in self._cols.items()},
                            _copy_meta(self._meta))

    def join(self, other: "DataFrame", on, how: str = "inner",
             suffix: str = "_right") -> "DataFrame":
        """Hash join on key column(s). ``how``: inner|left|right|outer.
        Non-key right columns colliding with left names get ``suffix``;
        unmatched rows null-fill (ints widen to float64 + NaN, Spark's
        nullable semantics)."""
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"how must be inner|left|right|outer, got {how!r}")
        on = [on] if isinstance(on, str) else list(on)
        for k in on:  # validate keys exist on both sides (col() raises)
            self.col(k)
            other.col(k)
        # SQL join semantics: a null key matches NOTHING (null = null is not
        # true), while NaN keys DO equate (Spark's join comparator) — so the
        # groupBy/distinct null sentinel must not flow into the hash maps
        rmap: dict[tuple, list[int]] = {}
        for j, t in enumerate(zip(*[[_hashable(v) for v in other.col(k).tolist()]
                                    for k in on])):
            if _NULL_SENTINEL not in t:
                rmap.setdefault(t, []).append(j)
        li: list[int] = []
        ri: list[int] = []
        matched: set[int] = set()
        for i, t in enumerate(zip(*[[_hashable(v) for v in self.col(k).tolist()]
                                    for k in on])):
            js = None if _NULL_SENTINEL in t else rmap.get(t)
            if js:
                for j in js:
                    li.append(i)
                    ri.append(j)
                if how in ("right", "outer"):
                    matched.update(js)
            elif how in ("left", "outer"):
                li.append(i)
                ri.append(-1)
        if how in ("right", "outer"):
            for j in range(other.count()):
                if j not in matched:
                    li.append(-1)
                    ri.append(j)
        lidx = np.asarray(li, dtype=np.int64)
        ridx = np.asarray(ri, dtype=np.int64)
        cols: dict[str, np.ndarray] = {}
        meta: dict[str, dict] = {}
        for k, v in self._cols.items():
            if k in on:
                # a key VALUE exists on >=1 side of every output row (null-
                # keyed rows emit with their own None key, object dtype), so
                # take raw values from whichever side matched — no NaN
                # widening of numeric keys
                rv = other.col(k)
                lg = _safe_take(v, lidx)
                rg = _safe_take(rv, ridx)
                if v.dtype == rv.dtype and v.dtype.kind != "O":
                    src = np.where(lidx >= 0, lg, rg)
                else:
                    src = np.array([a if i >= 0 else b for i, a, b
                                    in zip(lidx, lg, rg)], dtype=object)
            else:
                src = _gather_with_nulls(v, lidx)
            cols[k] = src
            if k in self._meta:
                meta[k] = self._meta[k]
        for k, v in other._cols.items():
            if k in on:
                continue
            name = k + suffix if k in cols else k
            cols[name] = _gather_with_nulls(v, ridx)
            if k in other._meta:
                meta[name] = other._meta[k]
        return DataFrame(cols, metadata=meta, npartitions=self.npartitions)

    # ---- partition semantics ----
    def repartition(self, n: int) -> "DataFrame":
        df = self._derive(dict(self._cols), _copy_meta(self._meta))
        df.npartitions = max(1, int(n))
        return df

    coalesce = repartition

    def partitionBounds(self) -> list[tuple[int, int]]:
        edges = np.linspace(0, self._n, self.npartitions + 1).astype(int)
        return [(int(edges[i]), int(edges[i + 1])) for i in range(self.npartitions)]

    def partitions(self) -> Iterator["DataFrame"]:
        for lo, hi in self.partitionBounds():
            yield self._derive({k: v[lo:hi] for k, v in self._cols.items()},
                               _copy_meta(self._meta))

    def mapPartitions(self, fn: Callable[["DataFrame"], "DataFrame"]) -> "DataFrame":
        parts = [fn(p) for p in self.partitions()]
        parts = [p for p in parts if p is not None and len(p.columns)]
        if not parts:
            return DataFrame({})
        names = parts[0].columns
        for p in parts[1:]:
            if set(p.columns) != set(names):
                raise ValueError("mapPartitions results have differing columns")
        cols = {k: np.concatenate([p._cols[k] for p in parts]) for k in names}
        out = parts[0]._derive(cols, _copy_meta(parts[0]._meta))
        out.npartitions = self.npartitions
        return out

    # ---- no-op persistence hooks (API parity with Spark-side Cacher etc.) ----
    def cache(self) -> "DataFrame":
        return self

    persist = cache

    def unpersist(self) -> "DataFrame":
        return self

    # ---- export ----
    def iterRows(self) -> Iterator[dict]:
        names = self.columns
        cols = [self._cols[n] for n in names]
        for i in range(self._n):
            yield {n: c[i] for n, c in zip(names, cols)}

    def collect(self) -> list[dict]:
        return list(self.iterRows())

    def head(self, n: int = 5) -> list[dict]:
        return self.limit(n).collect()

    def first(self) -> dict:
        if self._n == 0:
            raise IndexError("empty DataFrame")
        return next(self.iterRows())

    def toPandas(self):
        import pandas as pd
        return pd.DataFrame({k: list(v) if v.ndim > 1 or v.dtype.kind == "O" else v
                             for k, v in self._cols.items()})

    def toArrow(self):
        import pyarrow as pa
        return pa.table({k: pa.array(list(v)) if v.dtype.kind == "O" else pa.array(v)
                         for k, v in self._cols.items()})

    def iterBatches(self, batch_size: int) -> Iterator["DataFrame"]:
        for lo in range(0, self._n, batch_size):
            hi = min(lo + batch_size, self._n)
            yield self._derive({k: v[lo:hi] for k, v in self._cols.items()},
                               _copy_meta(self._meta))

    def __repr__(self):
        spec = ", ".join(f"{k}:{v.dtype}" for k, v in self._cols.items())
        return f"DataFrame[{self._n} rows, {self.npartitions} parts]({spec})"


#: Dict-key stand-ins for NaN / null cells so grouping/distinct/join treat
#: all NaN keys as equal (Spark normalizes NaN equality in these ops; the
#: IEEE default nan != nan would otherwise make every NaN row its own group)
#: and all nulls as equal — but NaN and null stay DISTINCT groups, matching
#: Spark (null is absence, NaN is a float value).
_NAN_SENTINEL = ("__mmltpu_nan__",)
_NULL_SENTINEL = ("__mmltpu_null__",)


def _hashable(v):
    """Dict-key form of a cell value (vector cells -> bytes/tuples,
    struct cells like image rows -> sorted item tuples)."""
    if isinstance(v, np.ndarray):
        return (v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if v is None:
        return _NULL_SENTINEL
    if isinstance(v, float) and v != v:
        return _NAN_SENTINEL
    return v


def _safe_take(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """col[clip(idx)] that tolerates an EMPTY col (all idx are then -1 and
    the values are placeholders the caller masks out)."""
    if len(col) == 0:
        if col.dtype.kind == "O":
            return np.full(len(idx), None, dtype=object)
        return np.zeros(len(idx), dtype=col.dtype)
    return col[np.clip(idx, 0, None)]


def _gather_with_nulls(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """col[idx] where idx==-1 yields null: NaN for floats (ints widen to
    float64, Spark's nullable-column semantics), None for object columns."""
    if len(col) == 0:  # empty join side: every row is null
        if col.dtype.kind == "O":
            return np.full(len(idx), None, dtype=object)
        return np.full(len(idx), np.nan, dtype=np.float64)
    missing = idx < 0
    safe = np.clip(idx, 0, None)
    if not missing.any():
        return col[safe]
    if col.dtype.kind == "f":
        out = col[safe].copy()
        out[missing] = np.nan
        return out
    if col.dtype.kind in "iub":
        out = col[safe].astype(np.float64)
        out[missing] = np.nan
        return out
    out = col[safe].astype(object)
    out[missing] = None
    return out


_AGG_REDUCERS = {"sum": np.add, "min": np.minimum, "max": np.maximum}


class GroupedData:
    """Result of ``DataFrame.groupBy`` — Spark-style aggregation surface.

    Aggregations run sorted-by-group with ``ufunc.reduceat`` (one vectorized
    pass per (column, fn), no per-group Python loop). Functions: count, sum,
    mean, min, max, first, collect_list (object columns support the last
    three plus count).
    """

    def __init__(self, df: DataFrame, keys: list[str]):
        if not keys:
            raise ValueError("groupBy needs at least one key column")
        self._df = df
        self._keys = keys
        self._ids, self._firsts = df._key_ids(keys)
        # one sort shared by every aggregation in this groupBy
        self._order = np.argsort(self._ids, kind="stable")
        sorted_ids = self._ids[self._order]
        self._starts = (np.flatnonzero(
            np.r_[True, sorted_ids[1:] != sorted_ids[:-1]])
            if len(sorted_ids) else np.empty(0, dtype=np.int64))

    def _key_frame(self) -> dict[str, np.ndarray]:
        out = {}
        for k in self._keys:
            out[k] = self._df.col(k)[self._firsts]
        return out

    def _key_meta(self) -> dict[str, dict]:
        return {k: self._df._meta[k] for k in self._keys
                if k in self._df._meta}

    def _grouped(self, name: str):
        """(values sorted by group id, segment starts) for reduceat."""
        return self._df.col(name)[self._order], self._starts

    def rowGroupIds(self) -> np.ndarray:
        """Group id per ORIGINAL row (first-occurrence order, matching the
        row order of agg()/count() output) — lets callers broadcast
        aggregates back onto the ungrouped frame."""
        return self._ids.copy()

    def agg(self, spec: Optional[dict] = None, /, **named) -> DataFrame:
        """``agg({"col": "mean"})`` -> column ``mean(col)`` (Spark naming), or
        ``agg(out=("col", "mean"))`` for explicit output names."""
        items: list[tuple[str, str, str]] = []  # (out_name, col, fn)
        for col, fn in (spec or {}).items():
            items.append((f"{fn}({col})", col, fn))
        for out, (col, fn) in named.items():
            items.append((out, col, fn))
        if not items:
            raise ValueError("agg needs at least one aggregation")
        clash = [out for out, _, _ in items if out in self._keys]
        if clash:
            raise ValueError(
                f"aggregation output name(s) {clash} collide with group "
                f"key columns; pick different output names")
        cols = self._key_frame()
        n_groups = len(self._firsts)
        counts = np.bincount(self._ids, minlength=n_groups)
        stacked: dict = {}  # per-source-column cell matrix, reused across fns
        for out, col, fn in items:
            if fn == "count":
                cols[out] = counts.astype(np.int64)
                continue
            vals, starts = self._grouped(col)
            if fn == "first":
                cols[out] = self._df.col(col)[self._firsts]
            elif fn == "collect_list":
                from .utils import object_column
                cols[out] = object_column(
                    [list(vals[s:e]) for s, e in
                     zip(starts, np.r_[starts[1:], len(vals)])])
            elif fn in ("sum", "mean") and vals.dtype.kind == "O":
                # vector-valued cells (object column of equal-shape
                # arrays): stack once per source column, segment-reduce
                from .utils import object_column
                if len(vals) == 0:
                    cols[out] = object_column([])
                    continue
                if col not in stacked:
                    try:
                        stacked[col] = np.stack(
                            [np.asarray(v, dtype=np.float64) for v in vals])
                    except (ValueError, TypeError) as e:
                        raise TypeError(
                            f"{fn} on object column {col!r} needs numeric "
                            f"array cells of one common shape ({e})") from e
                mat = stacked[col]
                seg = np.add.reduceat(mat, starts, axis=0)
                if fn == "mean":
                    # divide along the GROUP axis only, whatever the cell rank
                    seg = seg / counts.reshape((-1,) + (1,) * (seg.ndim - 1))
                if mat.ndim < 2:  # numeric scalar cells -> plain column
                    cols[out] = seg
                else:
                    cols[out] = object_column(list(seg))
            elif fn in ("sum", "min", "max"):
                if vals.dtype.kind == "O":
                    raise TypeError(f"{fn} needs a numeric column, "
                                    f"{col!r} is object-typed")
                cols[out] = _AGG_REDUCERS[fn].reduceat(vals, starts)
            elif fn == "mean":
                cols[out] = (np.add.reduceat(vals.astype(np.float64), starts)
                             / counts)
            else:
                raise ValueError(f"unknown aggregation {fn!r}")
        return DataFrame(cols, metadata=self._key_meta(),
                         npartitions=self._df.npartitions)

    def count(self) -> DataFrame:
        if "count" in self._keys:
            raise ValueError("a group key is named 'count'; use "
                             "agg(<name>=(key, 'count')) instead")
        cols = self._key_frame()
        cols["count"] = np.bincount(
            self._ids, minlength=len(self._firsts)).astype(np.int64)
        return DataFrame(cols, metadata=self._key_meta(),
                         npartitions=self._df.npartitions)

    def _all_numeric(self, fn: str, names) -> DataFrame:
        names = list(names) or [c for c in self._df.columns
                                if c not in self._keys
                                and self._df.col(c).dtype.kind in "biuf"]
        if not names:  # no numeric columns: keys only (Spark behavior)
            return DataFrame(self._key_frame(), metadata=self._key_meta(),
                             npartitions=self._df.npartitions)
        return self.agg({c: fn for c in names})

    def sum(self, *names: str) -> DataFrame:
        return self._all_numeric("sum", names)

    def mean(self, *names: str) -> DataFrame:
        return self._all_numeric("mean", names)

    avg = mean

    def min(self, *names: str) -> DataFrame:
        return self._all_numeric("min", names)

    def max(self, *names: str) -> DataFrame:
        return self._all_numeric("max", names)
