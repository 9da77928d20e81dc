"""Distributed data plane: per-rank DataFrame shards (the port of
``mmlspark_tpu/parallel/dataplane.py``).

Each rank of the process group (``parallel.distributed``) holds a
:class:`ShardedDataFrame` — ITS rows only, e.g. read from its share of the
input files (:func:`shard_paths`). Row-wise transforms run on the local
shard with no communication; global relational ops (groupBy/agg, distinct,
join, limit) run as a local partial aggregation, an object gather and a
re-aggregation. ``TorchLearner.fit`` and ``TorchModel.transform`` take
per-rank shards as they are.

The gathers are host-side: pickled objects cross as CPU byte tensors over
the gloo group ``distributed.host_group()`` (lengths first, then
right-padded buffers), so they work the same under an NCCL default group
and never interleave with a training thread's device collectives. With no
process group every op degrades to the plain DataFrame behaviour.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.dataframe import (DataFrame, GroupedData, _NULL_SENTINEL,
                              _copy_meta, _gather_with_nulls, _hashable)
from ..core.utils import get_logger, object_column
from .. import telemetry
from ..resilience import faults
from . import mesh as _meshlib

log = get_logger("dataplane")

# host-collective telemetry: every object gather the data plane runs
_m_collective_bytes = telemetry.registry.counter(
    "mmlspark_dataplane_collective_bytes",
    "payload bytes this process contributed to host collectives")
_m_collectives = telemetry.registry.counter(
    "mmlspark_dataplane_collectives",
    "host collective operations issued (allgather_bytes calls)")


def nprocs() -> int:
    return _meshlib.effective_process_count()


def pid() -> int:
    # local-fit mode presents a single-process world: pid is 0 when
    # nprocs() reports 1, or shard_paths-style arithmetic drops data
    return _meshlib.process_index()


def shard_paths(paths: Sequence[str]) -> list[str]:
    """THIS rank's share of an input file list (deterministic round-robin
    over the sorted list, so the ranks partition the corpus exactly)."""
    return sorted(paths)[pid()::nprocs()]


def _gather_tensor(t: torch.Tensor, group) -> list:
    out = [torch.empty_like(t) for _ in range(nprocs())]
    torch.distributed.all_gather(out, t, group=group)
    return out


def allgather_bytes(payload: bytes) -> list[bytes]:
    """Gather one bytes payload from every rank, in rank order (two
    gathers: lengths, then right-padded buffers)."""
    faults.inject("dataplane.allgather")
    if nprocs() == 1:
        return [payload]
    _m_collectives.inc()
    _m_collective_bytes.inc(len(payload))
    from . import distributed
    group = distributed.host_group()
    dev = torch.device("cpu") if group is not None else distributed.device()
    with telemetry.trace.span("dataplane/allgather", bytes=len(payload)):
        lens = _gather_tensor(torch.tensor([len(payload)], dtype=torch.int64,
                                           device=dev), group)
        lens = [int(x.item()) for x in lens]
        buf = torch.zeros(max(lens), dtype=torch.uint8)
        if payload:
            buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                                  dtype=torch.uint8)
        bufs = _gather_tensor(buf.to(dev), group)
    return [b[:n].cpu().numpy().tobytes() for b, n in zip(bufs, lens)]


def allgather_pyobj(obj) -> list:
    """Gather an arbitrary picklable object from every rank, in rank order.
    The workhorse for merging fitted statistics (categorical level sets,
    imputation sums, partial aggregates) across the ranks."""
    return [pickle.loads(b) for b in allgather_bytes(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))]


def proportional_sample_cap(n_local: int, target: int) -> int:
    """How many of this rank's ``n_local`` rows belong in a pooled sample of
    ~``target`` rows: contribution proportional to real shard size. One
    gather; every rank must call it together."""
    sizes = allgather_pyobj(int(n_local))
    total = max(1, sum(sizes))
    return max(1, int(round(target * n_local / total)))


def allreduce_sum(x):
    """Elementwise sum of a numeric array over all ranks (in rank order)."""
    if nprocs() == 1:
        return np.asarray(x)
    return np.stack([np.asarray(p) for p in
                     allgather_pyobj(np.asarray(x))]).sum(axis=0)


def is_sharded(df) -> bool:
    """True when ``df`` is one process's shard of a fleet-wide frame AND the
    fleet has >1 process (single-process sharded frames behave plainly)."""
    return isinstance(df, ShardedDataFrame) and nprocs() > 1


def _gather_frames(df: DataFrame) -> DataFrame:
    """Union of every rank's rows (replicated result on all processes).
    Only for results already reduced small — partial aggregates, distinct
    keys, broadcast-join sides — never the raw data plane."""
    parts = allgather_pyobj((df._cols, df._meta))
    out: Optional[DataFrame] = None
    for cols, meta in parts:
        part = DataFrame(dict(cols), metadata=meta)
        out = part if out is None else out.union(part)
    return out if out is not None else DataFrame({})


class ShardedDataFrame(DataFrame):
    """One process's shard of a fleet-wide DataFrame.

    Inherited row-wise ops (select/filter/withColumn/transform stages/…)
    run on the local rows — the mapPartitions analog. ``count()`` /
    ``collect()`` are the LOCAL shard (the SPMD contract: code runs
    per-process); use :meth:`globalCount` / :meth:`collectGlobal` for
    fleet-wide views. Relational ops with cross-row semantics (groupBy,
    distinct, join, limit) are overridden with distributed implementations.
    """

    @classmethod
    def fromLocal(cls, df: DataFrame) -> "ShardedDataFrame":
        out = cls({}, npartitions=df.npartitions)
        out._cols = dict(df._cols)
        out._n = df._n
        out._meta = _copy_meta(df._meta)
        return out

    def _derive(self, cols, meta) -> "ShardedDataFrame":
        df = ShardedDataFrame({}, npartitions=self.npartitions)
        df._cols = cols
        df._n = len(next(iter(cols.values()))) if cols else 0
        df._meta = meta
        return df

    def localFrame(self) -> DataFrame:
        """This shard as a plain (non-sharded) DataFrame."""
        df = DataFrame({}, npartitions=self.npartitions)
        df._cols = dict(self._cols)
        df._n = self._n
        df._meta = _copy_meta(self._meta)
        return df

    # ---- fleet-wide views ----
    def globalCount(self) -> int:
        return int(allreduce_sum(np.asarray(self._n, np.int64)))

    def collectGlobal(self) -> list[dict]:
        """All rows from all processes (explicit materialization — the one
        API that deliberately breaks the never-gather-the-data-plane rule,
        like Spark's collect())."""
        return [r for part in allgather_pyobj(self.collect()) for r in part]

    # ---- distributed relational ops ----
    def groupBy(self, *names: str) -> "ShardedGroupedData":
        return ShardedGroupedData(self, list(names))

    def distinct(self) -> DataFrame:
        """Global distinct: local distinct -> allgather -> re-distinct.
        Result is a REPLICATED plain DataFrame (identical on every
        process, in every fleet size — so single-process code can't grow a
        dependency on shardedness that a real fleet would break)."""
        local = super().distinct().localFrame()
        if nprocs() == 1:
            return local
        return _gather_frames(local).distinct()

    def limit(self, n: int) -> "ShardedDataFrame":
        """First ``n`` rows fleet-wide, in process order: process 0
        contributes up to n, process 1 the remainder, etc."""
        if nprocs() == 1:
            return super().limit(n)
        counts = allgather_pyobj(self._n)
        before = sum(counts[:pid()])
        take = max(0, min(self._n, n - before))
        return super().limit(take)

    def sort(self, name: str, ascending: bool = True):
        raise NotImplementedError(
            "global sort on a sharded frame is not supported (it would "
            "require a range shuffle); sort after aggregation — distributed "
            "groupBy/distinct return replicated plain DataFrames that sort "
            "normally — or call .localFrame().sort() for per-shard order")

    def join(self, other: DataFrame, on, how: str = "inner",
             suffix: str = "_right") -> "ShardedDataFrame":
        """Broadcast hash join: ``other`` (the small side — a dimension
        table, an aggregate) is gathered to every process, then each shard
        joins locally; the output stays sharded. For right/outer, right
        rows unmatched by ANY process's shard are emitted once (process 0),
        so global row multiplicity matches the single-frame semantics.

        The reference gets the same shape from Spark broadcast joins; the
        big-big shuffle join has no analog here — repartition by key
        upstream (e.g. at ingest) instead."""
        if nprocs() == 1:
            return ShardedDataFrame.fromLocal(super().join(
                other, on, how=how, suffix=suffix))
        right = (_gather_frames(other) if isinstance(other, ShardedDataFrame)
                 else other)
        keys = [on] if isinstance(on, str) else list(on)
        if how in ("right", "outer"):
            # which right rows does ANY shard match? (global decision)
            lkeys = {t for t in zip(*[[_hashable(v) for v in
                                       self.col(k).tolist()] for k in keys])}
            lkeys = set().union(*allgather_pyobj(lkeys))
            rk = list(zip(*[[_hashable(v) for v in right.col(k).tolist()]
                            for k in keys]))
            # null keys match nothing (SQL join semantics, core join rule)
            matched = np.array([_NULL_SENTINEL not in t and t in lkeys
                                for t in rk], dtype=bool)
            local_how = "left" if how == "outer" else "inner"
            out = super().join(right, on, how=local_how, suffix=suffix)
            if pid() == 0 and (~matched).any():
                extra = self._null_left_join_rows(right, keys, ~matched,
                                                  suffix, out.columns)
                out = out.union(extra)
            return ShardedDataFrame.fromLocal(out)
        out = super().join(right, on, how=how, suffix=suffix)
        return ShardedDataFrame.fromLocal(out)

    def _null_left_join_rows(self, right: DataFrame, keys, mask,
                             suffix: str, out_columns) -> DataFrame:
        """Rows for right-side records no shard matched: key columns from
        the right, every left non-key column null-filled."""
        ridx = np.flatnonzero(mask)
        cols: dict[str, np.ndarray] = {}
        for name in out_columns:
            if name in keys:
                cols[name] = right.col(name)[ridx]
            elif name.endswith(suffix) and name[:-len(suffix)] in right.columns \
                    and name[:-len(suffix)] in self.columns:
                cols[name] = right.col(name[:-len(suffix)])[ridx]
            elif name in right.columns and name not in self.columns:
                cols[name] = right.col(name)[ridx]
            else:  # left-only column: null-fill
                cols[name] = _gather_with_nulls(
                    self.col(name), np.full(len(ridx), -1, np.int64))
        return DataFrame(cols)


#: second-stage merge plan per aggregation fn: how per-process partial
#: aggregates combine into the global value. mean decomposes into sum+count.
_MERGEABLE = {"sum": "sum", "min": "min", "max": "max", "count": "sum",
              "first": "first"}


class ShardedGroupedData:
    """groupBy on a sharded frame: per-process partial aggregation (one
    GroupedData pass over the local shard — the map-side combine), an
    allgather of the small partial tables, and a re-aggregation. Result is
    a REPLICATED plain DataFrame, identical on every process."""

    def __init__(self, df: ShardedDataFrame, keys: list[str]):
        if not keys:
            raise ValueError("groupBy needs at least one key column")
        self._df = df
        self._keys = keys

    def _local(self) -> GroupedData:
        return GroupedData(self._df, self._keys)

    def agg(self, spec: Optional[dict] = None, /, **named) -> DataFrame:
        if nprocs() == 1:
            return self._local().agg(spec, **named)
        items: list[tuple[str, str, str]] = []
        for col, fn in (spec or {}).items():
            items.append((f"{fn}({col})", col, fn))
        for out, (col, fn) in named.items():
            items.append((out, col, fn))
        if not items:
            raise ValueError("agg needs at least one aggregation")
        clash = [out for out, _, _ in items if out in self._keys]
        if clash:  # same contract as the single-frame GroupedData.agg
            raise ValueError(
                f"aggregation output name(s) {clash} collide with group "
                f"key columns; pick different output names")
        # stage 1: local partials. mean -> (sum, count); collect_list stays
        # a list and flattens after the merge.
        partial_spec: dict[str, tuple[str, str]] = {}
        for i, (out, col, fn) in enumerate(items):
            if fn == "mean":
                partial_spec[f"__s{i}"] = (col, "sum")
                partial_spec[f"__c{i}"] = (col, "count")
            elif fn == "collect_list":
                partial_spec[f"__p{i}"] = (col, "collect_list")
            elif fn in _MERGEABLE:
                partial_spec[f"__p{i}"] = (col, fn)
            else:
                raise ValueError(f"unknown aggregation {fn!r}")
        local = self._local().agg(**partial_spec)
        merged = _gather_frames(local)
        g = merged.groupBy(*self._keys)
        # stage 2: merge partials across processes
        merge_spec: dict[str, tuple[str, str]] = {}
        for i, (out, col, fn) in enumerate(items):
            if fn == "mean":
                merge_spec[f"__s{i}"] = (f"__s{i}", "sum")
                merge_spec[f"__c{i}"] = (f"__c{i}", "sum")
            elif fn == "collect_list":
                merge_spec[f"__p{i}"] = (f"__p{i}", "collect_list")
            else:
                merge_spec[f"__p{i}"] = (f"__p{i}", _MERGEABLE[fn])
        out_df = g.agg(**merge_spec)
        cols = {k: out_df.col(k) for k in self._keys}
        for i, (out, col, fn) in enumerate(items):
            if fn == "mean":
                s = out_df.col(f"__s{i}")
                c = out_df.col(f"__c{i}")
                if s.dtype.kind == "O":  # vector cells
                    cols[out] = object_column(
                        [np.asarray(v) / n for v, n in zip(s, c)])
                else:
                    cols[out] = s.astype(np.float64) / c
            elif fn == "collect_list":  # flatten the per-process lists
                cols[out] = object_column(
                    [[x for part in nested for x in part]
                     for nested in out_df.col(f"__p{i}")])
            elif fn == "count":
                cols[out] = out_df.col(f"__p{i}").astype(np.int64)
            else:
                cols[out] = out_df.col(f"__p{i}")
        meta = {k: self._df._meta[k] for k in self._keys
                if k in self._df._meta}
        return DataFrame(cols, metadata=meta)

    def count(self) -> DataFrame:
        if "count" in self._keys:
            raise ValueError("a group key is named 'count'; use "
                             "agg(<name>=(key, 'count')) instead")
        out = self.agg(__n=(self._keys[0], "count"))
        return out.withColumnRenamed("__n", "count")

    def rowGroupIds(self) -> np.ndarray:
        """LOCAL rows' group ids (local numbering — fleet-wide group ids
        would require a key shuffle; local ids are what per-shard
        broadcast-back consumers need)."""
        return self._local().rowGroupIds()

    def _all_numeric(self, fn: str, names) -> DataFrame:
        names = list(names) or [c for c in self._df.columns
                                if c not in self._keys
                                and self._df.col(c).dtype.kind in "biuf"]
        if not names:
            return self.agg(__n=(self._keys[0], "count")).drop("__n")
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
