"""Process-global metrics registry: counters, gauges, histograms.

The runtime-observability analog of the reference's ``core/metrics`` layer
(PAPER.md §1): every subsystem registers named metrics once at import and
updates them from its hot path. Three design rules keep that affordable:

  * **off-by-default-cheap** — every mutator's first statement is a single
    attribute lookup (``_state.enabled``); with telemetry disabled (the
    default) a counter ``inc()`` is one lookup + an early return, no locks,
    no allocation, no time syscalls;
  * **thread-safe when on** — serving loops, the fleet driver, and tuner
    pools update metrics concurrently; each metric guards its mutable cells
    with its own lock (never a registry-wide one);
  * **fixed histogram buckets** — bucket boundaries are chosen at
    registration (Prometheus-style cumulative ``le`` buckets), so exposition
    is O(buckets) and observation is a bisect, never a resize.

Exposition: :meth:`MetricsRegistry.prometheus_text` (the ``/metrics`` wire
format) and :meth:`MetricsRegistry.snapshot` (JSON-able dict for BENCH
artifacts and tests).

The PyTorch port's own copy of ``mmlspark_tpu/telemetry/registry.py`` (it
imports no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Optional, Sequence


class _State:
    """The one flag every metric mutator checks first."""

    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = False


_state = _State()

#: Prometheus-style latency buckets (seconds) — sub-ms dispatches up to
#: minute-scale epoch dispatches.
DEFAULT_TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def pow2_buckets(lo: int, hi: int) -> tuple:
    """Power-of-two boundaries [lo, 2lo, ..., >=hi] for size/row counts."""
    out = []
    b = max(1, lo)
    while b < hi:
        out.append(float(b))
        b <<= 1
    out.append(float(b))
    return tuple(out)


def _fmt(v: float) -> str:
    """Prometheus number formatting: integers without the trailing .0."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    """Prometheus text-exposition label-value escaping: backslash, double
    quote and newline must be escaped or a value like ``path="a\nb"``
    corrupts every following line of the scrape."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Shared family plumbing: a metric with label names is a FAMILY whose
    ``labels(**kv)`` returns (creating once) the child holding the cells;
    an unlabeled metric holds its own cells."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 label_values: Sequence[str] = ()):
        self.name = name
        self.help = help
        self._label_names = tuple(label_names)
        self._label_values = tuple(label_values)
        self._children: dict[tuple, _Metric] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        # mutation revision: bumped under the cell lock on every write so
        # snapshot_delta can skip unchanged families without diffing their
        # cells (one int add on a lock already held — no new contention)
        self._rev = 0   # guarded-by: _lock
        self._init_cells()

    def _init_cells(self):
        pass

    def labels(self, **kv) -> "_Metric":
        if tuple(sorted(kv)) != tuple(sorted(self._label_names)):
            raise ValueError(f"metric {self.name!r} takes labels "
                             f"{self._label_names}, got {tuple(kv)}")
        key = tuple(str(kv[k]) for k in self._label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = type(self)(self.name, self.help, (), key,
                                       **self._child_kwargs())
                    self._children[key] = child
        return child

    def _child_kwargs(self) -> dict:
        return {}

    def _series(self):
        """(label_values, metric) rows to expose — children if labeled,
        self otherwise."""
        if self._label_names:
            with self._lock:
                return [(k, c) for k, c in sorted(self._children.items())]
        return [(self._label_values, self)]

    def family_rev(self) -> int:
        """Monotonic change token for this family: the sum of every
        series' revision counter (plain int reads; exactness under
        concurrent writes doesn't matter — any concurrent write also
        changes the NEXT read, so a sampler converges one tick later)."""
        return sum(m._rev for _vals, m in self._series())


class Counter(_Metric):
    """Monotonically increasing float."""

    kind = "counter"

    def _init_cells(self):
        self._value = 0.0   # guarded-by: _lock

    def inc(self, amount: float = 1.0):
        if not _state.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._value += amount
            self._rev += 1

    @property
    def value(self) -> float:
        return self._value

    def _expose(self, out: list, names):
        # exposition carries the conventional `_total` suffix; a family
        # registered WITH the suffix already (several resilience counters)
        # must not gain a second one — `..._total_total` broke dashboards
        # built from the docs/observability.md catalogue
        base = (self.name if self.name.endswith("_total")
                else f"{self.name}_total")
        for vals, m in self._series():
            out.append(f"{base}{_label_str(names, vals)} "
                       f"{_fmt(m._value)}")

    def _snap(self, vals, m):
        return {"value": m._value}


class Gauge(_Metric):
    """Set-to-current-value metric (queue depth, rows/sec, bytes held)."""

    kind = "gauge"

    def _init_cells(self):
        self._value = 0.0   # guarded-by: _lock

    def set(self, value: float):
        if not _state.enabled:
            return
        with self._lock:
            self._value = float(value)
            self._rev += 1

    def inc(self, amount: float = 1.0):
        if not _state.enabled:
            return
        with self._lock:
            self._value += amount
            self._rev += 1

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def _expose(self, out: list, names):
        for vals, m in self._series():
            out.append(f"{self.name}{_label_str(names, vals)} "
                       f"{_fmt(m._value)}")

    def _snap(self, vals, m):
        return {"value": m._value}


class Histogram(_Metric):
    """Fixed-boundary cumulative histogram (Prometheus ``le`` semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 label_values: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS):
        self._bounds = tuple(sorted(float(b) for b in buckets))
        if not self._bounds:
            raise ValueError(f"histogram {name!r} needs >= 1 bucket bound")
        super().__init__(name, help, label_names, label_values)

    def _child_kwargs(self) -> dict:
        return {"buckets": self._bounds}

    def _init_cells(self):
        # per-bound counts + overflow slot; cumulated only at exposition
        self._counts = [0] * (len(self._bounds) + 1)  # guarded-by: _lock
        self._sum = 0.0   # guarded-by: _lock
        self._n = 0       # guarded-by: _lock
        # OpenMetrics exemplars: bucket index -> (trace_id, observed
        # value); last-writer-wins per bucket, only attached when the
        # observe site passes a retained trace id
        self._exemplars: dict[int, tuple[str, float]] = {}  # guarded-by: _lock

    def observe(self, value: float, exemplar: Optional[str] = None):
        if not _state.enabled:
            return
        # bisect_LEFT: a value equal to a bucket bound lands in the bucket
        # whose ``le`` it equals (Prometheus <= semantics); bisect_right
        # would push it one bucket up
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._n += 1
            self._rev += 1
            if exemplar:
                self._exemplars[i] = (str(exemplar), float(value))

    def time(self):
        """Context manager observing the body's wall seconds."""
        return _HistTimer(self)

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def bucket_counts(self) -> dict:
        """Cumulative {le_bound: count} including +Inf."""
        out, cum = {}, 0
        for b, c in zip(self._bounds + (math.inf,), self._counts):
            cum += c
            out[b] = cum
        return out

    def _expose(self, out: list, names):
        for vals, m in self._series():
            with m._lock:
                exemplars = dict(m._exemplars)
            for i, (b, cum) in enumerate(m.bucket_counts().items()):
                lab = _label_str(names + ("le",), vals + (_fmt(b),))
                line = f"{self.name}_bucket{lab} {cum}"
                ex = exemplars.get(i)
                if ex is not None:
                    # OpenMetrics exemplar: the retained trace that
                    # landed in this bucket, fetchable via /debug/trace
                    line += f' # {{trace_id="{_escape_label(ex[0])}"}} ' \
                            f"{_fmt(ex[1])}"
                out.append(line)
            lab = _label_str(names, vals)
            out.append(f"{self.name}_sum{lab} {_fmt(m._sum)}")
            out.append(f"{self.name}_count{lab} {m._n}")

    def _snap(self, vals, m):
        out = {"count": m._n, "sum": m._sum,
               "buckets": {_fmt(b): c
                           for b, c in m.bucket_counts().items()}}
        with m._lock:
            exemplars = dict(m._exemplars)
        if exemplars:
            bounds = m._bounds + (math.inf,)
            out["exemplars"] = {
                _fmt(bounds[i]): {"trace_id": tid, "value": v}
                for i, (tid, v) in sorted(exemplars.items())}
        return out


class _HistTimer:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: Histogram):
        self._h = h

    def __enter__(self):
        import time
        self._t0 = time.perf_counter() if _state.enabled else 0.0
        return self

    def __exit__(self, *exc):
        if _state.enabled:
            import time
            self._h.observe(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Get-or-create registry; re-registering a name returns the existing
    family (so module-level handles across subsystems share series)."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}   # guarded-by: _lock
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labels: Sequence[str],
             **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help, tuple(labels), **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  labels: Sequence[str] = ()) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def prometheus_text(self) -> str:
        """The ``GET /metrics`` payload (Prometheus text exposition 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            families = sorted(self._metrics.items())
        for name, m in families:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            m._expose(lines, m._label_names)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able {name: {type, help, series: [{labels, ...cells}]}}."""
        out = {}
        with self._lock:
            families = sorted(self._metrics.items())
        for name, m in families:
            out[name] = self._snap_family(m)
        return out

    @staticmethod
    def _snap_family(m: _Metric) -> dict:
        return {
            "type": m.kind, "help": m.help,
            "series": [dict(labels=dict(zip(m._label_names, vals)),
                            **m._snap(vals, child))
                       for vals, child in m._series()]}

    def snapshot_delta(self, since: Optional[dict] = None
                       ) -> tuple[dict, dict]:
        """``(changed, token)``: the :meth:`snapshot` entries of every
        family whose revision moved since ``since`` (a token from a prior
        call; ``None`` = everything), plus the new token to pass next
        time.

        The periodic time-series sampler's API: on a quiet process a tick
        costs one int-sum per family instead of rebuilding and diffing the
        full snapshot dict. Unchanged families are simply absent — the
        caller carries their last value forward."""
        with self._lock:
            families = sorted(self._metrics.items())
        changed: dict = {}
        token: dict = {}
        for name, m in families:
            rev = m.family_rev()
            token[name] = rev
            if since is None or since.get(name) != rev:
                changed[name] = self._snap_family(m)
        return changed, token

    def reset(self):
        """Zero every cell IN PLACE (tests only). Families and children
        survive — instrument sites hold module-level handles registered at
        import, and dropping families would detach them silently."""
        with self._lock:
            families = list(self._metrics.values())
        for m in families:
            with m._lock:
                for child in list(m._children.values()) + [m]:
                    child._init_cells()
                    # a reset IS a change: revs stay monotonic so a
                    # snapshot_delta token taken before the reset sees it
                    child._rev += 1


#: the process-global registry every subsystem registers into
REGISTRY = MetricsRegistry()
