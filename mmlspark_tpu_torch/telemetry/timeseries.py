"""Bounded in-memory time series over the metrics registry.

The registry answers "what is the queue depth NOW"; every consumer that
needs "what was it doing for the last five minutes" — the SLO burn-rate
engine (:mod:`.slo`), a dashboard scraping ``GET /timeseries``, a bench
run embedding its step-time history — previously had to build its own
scrape loop. This module is that loop, built once:

  * a background (or test-driven) **tick** pulls
    :meth:`~.registry.MetricsRegistry.snapshot_delta` — unchanged
    families cost one int-sum, never a snapshot rebuild — and appends one
    ``(t, value)`` point per *changed* series to a bounded ring
    (oldest points drop first, so a long-running server holds a fixed
    window, not its whole history);
  * series are keyed by **exposition name** (counters carry ``_total``,
    histograms flatten to ``<name>_count`` / ``<name>_sum`` /
    ``<name>_bucket{le="..."}``, labels render exactly as the Prometheus
    text format) so a selector that works on ``/metrics`` works here;
  * values are stored **cumulative** (raw counter/bucket totals, gauge
    levels): window rates are subtraction at read time
    (:meth:`TimeSeriesSampler.window_delta`), which makes a ring of N
    points answer any window up to its span;
  * **JSONL export/import** (:meth:`export_jsonl` / :func:`load_jsonl`)
    and a JSON :meth:`snapshot` served at ``GET /timeseries`` on every
    serving/worker control port.

Enable with ``MMLSPARK_TPU_TIMESERIES=1`` (1s ticks) or ``=0.25``
(custom interval, seconds) — arming also enables telemetry — or
``telemetry.timeseries.start()`` at runtime. Ticks are cheap on a quiet
process and proportional to *changed* families on a busy one.

The PyTorch port's own copy of ``mmlspark_tpu/telemetry/timeseries.py`` (it
imports no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import threading
import time
from typing import Optional

from .registry import REGISTRY, _label_str

#: default ring capacity per series: 10 minutes of 1s ticks
DEFAULT_CAPACITY = 600
DEFAULT_INTERVAL = 1.0

SCHEMA = "mmlspark-timeseries/v1"

_m_ticks = REGISTRY.counter(
    "mmlspark_timeseries_ticks",
    "sampler ticks taken (each appends points for changed series)")
_m_series = REGISTRY.gauge(
    "mmlspark_timeseries_series",
    "live series held in the time-series sampler's rings")
_m_resets = REGISTRY.counter(
    "mmlspark_timeseries_resets",
    "monotonic resets observed on cumulative series (registry.reset / "
    "process restart); window_delta clamps at zero across the boundary")


def is_cumulative(key: str) -> bool:
    """True for series whose values only grow between resets: counters
    (``_total``) and flattened histogram components. Gauges may move
    either way, so reset clamping never applies to them."""
    base = key.partition("{")[0]
    return base.endswith(("_total", "_count", "_sum", "_bucket"))


def _expo(name: str, kind: str) -> str:
    if kind == "counter" and not name.endswith("_total"):
        return name + "_total"
    return name


def flatten_family(name: str, fam: dict):
    """One registry snapshot family -> ``(series_key, value)`` pairs in
    exposition naming (the same keys a ``/metrics`` scrape would show)."""
    base = _expo(name, fam["type"])
    for s in fam["series"]:
        labels = s.get("labels") or {}
        names, vals = tuple(labels.keys()), tuple(labels.values())
        if fam["type"] == "histogram":
            lab = _label_str(names, vals)
            yield f"{name}_count{lab}", float(s.get("count", 0))
            yield f"{name}_sum{lab}", float(s.get("sum", 0.0))
            for b, c in (s.get("buckets") or {}).items():
                blab = _label_str(names + ("le",), vals + (str(b),))
                yield f"{name}_bucket{blab}", float(c)
        else:
            yield f"{base}{_label_str(names, vals)}", float(s.get("value",
                                                                  0.0))


def family_exemplars(name: str, fam: dict):
    """One registry snapshot family -> ``(bucket_series_key, exemplar)``
    pairs, keyed like the matching ``_bucket`` series from
    :func:`flatten_family`. Exemplars ride the snapshot as a side channel
    — ring points stay plain floats."""
    if fam.get("type") != "histogram":
        return
    for s in fam["series"]:
        exemplars = s.get("exemplars")
        if not exemplars:
            continue
        labels = s.get("labels") or {}
        names, vals = tuple(labels.keys()), tuple(labels.values())
        for b, ex in exemplars.items():
            blab = _label_str(names + ("le",), vals + (str(b),))
            yield f"{name}_bucket{blab}", dict(ex)


class TimeSeriesSampler:
    """Periodic snapshot-delta sampler with one bounded ring per series.

    ``tick(now=...)`` is public and deterministic — tests and the SLO
    engine drive it with a synthetic clock; ``start()`` runs it on a
    daemon thread every ``interval`` seconds with the wall clock.
    """

    def __init__(self, registry=REGISTRY, interval: float = DEFAULT_INTERVAL,
                 capacity: int = DEFAULT_CAPACITY):
        self.registry = registry
        self.interval = float(interval)
        self.capacity = int(capacity)
        self._rings: dict[str, collections.deque] = {}  # guarded-by: _lock
        # series present at the sampler's FIRST tick: their pre-sampling
        # history is unknown (the process may have been running long
        # before sampling started), so partial-window reads fall back to
        # their earliest point. Everything else was BORN mid-sampling —
        # a cumulative series' value before its first point is 0.
        self._seeded: set = set()                       # guarded-by: _lock
        self._token: Optional[dict] = None              # guarded-by: _lock
        # latest OpenMetrics exemplar per bucket-series key (side channel
        # on the snapshot; FederatedSampler.merge populates it from
        # ingested worker snapshots)
        self._exemplars: dict[str, dict] = {}           # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- sampling
    def tick(self, now: Optional[float] = None) -> int:
        """One sampling pass; returns the number of points appended.
        ``now`` defaults to ``time.time()`` (export timestamps are wall
        clock so merged host files line up)."""
        t = time.time() if now is None else float(now)
        first = self._token is None
        # the registry walk happens OUTSIDE our lock: snapshot_delta takes
        # per-metric locks internally and must not nest inside ours
        changed, token = self.registry.snapshot_delta(self._token)
        points = [(key, v) for name, fam in changed.items()
                  for key, v in flatten_family(name, fam)]
        exemplars = [(key, ex) for name, fam in changed.items()
                     for key, ex in family_exemplars(name, fam)]
        resets = 0
        with self._lock:
            self._token = token
            self._exemplars.update(exemplars)
            for key, v in points:
                ring = self._rings.get(key)
                if ring is None:
                    ring = self._rings[key] = collections.deque(
                        maxlen=self.capacity)
                    if first:
                        self._seeded.add(key)
                elif ring and v < ring[-1][1] and is_cumulative(key):
                    # a cumulative value moved BACKWARD: registry.reset()
                    # or a counter re-registered by a restarted component.
                    # Recorded so the zero-clamped window_delta reads that
                    # follow are explainable from the trace.
                    resets += 1
                ring.append((t, v))
            n_series = len(self._rings)
        _m_ticks.inc()
        _m_series.set(n_series)
        if resets:
            _m_resets.inc(resets)
            from . import trace
            trace.instant("timeseries/reset", series=resets)
        return len(points)

    # -------------------------------------------------------------- reading
    def keys(self) -> list:
        with self._lock:
            return sorted(self._rings)

    def series(self, key: str) -> list:
        """``[(t, value), ...]`` oldest-first (empty when unknown)."""
        with self._lock:
            ring = self._rings.get(key)
            return list(ring) if ring is not None else []

    def value_at(self, key: str, t: float) -> Optional[float]:
        """Carry-forward read: the last recorded value at or before ``t``
        (None when the series has no point that early)."""
        pts = self.series(key)
        i = bisect.bisect_right([p[0] for p in pts], t)
        return pts[i - 1][1] if i else None

    def window_delta(self, key: str, window: float,
                     now: Optional[float] = None) -> Optional[float]:
        """``value(now) - value(now - window)`` for cumulative series
        (counters, histogram counts/sums/buckets). When the series is
        younger than the window the baseline depends on WHY it is young:
        a series the sampler saw at its very first tick has unknown
        pre-sampling history, so its earliest point stands in (a
        partial-window rate, never None-because-young); a series born
        mid-sampling (a labeled child minted by its first write — e.g.
        the first 500 reply ever) was 0 before its first point, so the
        baseline is 0 and that first burst is fully visible. None only
        when the series is empty or starts after ``now``.

        A cumulative series whose window spans a reset boundary
        (``registry.reset()``, a restarted component) would read
        NEGATIVE — the end value restarted below the baseline. That is
        clamped at zero (and the reset was recorded as a
        ``timeseries/reset`` instant at tick time): one quiet window
        beats a nonsense rate poisoning every burn evaluation above."""
        with self._lock:
            ring = self._rings.get(key)
            pts = list(ring) if ring is not None else []
            seeded = key in self._seeded
        if not pts:
            return None
        t = pts[-1][0] if now is None else float(now)
        times = [p[0] for p in pts]
        i_end = bisect.bisect_right(times, t)
        if i_end == 0:
            return None
        end = pts[i_end - 1][1]
        i_start = bisect.bisect_right(times, t - window)
        start = pts[i_start - 1][1] if i_start else \
            (pts[0][1] if seeded else 0.0)
        delta = end - start
        if delta < 0 and is_cumulative(key):
            return 0.0
        return delta

    def window_points(self, key: str, window: float,
                      now: Optional[float] = None) -> list:
        """Points with ``now - window < t <= now`` (gauge averaging)."""
        pts = self.series(key)
        if not pts:
            return []
        t = pts[-1][0] if now is None else float(now)
        return [p for p in pts if t - window < p[0] <= t]

    # ------------------------------------------------------------ exporting
    def snapshot(self) -> dict:
        """The ``GET /timeseries`` payload."""
        with self._lock:
            series = {k: [[round(t, 3), v] for t, v in ring]
                      for k, ring in sorted(self._rings.items())}
            exemplars = {k: dict(ex)
                         for k, ex in sorted(self._exemplars.items())}
        doc = {"schema": SCHEMA, "interval": self.interval,
               "capacity": self.capacity, "series": series}
        if exemplars:
            # additive field: absent entirely when no histogram ever
            # carried an exemplar, so v1 consumers are unaffected
            doc["exemplars"] = exemplars
        return doc

    def export_jsonl(self, path: str) -> int:
        """One header line + one line per series; returns series count."""
        doc = self.snapshot()
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps({"schema": doc["schema"],
                                "interval": doc["interval"],
                                "capacity": doc["capacity"]}) + "\n")
            for key, pts in doc["series"].items():
                f.write(json.dumps({"series": key, "points": pts}) + "\n")
        return len(doc["series"])

    def clear(self):
        with self._lock:
            self._rings.clear()
            self._seeded.clear()
            self._token = None
            self._exemplars.clear()

    # ------------------------------------------------------------ lifecycle
    def start(self, interval: Optional[float] = None) -> "TimeSeriesSampler":
        """Arm the background tick thread (idempotent). Also enables
        telemetry — a sampler over a disabled registry records nothing."""
        from . import enable as telemetry_enable
        telemetry_enable()
        if interval is not None:
            self.interval = float(interval)
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="timeseries-sampler")
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:   # a sampling bug must not kill the thread
                pass
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None


def load_jsonl(path: str) -> dict:
    """Inverse of :meth:`TimeSeriesSampler.export_jsonl`:
    ``{series_key: [(t, value), ...]}``."""
    out: dict[str, list] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            if "series" in doc:
                out[doc["series"]] = [(float(t), float(v))
                                      for t, v in doc.get("points", [])]
    return out


def percentile_from_buckets(bucket_deltas: dict, q: float
                            ) -> Optional[float]:
    """Approximate quantile from cumulative-bucket window deltas
    (``{le_bound(str|float): delta_count}``): the smallest bound whose
    cumulative share reaches ``q``. Standard Prometheus
    ``histogram_quantile`` shape — resolution is the bucket grid."""
    items = []
    for b, c in bucket_deltas.items():
        bound = math.inf if str(b) in ("+Inf", "inf") else float(b)
        items.append((bound, float(c)))
    items.sort()
    if not items:
        return None
    total = items[-1][1]
    if total <= 0:
        return None
    target = q * total
    for bound, cum in items:
        if cum >= target:
            return bound
    return items[-1][0]


#: the process-global sampler (``telemetry.timeseries``), armed by
#: ``MMLSPARK_TPU_TIMESERIES`` or ``.start()``
SAMPLER = TimeSeriesSampler()
