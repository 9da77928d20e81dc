"""Declarative SLOs evaluated as multi-window burn rates, plus a
rolling-MAD step-time anomaly detector.

Production serving (PAPERS.md, arxiv 2605.25645) is run against
latency/error/goodput *objectives*, not raw gauges: an alert should fire
when the error budget is being SPENT too fast, and stay quiet through
blips the budget absorbs. This module is that layer over
:mod:`.timeseries`:

  * an :class:`SLOObjective` declares what good looks like — ``p99
    latency under X``, ``error rate under 1-target``, ``goodput over a
    floor``, ``mean step time under budget`` — as data (dicts /
    JSON-able config, :meth:`SLOEngine.from_config`);
  * the :class:`SLOEngine` evaluates each objective as a **burn rate**
    (budget spend speed; 1.0 = exactly exhausting the budget over the
    window) over a FAST and a SLOW window. Breach requires both windows
    burning — the fast window gives detection latency, the slow window
    kills flappiness (the SRE multi-window multi-burn-rate alert shape);
  * breaches surface everywhere at once: ``/healthz`` (serving servers
    and fleet workers embed :meth:`healthz`), an ``slo/breach`` instant
    on the active trace, a flight-recorder note (so a later crash bundle
    shows the SLO was already burning), and gauges/counters on
    ``/metrics``;
  * the load shedder consults :meth:`should_shed` — an objective with
    ``shed_on_breach: true`` turns admission control on while its budget
    burns (overload protection driven by the objective, not a static
    queue bound alone).

:class:`StepTimeAnomalyDetector` is the training-side sibling: per-host
rolling step-time medians compared against the fleet median with a MAD
band; a host running consistently slow is a straggler verdict an
elastic training supervisor reports (and an operator can act on) long
before heartbeats stop: the port's elastic runtime
(resilience/elastic.py ``TrainSupervisor``) feeds it from heartbeat
progress.

The PyTorch port's own copy of ``mmlspark_tpu/telemetry/slo.py`` (it imports
no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from collections import deque
from typing import Optional

from .registry import REGISTRY
from .timeseries import SAMPLER, TimeSeriesSampler

_m_state = REGISTRY.gauge(
    "mmlspark_slo_state",
    "objective state: 0 ok, 1 fast-window burning, 2 breach",
    labels=("objective",))
_m_burn = REGISTRY.gauge(
    "mmlspark_slo_burn_rate",
    "error-budget burn rate per evaluation window (1.0 = spending "
    "exactly the budget)", labels=("objective", "window"))
_m_breaches = REGISTRY.counter(
    "mmlspark_slo_breaches",
    "transitions into breach (both windows burning)",
    labels=("objective",))

_KINDS = ("error_rate", "latency", "goodput", "step_time")

_SELECTOR_RE = re.compile(r"^\s*([A-Za-z_:][\w:]*)\s*(?:\{(.*)\})?\s*$")


def _parse_selector(sel: str) -> tuple[str, dict]:
    """``name`` or ``name{k=v,k2="v2"}`` -> (name, {label: value})."""
    m = _SELECTOR_RE.match(sel)
    if not m:
        raise ValueError(f"bad series selector: {sel!r}")
    labels: dict[str, str] = {}
    if m.group(2):
        for part in m.group(2).split(","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            labels[k.strip()] = v.strip().strip('"')
    return m.group(1), labels


def _key_labels(key: str) -> tuple[str, dict]:
    """A sampler series key back into (base_name, labels)."""
    base, brace, rest = key.partition("{")
    if not brace:
        return base, {}
    labels = {}
    for k, v in re.findall(r'([\w]+)="((?:[^"\\]|\\.)*)"', rest):
        labels[k] = v.replace('\\"', '"').replace("\\n", "\n") \
            .replace("\\\\", "\\")
    return base, labels


def _matches(key: str, name: str, want: dict) -> bool:
    base, labels = _key_labels(key)
    if base != name:
        return False
    return all(labels.get(k) == v for k, v in want.items())


class SLOObjective:
    """One declared objective. Field semantics by ``kind``:

    * ``error_rate`` — ``bad`` / ``total`` counter selectors and a
      ``target`` availability (0.99 = 1% error budget). burn =
      (bad/total) / (1 - target) over the window.
    * ``latency`` — ``hist`` histogram family name (optionally with
      labels), ``threshold_s`` and ``target`` (0.99 = 1% of requests may
      be slower). burn = slow_fraction / (1 - target); the threshold
      snaps to the smallest bucket bound >= ``threshold_s``.
    * ``goodput`` — ``series`` selector and a ``min`` floor (counter
      selectors become per-second rates, gauges average over the
      window). burn = min / observed (2.0 = running at half the floor).
    * ``step_time`` — ``hist`` step-time histogram selector and a
      ``budget_s`` mean-step budget. burn = mean / budget.
    """

    def __init__(self, name: str, kind: str, windows=(60.0, 300.0),
                 burn_threshold: float = 1.0, shed_on_breach: bool = False,
                 **spec):
        if kind not in _KINDS:
            raise ValueError(f"objective {name!r}: unknown kind {kind!r} "
                             f"(have {_KINDS})")
        self.name = name
        self.kind = kind
        if len(windows) != 2 or windows[0] >= windows[1]:
            raise ValueError(f"objective {name!r}: windows must be "
                             f"(fast, slow) with fast < slow, got "
                             f"{tuple(windows)}")
        self.windows = (float(windows[0]), float(windows[1]))
        self.burn_threshold = float(burn_threshold)
        self.shed_on_breach = bool(shed_on_breach)
        self.spec = spec
        # eager spec validation: a typo'd config must fail at declare
        # time, not silently report burn 0 forever
        need = {"error_rate": ("bad", "total", "target"),
                "latency": ("hist", "threshold_s", "target"),
                "goodput": ("series", "min"),
                "step_time": ("hist", "budget_s")}[kind]
        missing = [k for k in need if k not in spec]
        if missing:
            raise ValueError(f"objective {name!r} ({kind}): missing "
                             f"spec field(s) {missing}")

    def to_json(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "windows": list(self.windows),
                "burn_threshold": self.burn_threshold,
                "shed_on_breach": self.shed_on_breach, **self.spec}

    # ------------------------------------------------------------- reading
    def _sum_delta(self, ts: TimeSeriesSampler, sel: str, window: float,
                   now: float) -> Optional[float]:
        name, want = _parse_selector(sel)
        vals = [ts.window_delta(k, window, now) for k in ts.keys()
                if _matches(k, name, want)]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    def _hist_deltas(self, ts: TimeSeriesSampler, sel: str, window: float,
                     now: float):
        """(count_delta, sum_delta, {bound: delta}) for a histogram
        family selector (summed over matching label sets)."""
        name, want = _parse_selector(sel)
        count = self._sum_delta(ts, f"{name}_count" + (
            "{" + ",".join(f'{k}={v}' for k, v in want.items()) + "}"
            if want else ""), window, now)
        total = self._sum_delta(ts, f"{name}_sum" + (
            "{" + ",".join(f'{k}={v}' for k, v in want.items()) + "}"
            if want else ""), window, now)
        buckets: dict[float, float] = {}
        for key in ts.keys():
            base, labels = _key_labels(key)
            if base != f"{name}_bucket":
                continue
            le = labels.get("le")
            if le is None:
                continue
            if not all(labels.get(k) == v for k, v in want.items()):
                continue
            d = ts.window_delta(key, window, now)
            if d is None:
                continue
            bound = math.inf if le == "+Inf" else float(le)
            buckets[bound] = buckets.get(bound, 0.0) + d
        return count, total, buckets

    def burn(self, ts: TimeSeriesSampler, window: float,
             now: float) -> float:
        """Budget burn rate over one window (0.0 = quiet / no data)."""
        if self.kind == "error_rate":
            budget = max(1e-9, 1.0 - float(self.spec["target"]))
            total = self._sum_delta(ts, self.spec["total"], window, now)
            if not total or total <= 0:
                return 0.0
            bad = self._sum_delta(ts, self.spec["bad"], window, now) or 0.0
            return max(0.0, bad / total) / budget
        if self.kind == "latency":
            budget = max(1e-9, 1.0 - float(self.spec["target"]))
            count, _s, buckets = self._hist_deltas(
                ts, self.spec["hist"], window, now)
            if not count or count <= 0:
                return 0.0
            thr = float(self.spec["threshold_s"])
            at_or_under = [b for b in buckets if b >= thr]
            fast = min(buckets[b] for b in at_or_under) \
                if at_or_under else 0.0
            slow_frac = max(0.0, (count - fast) / count)
            return slow_frac / budget
        if self.kind == "goodput":
            floor = float(self.spec["min"])
            sel = self.spec["series"]
            name, want = _parse_selector(sel)
            if name.endswith("_total"):     # counter: per-second rate
                delta = self._sum_delta(ts, sel, window, now)
                if delta is None:
                    return 0.0
                observed = delta / max(window, 1e-9)
            else:                           # gauge: window average
                pts = [p for k in ts.keys() if _matches(k, name, want)
                       for p in ts.window_points(k, window, now)]
                if not pts:
                    return 0.0
                observed = sum(v for _t, v in pts) / len(pts)
            if observed <= 0:
                return math.inf if floor > 0 else 0.0
            return floor / observed
        # step_time
        budget = max(1e-9, float(self.spec["budget_s"]))
        count, total, _b = self._hist_deltas(
            ts, self.spec["hist"], window, now)
        if not count or count <= 0 or total is None:
            return 0.0
        return (total / count) / budget


class SLOEngine:
    """Evaluates objectives over a sampler; surfaces state everywhere.

    ``evaluate(now=...)`` is deterministic (tests drive it with the same
    synthetic clock they tick the sampler with); ``start()`` runs it on a
    daemon thread after each sampler interval."""

    def __init__(self, objectives, sampler: Optional[TimeSeriesSampler]
                 = None, interval: Optional[float] = None):
        self.objectives = [o if isinstance(o, SLOObjective)
                           else SLOObjective(**o) for o in objectives]
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.sampler = sampler if sampler is not None else SAMPLER
        self.interval = float(interval) if interval else None
        self._lock = threading.Lock()
        self._states: dict[str, str] = {}       # guarded-by: _lock
        self._last: dict[str, dict] = {}        # guarded-by: _lock
        self._breached_ever: set[str] = set()   # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, config, sampler: Optional[TimeSeriesSampler]
                    = None) -> "SLOEngine":
        """``config``: a dict (or JSON string / ``.json`` path) with
        ``{"objectives": [...], "interval": seconds?}``."""
        if isinstance(config, str):
            if config.lstrip().startswith("{"):
                config = json.loads(config)
            else:
                with open(config, "r", encoding="utf-8") as f:
                    config = json.load(f)
        objs = config.get("objectives")
        if not objs:
            raise ValueError("slo config has no 'objectives' list")
        return cls(objs, sampler=sampler, interval=config.get("interval"))

    # ---------------------------------------------------------- evaluation
    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass; returns and stores per-objective state.
        Transition IO (instants, flight notes, logs) happens AFTER the
        state lock is released."""
        t = time.time() if now is None else float(now)
        results: dict[str, dict] = {}
        for o in self.objectives:
            fast_w, slow_w = o.windows
            burn_fast = o.burn(self.sampler, fast_w, t)
            burn_slow = o.burn(self.sampler, slow_w, t)
            burning_fast = burn_fast > o.burn_threshold
            burning_slow = burn_slow > o.burn_threshold
            state = ("breach" if burning_fast and burning_slow
                     else "burning" if burning_fast or burning_slow
                     else "ok")
            results[o.name] = {
                "kind": o.kind, "state": state,
                "burn_fast": round(burn_fast, 4)
                if math.isfinite(burn_fast) else burn_fast,
                "burn_slow": round(burn_slow, 4)
                if math.isfinite(burn_slow) else burn_slow,
                "windows_s": list(o.windows),
                "burn_threshold": o.burn_threshold,
                "shed_on_breach": o.shed_on_breach,
            }
        transitions = []
        with self._lock:
            for o in self.objectives:
                prev = self._states.get(o.name, "ok")
                state = results[o.name]["state"]
                if state == "breach" and prev != "breach":
                    transitions.append(("breach", o, results[o.name]))
                    self._breached_ever.add(o.name)
                elif prev == "breach" and state != "breach":
                    transitions.append(("recover", o, results[o.name]))
                self._states[o.name] = state
            self._last = results
        for o in self.objectives:
            r = results[o.name]
            lvl = {"ok": 0, "burning": 1, "breach": 2}[r["state"]]
            _m_state.labels(objective=o.name).set(lvl)
            for win, b in (("fast", r["burn_fast"]),
                           ("slow", r["burn_slow"])):
                _m_burn.labels(objective=o.name, window=win).set(
                    b if math.isfinite(b) else 1e9)
        from . import flight, trace
        for what, o, r in transitions:
            if what == "breach":
                _m_breaches.labels(objective=o.name).inc()
                trace.instant("slo/breach", objective=o.name,
                              kind=o.kind, burn_fast=r["burn_fast"],
                              burn_slow=r["burn_slow"])
                flight.note("slo/breach", objective=o.name,
                            objective_kind=o.kind,
                            burn_fast=r["burn_fast"],
                            burn_slow=r["burn_slow"])
            else:
                trace.instant("slo/recover", objective=o.name,
                              kind=o.kind)
                flight.note("slo/recover", objective=o.name,
                            objective_kind=o.kind)
        return results

    # ------------------------------------------------------------- surface
    def state(self) -> dict:
        with self._lock:
            return dict(self._last)

    def breached(self) -> set:
        """Objectives currently in breach."""
        with self._lock:
            return {n for n, s in self._states.items() if s == "breach"}

    def breached_ever(self) -> set:
        """Objectives that breached at any point in this engine's life
        (a fit-long engine reports these in its final summary)."""
        with self._lock:
            return set(self._breached_ever)

    def should_shed(self) -> bool:
        """The load-shedder/breaker hook: True while any
        ``shed_on_breach`` objective is in breach."""
        with self._lock:
            return any(self._states.get(o.name) == "breach"
                       for o in self.objectives if o.shed_on_breach)

    def retry_after(self, base: float = 1.0, cap: float = 30.0) -> int:
        """Severity-proportional client backoff for shed 503s: the
        Retry-After seconds scale with the worst FAST-window burn rate
        among breached ``shed_on_breach`` objectives (burn 3.0 = clients
        told to stay away 3x longer), clamped to ``cap``. With nothing
        burning it degrades to ``base`` — the static value queue-bound
        shedding always used."""
        with self._lock:
            burns = [self._last.get(o.name, {}).get("burn_fast", 0.0)
                     for o in self.objectives
                     if o.shed_on_breach
                     and self._states.get(o.name) == "breach"]
        worst = max((b for b in burns if isinstance(b, (int, float))),
                    default=0.0)
        if not math.isfinite(worst):
            return int(cap)
        return int(min(cap, max(base, math.ceil(base * worst))))

    def healthz(self) -> dict:
        """Compact dict embedded in every ``GET /healthz`` payload."""
        with self._lock:
            last = dict(self._last)
            states = dict(self._states)
        return {"ok": all(s != "breach" for s in states.values()),
                "objectives": {n: {"state": r["state"],
                                   "burn_fast": r["burn_fast"],
                                   "burn_slow": r["burn_slow"]}
                               for n, r in last.items()}}

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "SLOEngine":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slo-engine")
        self._thread.start()
        return self

    def _run(self):
        interval = self.interval or self.sampler.interval
        while not self._stop.is_set():
            try:
                self.evaluate()
            except Exception:  # an evaluation bug must not kill the loop
                pass
            self._stop.wait(interval)

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None


class StepTimeAnomalyDetector:
    """Rolling-MAD straggler detection over per-host step times.

    Each host's recent step seconds live in a bounded window; a host is a
    **straggler** when its window median exceeds the fleet median of host
    medians by ``k`` scaled MADs AND by the ``min_ratio`` floor (the MAD
    band alone degenerates for tiny fleets where every deviation equals
    the MAD). Pure computation — an elastic training supervisor feeds
    it from heartbeat progress and reports the verdicts."""

    def __init__(self, window: int = 64, k: float = 5.0,
                 min_samples: int = 8, min_ratio: float = 1.5):
        self.window = int(window)
        self.k = float(k)
        self.min_samples = int(min_samples)
        self.min_ratio = float(min_ratio)
        self._lock = threading.Lock()
        self._samples: dict[str, deque] = {}    # guarded-by: _lock

    def observe(self, host: str, step_seconds: float):
        if step_seconds < 0 or not math.isfinite(step_seconds):
            return
        with self._lock:
            ring = self._samples.get(host)
            if ring is None:
                ring = self._samples[host] = deque(maxlen=self.window)
            ring.append(float(step_seconds))

    @staticmethod
    def _median(vals) -> float:
        s = sorted(vals)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0

    def host_medians(self) -> dict:
        with self._lock:
            rings = {h: list(r) for h, r in self._samples.items()}
        return {h: self._median(v) for h, v in rings.items()
                if len(v) >= self.min_samples}

    def stragglers(self) -> set:
        """Hosts currently running anomalously slow (empty until at least
        two hosts have ``min_samples`` observations)."""
        med = self.host_medians()
        if len(med) < 2:
            return set()
        fleet = self._median(list(med.values()))
        mad = self._median([abs(v - fleet) for v in med.values()])
        band = self.k * 1.4826 * mad
        return {h for h, v in med.items()
                if v > fleet + band and v > self.min_ratio * fleet}

    def report(self) -> dict:
        """Per-host medians + current verdicts (healthz / debugging)."""
        med = self.host_medians()
        bad = self.stragglers()
        return {"host_median_s": {h: round(v, 6) for h, v in med.items()},
                "stragglers": sorted(bad)}

    def forget(self, host: str):
        """Drop one host's window (an evicted host's samples are stale
        the moment it leaves the mesh — keeping them would hold its
        straggler flag forever and block its rejoin)."""
        with self._lock:
            self._samples.pop(host, None)

    def clear(self):
        with self._lock:
            self._samples.clear()
