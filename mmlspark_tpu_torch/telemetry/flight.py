"""Crash flight recorder: a bounded ring of recent observability events,
dumped as one JSON bundle when something goes wrong.

"The chaos test hung once in CI" is unactionable without state from the
seconds BEFORE the hang. The flight recorder keeps that state cheaply:

  * every span/instant the tracer records is mirrored into a bounded
    ring (one hook call; disarmed cost is a None-check inside the
    tracer);
  * metric-DELTA samples: at most once per ``sample_interval`` seconds a
    compact {counter/gauge: value} snapshot is appended, so the bundle
    shows how the counters were MOVING, not just their final values;
  * :func:`note` records log-worthy instants (supervisor verdicts,
    shed decisions) even when span tracing is off.

Dump triggers:

  * **unhandled exception** — ``sys.excepthook`` (and
    ``threading.excepthook``) are CHAINED, not replaced: the bundle is
    written, then the previous hook runs;
  * **SIGUSR1** — poke a live process for a bundle without stopping it;
  * **on demand** — ``GET /debug/flight`` on every serving/fleet-worker
    port returns the bundle as JSON; :func:`dump` writes it to disk.

Enable with ``MMLSPARK_TPU_FLIGHT=1`` (bundles land in the working
directory as ``flight_<pid>.json``) or ``MMLSPARK_TPU_FLIGHT=/path/dir``
(bundles land there), or :func:`enable` at runtime. Enabling also turns
telemetry on — a flight recorder with nothing feeding it records
nothing.

The PyTorch port's own copy of ``mmlspark_tpu/telemetry/flight.py`` (it
imports no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

from .registry import REGISTRY

_m_dumps = REGISTRY.counter(
    "mmlspark_flight_dumps",
    "flight-recorder bundles written, by trigger",
    labels=("trigger",))

#: ring capacity: enough for several seconds of serving-fleet traffic
#: without holding a long run's whole history
DEFAULT_CAPACITY = 4096


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sample_interval: float = 1.0):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._enabled = False
        self._dir: str = "."
        self._sample_interval = sample_interval
        self._last_sample = 0.0
        self._last_totals: dict = {}
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._dropped = 0

    # ------------------------------------------------------------ enable
    def enable(self, path: str | None = None):
        """Arm the recorder (idempotent). ``path``: directory for dump
        files. Chains the process excepthooks and registers SIGUSR1."""
        from . import enable as telemetry_enable
        from . import tracer as tracer_mod
        telemetry_enable()
        if path:
            self._dir = path
            os.makedirs(path, exist_ok=True)
        if self._enabled:
            return
        self._enabled = True
        tracer_mod._flight_hook = self._on_event
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        self._prev_threading_hook = threading.excepthook
        threading.excepthook = self._threading_excepthook
        try:
            import signal
            signal.signal(signal.SIGUSR1,
                          lambda *_: self.dump("SIGUSR1"))
        except (ValueError, OSError, AttributeError):
            pass   # non-main thread or platform without SIGUSR1

    def disable(self):
        from . import tracer as tracer_mod
        if not self._enabled:
            return
        self._enabled = False
        tracer_mod._flight_hook = None
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
        if self._prev_threading_hook is not None:
            threading.excepthook = self._prev_threading_hook

    @property
    def enabled(self) -> bool:
        return self._enabled

    # ------------------------------------------------------------ record
    def _append(self, entry: dict):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(entry)

    def _on_event(self, ev: dict):
        """Tracer hook: mirror every span/instant into the ring."""
        self._append({"kind": "span" if ev.get("ph") == "X" else "instant",
                      "t": time.time(), **ev})
        self._maybe_sample_metrics()

    def note(self, name: str, **data):
        """A log-worthy instant straight into the ring (works even when
        span tracing is quiet)."""
        if not self._enabled:
            return
        # reserved fields win: a caller kwarg named "kind"/"t"/"name"
        # must not reshape the ring entry itself
        self._append({**{k: (v if isinstance(v, (int, float, str, bool,
                                                 type(None))) else str(v))
                         for k, v in data.items()},
                      "kind": "note", "t": time.time(), "name": name})
        self._maybe_sample_metrics()

    def _maybe_sample_metrics(self):
        now = time.monotonic()
        if now - self._last_sample < self._sample_interval:
            return
        self._last_sample = now
        totals: dict = {}
        try:
            for name, fam in REGISTRY.snapshot().items():
                if fam["type"] == "histogram":
                    totals[name] = sum(s.get("count", 0)
                                       for s in fam["series"])
                else:
                    totals[name] = sum(s.get("value", 0.0)
                                       for s in fam["series"])
        except Exception:
            return
        delta = {k: v - self._last_totals.get(k, 0)
                 for k, v in totals.items()
                 if v != self._last_totals.get(k, 0)}
        self._last_totals = totals
        if delta:
            self._append({"kind": "metrics", "t": time.time(),
                          "delta": delta})

    # -------------------------------------------------------------- dump
    def bundle(self, reason: str = "debug") -> dict:
        """The JSON bundle: the ring, a full metrics snapshot, the armed
        fault plan, and tracer drop accounting. Safe to call any time
        (``GET /debug/flight`` serves this)."""
        from . import snapshot, trace
        with self._lock:
            events = list(self._ring)
            dropped = self._dropped
        out = {
            "reason": reason,
            "time": time.time(),
            "pid": os.getpid(),
            "enabled": self._enabled,
            "events": events,
            "events_dropped": dropped,
            "trace_events_buffered": len(trace.events()),
            "trace_events_dropped": trace.dropped(),
            "metrics": snapshot(),
        }
        try:
            from ..resilience import faults
            out["faults"] = faults.snapshot()
        except Exception:
            pass
        return out

    def dump(self, reason: str = "manual",
             path: str | None = None) -> str | None:
        """Write the bundle to ``path`` (default
        ``<dir>/flight_<pid>.json``); returns the written path. Never
        raises — the recorder must not turn a crash into a worse crash."""
        try:
            if path is None:
                path = os.path.join(self._dir,
                                    f"flight_{os.getpid()}.json")
            doc = self.bundle(reason)
            with open(path, "w") as f:
                json.dump(doc, f)
            _m_dumps.labels(trigger=reason).inc()
            sys.stderr.write(f"[flight] {reason}: bundle with "
                             f"{len(doc['events'])} events -> {path}\n")
            return path
        except Exception:
            return None

    # -------------------------------------------------------- excepthook
    def _excepthook(self, exc_type, exc, tb):
        self.note("unhandled_exception", type=exc_type.__name__,
                  message=str(exc))
        self.dump("excepthook")
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _threading_excepthook(self, args):
        # a serving/prefetch thread dying is exactly the flight-recorder
        # moment — SystemExit passes through silently like the default
        if args.exc_type is not SystemExit:
            self.note("unhandled_thread_exception",
                      type=args.exc_type.__name__,
                      message=str(args.exc_value),
                      thread=getattr(args.thread, "name", "?"))
            self.dump("thread_excepthook")
        prev = self._prev_threading_hook or threading.__excepthook__
        prev(args)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._dropped = 0
            self._last_totals = {}
            self._last_sample = 0.0


#: the process-global recorder (``telemetry.flight``)
FLIGHT = FlightRecorder()
