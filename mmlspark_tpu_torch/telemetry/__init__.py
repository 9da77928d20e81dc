"""Runtime telemetry of the PyTorch port: metrics registry, span tracing,
exposition.

The port of ``mmlspark_tpu/telemetry`` (reference: the MMLSpark
``core/metrics`` layer, PAPER.md §1), with the same metric and span names,
so a dashboard or a bench tool reads either package alike. The trainer's
step timing, the GBDT iteration breakdown, the prefetcher and the
loss scaler report through it.

Usage::

    from mmlspark_tpu_torch import telemetry
    _steps = telemetry.registry.counter("mmlspark_trainer_steps_total")
    ...
    _steps.inc()
    with telemetry.trace.span("fit/step", step=i, sync=loss):
        ...

Off by default: a disabled metric mutator is one attribute lookup and a
return, a disabled span a shared no-op context manager. Enable it with the
``MMLSPARK_TPU_TELEMETRY=1`` environment switch (read through
``core.env.telemetry_enabled`` at import) or ``telemetry.enable()``.
``MMLSPARK_TPU_TRACE=/path/file.jsonl`` also exports the span buffer as
Chrome-trace JSON-lines at interpreter exit; ``snapshot()`` returns the
registry as JSON and ``prometheus_text()`` in Prometheus text format.
Each package keeps its own registry and reads the same switches.

Every serving process answers ``GET /metrics`` with
``prometheus_text()`` (``io.http.server``, ``io.http.worker``). Not
ported here: ``federation`` (the fleet-wide scrape, ROADMAP.md Queue 1
item 13b).
"""

from __future__ import annotations

from . import context, ledger, profiler, slo
from .flight import FLIGHT
from .registry import (DEFAULT_TIME_BUCKETS, REGISTRY, Counter, Gauge,
                       Histogram, MetricsRegistry, _state, pow2_buckets)
from .timeseries import SAMPLER, TimeSeriesSampler
from .tracer import TRACER, Tracer, merge_traces

#: process-global singletons — the module-level API
registry = REGISTRY
trace = TRACER
flight = FLIGHT
timeseries = SAMPLER

__all__ = ["registry", "trace", "enabled", "enable", "disable",
           "snapshot", "prometheus_text", "warn_once", "merge_traces",
           "context", "ledger", "profiler", "flight", "timeseries", "slo",
           "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "Tracer", "TimeSeriesSampler",
           "DEFAULT_TIME_BUCKETS", "pow2_buckets"]


def enabled() -> bool:
    return _state.enabled


def enable():
    _state.enabled = True


def disable():
    _state.enabled = False


def snapshot() -> dict:
    return registry.snapshot()


def prometheus_text() -> str:
    return registry.prometheus_text()


_warned_keys: set = set()
_warnings = registry.counter(
    "mmlspark_warnings_total",
    "one-time-logged warning occurrences by key", labels=("key",))


def warn_once(logger, key: str, msg: str, *args):
    """Log ``msg`` at WARNING once per ``key`` per process; bump the
    ``mmlspark_warnings_total{key=...}`` counter on EVERY occurrence (the
    log dedupes, the metric keeps counting — silent-after-first events
    stay visible on a dashboard). The counter counts while telemetry is
    enabled, like every metric."""
    _warnings.labels(key=key).inc()
    if key not in _warned_keys:
        _warned_keys.add(key)
        logger.warning(msg, *args)



def _init_from_env():
    from ..core.env import (flight_path, telemetry_enabled,
                            telemetry_trace_path, timeseries_interval)
    if telemetry_enabled():
        enable()
    ts = timeseries_interval()
    if ts is not None:
        # arming the sampler also enables telemetry (a sampler over a
        # disabled registry records nothing)
        SAMPLER.start(interval=ts)
    path = telemetry_trace_path()
    if path:
        import atexit
        import os
        # "{pid}" templating: each process needs its own export file
        path = path.replace("{pid}", str(os.getpid()))
        atexit.register(lambda: trace.export_chrome_trace(path))
    fpath = flight_path()
    if fpath is not None:
        flight.enable(fpath or None)


_init_from_env()
