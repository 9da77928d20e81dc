"""Wall-time span tracer with Chrome-trace export.

``with trace.span("fit/step", step=i):`` records one complete ("ph": "X")
event — begin timestamp + duration, process id, thread id, and the keyword
attributes as ``args``. Nesting needs no explicit parent links: the Chrome
trace viewer (chrome://tracing, Perfetto) nests same-thread events by time
containment, which the with-statement guarantees.

Distributed requests additionally carry a :mod:`.context` trace identity:
when a :class:`~mmlspark_tpu.telemetry.context.SpanContext` is current,
every span/instant records ``trace_id`` / ``span_id`` / ``parent_span_id``
in its args and pushes a child context for its body — so spans across
threads AND processes join into one per-request tree once their files are
merged (:func:`merge_traces`).

Accelerator caveat: CUDA launches are async, so a span around a launch
measures enqueue time, not device time. ``span(..., sync=value)`` waits at
span exit for the work that produced ``value`` (a tensor, or a tuple, list
or dict of them): it records a ``torch.cuda.Event`` on the current stream
of each CUDA tensor's device and synchronizes on that event — an OPT-IN
sync point that makes the span cover real device work. It never calls
``torch.cuda.synchronize()``, which would stall the whole device: fits
running on other threads (the tuning search's pool) keep their streams
going. A CPU tensor needs no wait. Only paid when telemetry is enabled; a
disabled span is a no-op context manager and never touches torch.

Export is JSON-lines — one event object per line — which Perfetto loads
directly; for legacy chrome://tracing pass ``array=True`` to wrap the same
events in the JSON-array trace format.

The buffer is a bounded deque (oldest spans drop first) so a long-running
serving fleet can leave tracing on without growing memory. Overflow is NOT
silent: dropped events bump ``mmlspark_telemetry_events_dropped_total``
and the export carries a ``truncated: true`` metadata event.

The PyTorch port of ``mmlspark_tpu/telemetry/tracer.py``: the same span
names, export format and tail sampling; only the sync point differs.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from . import context as tracectx
from .registry import REGISTRY, _state

_m_dropped = REGISTRY.counter(
    "mmlspark_telemetry_events_dropped",
    "span/instant events dropped from the bounded trace ring (raise "
    "Tracer max_events or export more often)")
_m_retained = REGISTRY.gauge(
    "mmlspark_telemetry_retained_traces",
    "tail-sampled traces currently pinned against ring eviction "
    "(released on export or TTL expiry)")
_m_tail_dropped = REGISTRY.counter(
    "mmlspark_telemetry_tail_dropped",
    "traces discarded by the tail-sampling verdict (healthy/fast) or "
    "evicted from the pending/retained buffers")

#: set by telemetry.flight when the flight recorder is armed; every
#: recorded event is forwarded (one None-check when disarmed)
_flight_hook = None


def _tensors(value):
    """The tensors of ``value``: a tensor, or a (nested) tuple, list or
    dict of them; anything else holds none."""
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif hasattr(value, "is_cuda"):
        yield value


def wait_for(value):
    """Wait until the device work that produced ``value`` is done: one
    event recorded on the current stream of each CUDA device it lives on,
    then a wait on that event alone (never a device-wide synchronize). A
    value with no CUDA tensor returns at once."""
    devices = {t.device for t in _tensors(value) if t.is_cuda}
    if not devices:
        return
    import torch
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class _NoopSpan:
    """The disabled path: one shared instance, enter/exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_sync(self, value):
        pass


_NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "_sync", "_args", "_t0", "_ctx",
                 "_parent_id")

    def __init__(self, tracer: "Tracer", name: str, sync, args: dict):
        self._tracer = tracer
        self.name = name
        self._sync = sync
        self._args = args
        self._ctx = None
        self._parent_id = None

    def __enter__(self):
        parent = tracectx.current()
        if parent is not None:
            # active distributed trace: this span becomes a child hop and
            # its body sees ITS context (grandchildren parent correctly)
            self._ctx = parent.child()
            self._parent_id = parent.span_id
            tracectx._push(self._ctx)
        self._t0 = time.perf_counter_ns()
        return self

    def set_sync(self, value):
        """Late-bind the value to wait for at exit (for values produced
        inside the span body, e.g. the loss a train step returns)."""
        self._sync = value

    def __exit__(self, *exc):
        if self._sync is not None:
            wait_for(self._sync)
        end = time.perf_counter_ns()
        if self._ctx is not None:
            tracectx._pop()
        ev = {"name": self.name, "ph": "X", "ts": self._t0 // 1000,
              "dur": max(0, end - self._t0) // 1000,
              "pid": os.getpid(), "tid": threading.get_ident()}
        args = self._args
        if self._ctx is not None:
            args = dict(args)
            args["trace_id"] = self._ctx.trace_id
            args["span_id"] = self._ctx.span_id
            args["parent_span_id"] = self._parent_id
        if args:
            # attrs must be JSON-able; stringify anything exotic rather
            # than fail a hot path at export time
            ev["args"] = {k: (v if isinstance(v, (int, float, str, bool,
                                                  type(None))) else str(v))
                          for k, v in args.items()}
        self._tracer._record(ev)
        return False


class _TailState:
    """Tail-based sampling state (guarded by the tracer lock).

    While armed, events carrying a ``trace_id`` are buffered per-trace
    instead of entering the ring; the retention verdict lands at request
    completion (:meth:`Tracer.tail_complete`). Retained traces live in a
    dedicated pinned store — ring overflow cannot evict them — until
    exported or TTL-expired."""

    __slots__ = ("quantile", "min_samples", "max_pending",
                 "max_events_per_trace", "max_retained", "ttl",
                 "pending", "pending_t0", "retained", "latencies",
                 "_threshold", "_since_refit")

    def __init__(self, quantile: float, min_samples: int, max_pending: int,
                 max_events_per_trace: int, max_retained: int, ttl: float):
        self.quantile = float(quantile)
        self.min_samples = int(min_samples)
        self.max_pending = int(max_pending)
        self.max_events_per_trace = int(max_events_per_trace)
        self.max_retained = int(max_retained)
        self.ttl = float(ttl)
        self.pending: dict[str, list] = {}        # trace_id -> events
        self.pending_t0: dict[str, float] = {}    # trace_id -> first-seen
        # trace_id -> {"events", "deadline", "latency_s", "why"}
        self.retained: collections.OrderedDict[str, dict] = \
            collections.OrderedDict()
        self.latencies: collections.deque = collections.deque(maxlen=512)
        self._threshold = None
        self._since_refit = 0

    def threshold(self):
        """Current slow-quantile latency bound (None during warmup).
        Recomputed lazily every 32 completions — a 512-sample sort per
        request would tax the hot path for no verdict change."""
        if len(self.latencies) < self.min_samples:
            return None
        if self._threshold is None or self._since_refit >= 32:
            xs = sorted(self.latencies)
            k = min(len(xs) - 1, max(0, int(self.quantile * len(xs))))
            self._threshold = xs[k]
            self._since_refit = 0
        return self._threshold


class Tracer:
    def __init__(self, max_events: int = 200_000):
        self._events: collections.deque = collections.deque(  # guarded-by: _lock
            maxlen=max_events)
        self._lock = threading.Lock()
        self._dropped = 0   # guarded-by: _lock
        self._tail = None   # guarded-by: _lock (a _TailState when armed)

    def span(self, name: str, sync=None, **attrs):
        """Context manager timing its body as one Chrome-trace event.
        ``sync`` (optional tensor, or tuple/list/dict of tensors) is
        waited for at exit so the span covers the device work it
        launched."""
        if not _state.enabled:
            return _NOOP_SPAN
        return _Span(self, name, sync, attrs)

    def instant(self, name: str, **attrs):
        """Zero-duration marker event. Tags the current distributed trace
        context (retry/breaker/fault instants attach to the request that
        owned them)."""
        if not _state.enabled:
            return
        ev = {"name": name, "ph": "i", "ts": time.perf_counter_ns() // 1000,
              "s": "t", "pid": os.getpid(), "tid": threading.get_ident()}
        args = {k: str(v) for k, v in attrs.items()}
        ctx = tracectx.current()
        if ctx is not None:
            args["trace_id"] = ctx.trace_id
            args["parent_span_id"] = ctx.span_id
        if args:
            ev["args"] = args
        self._record(ev)

    def complete(self, name: str, start_ns: int, parent=None,
                 end_ns=None, **attrs):
        """Record a ph "X" event that began at ``start_ns``
        (``time.perf_counter_ns()``) and ends now (or at ``end_ns``, for
        replaying already-finished phases from a ledger) — for spans
        whose begin and end happen on DIFFERENT threads (a request
        enqueued by the HTTP handler, replied by the batching loop).
        ``parent`` is the owning hop (a SpanContext or raw traceparent
        string); the event gets a fresh span_id under it, and the new
        context is returned so callers can chain further hops."""
        if not _state.enabled:
            return None
        if isinstance(parent, str):
            parent = tracectx.parse_traceparent(parent)
        end = time.perf_counter_ns() if end_ns is None else int(end_ns)
        ev = {"name": name, "ph": "X", "ts": start_ns // 1000,
              "dur": max(0, end - start_ns) // 1000,
              "pid": os.getpid(), "tid": threading.get_ident()}
        args = {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                    else str(v)) for k, v in attrs.items()}
        ctx = None
        if parent is not None:
            ctx = parent.child()
            args["trace_id"] = ctx.trace_id
            args["span_id"] = ctx.span_id
            args["parent_span_id"] = parent.span_id
        if args:
            ev["args"] = args
        self._record(ev)
        return ctx

    def _record(self, ev: dict):
        with self._lock:
            tail = self._tail
            if tail is not None:
                tid = (ev.get("args") or {}).get("trace_id")
                if tid is not None:
                    self._tail_buffer(tail, tid, ev)
                    if _flight_hook is not None:
                        _flight_hook(ev)
                    return
            if (self._events.maxlen is not None
                    and len(self._events) == self._events.maxlen):
                self._dropped += 1
                _m_dropped.inc()
            self._events.append(ev)
        if _flight_hook is not None:
            _flight_hook(ev)

    def _tail_buffer(self, tail, tid, ev):   # requires-lock: _lock
        """Buffer one traced event pending its completion verdict
        (caller holds the lock)."""
        buf = tail.pending[tid] if tid in tail.pending else None
        if buf is None:
            if len(tail.pending) >= tail.max_pending:
                # evict the stalest pending trace whole — a verdict that
                # never came is a drop, and it is counted
                old = min(tail.pending_t0, key=tail.pending_t0.get)
                tail.pending.pop(old, None)
                tail.pending_t0.pop(old, None)
                _m_tail_dropped.inc()
            buf = tail.pending[tid] = []
            tail.pending_t0[tid] = time.monotonic()
        if len(buf) >= tail.max_events_per_trace:
            self._dropped += 1
            _m_dropped.inc()
            return
        buf.append(ev)

    def enable_tail_sampling(self, quantile: float = 0.99,
                             min_samples: int = 30,
                             max_pending: int = 1024,
                             max_events_per_trace: int = 512,
                             max_retained: int = 64,
                             ttl: float = 300.0):
        """Arm tail-based trace sampling: traced events buffer per-trace
        and :meth:`tail_complete` decides retention at request completion
        — slow (>= the ``quantile`` of recent latencies), errored, shed,
        or flagged requests are retained (pinned against ring eviction
        until exported or ``ttl`` seconds pass); healthy ones dropped."""
        with self._lock:
            self._tail = _TailState(quantile, min_samples, max_pending,
                                    max_events_per_trace, max_retained,
                                    ttl)
            _m_retained.set(0)

    def disable_tail_sampling(self):
        """Disarm tail sampling; pending and retained buffers drop."""
        with self._lock:
            self._tail = None
            _m_retained.set(0)

    @property
    def tail_sampling(self) -> bool:
        return self._tail is not None

    def tail_complete(self, trace_id, latency_s=None, error: bool = False,
                      shed: bool = False, flagged: bool = False) -> bool:
        """Deliver the completion verdict for one trace. Returns True
        when the trace was retained (its id is then exemplar-eligible).
        No-op (False) when tail sampling is disarmed."""
        if trace_id is None:
            return False
        with self._lock:
            tail = self._tail
            if tail is None:
                return False
            events = tail.pending.pop(trace_id, None)
            tail.pending_t0.pop(trace_id, None)
            thr = tail.threshold()
            if latency_s is not None:
                tail.latencies.append(float(latency_s))
                tail._since_refit += 1
            why = ("error" if error else "shed" if shed
                   else "flagged" if flagged
                   else "slow" if (latency_s is not None and thr is not None
                                   and latency_s >= thr)
                   else None)
            if why is None or not events:
                if events:
                    _m_tail_dropped.inc()
                self._tail_expire(tail)
                return False
            tail.retained[trace_id] = {
                "events": events, "latency_s": latency_s, "why": why,
                "deadline": time.monotonic() + tail.ttl}
            while len(tail.retained) > tail.max_retained:
                tail.retained.popitem(last=False)
                _m_tail_dropped.inc()
            self._tail_expire(tail)
            _m_retained.set(len(tail.retained))
            return True

    def _tail_expire(self, tail: _TailState):
        """Drop TTL-expired retained traces and stale pending buffers
        (caller holds the lock)."""
        now = time.monotonic()
        for tid in [t for t, r in tail.retained.items()
                    if r["deadline"] <= now]:
            del tail.retained[tid]
        stale = [t for t, t0 in tail.pending_t0.items()
                 if now - t0 > tail.ttl]
        for tid in stale:
            tail.pending.pop(tid, None)
            tail.pending_t0.pop(tid, None)
            _m_tail_dropped.inc()
        _m_retained.set(len(tail.retained))

    def is_retained(self, trace_id) -> bool:
        """True while ``trace_id`` is pinned in the retained store."""
        with self._lock:
            tail = self._tail
            return bool(tail and trace_id in tail.retained)

    def retained_ids(self) -> list:
        """Ids of currently pinned (tail-retained) traces, oldest first."""
        with self._lock:
            tail = self._tail
            return list(tail.retained) if tail else []

    def retained_events(self, trace_id) -> list:
        """The pinned span tree for one retained trace ([] if unknown)."""
        with self._lock:
            tail = self._tail
            if not tail or trace_id not in tail.retained:
                return []
            return list(tail.retained[trace_id]["events"])

    def _tail_events(self) -> list:
        """Retained + still-pending events (caller holds the lock)."""
        out: list = []
        tail = self._tail
        if tail is not None:
            for rec in tail.retained.values():
                out.extend(rec["events"])
            for buf in tail.pending.values():
                out.extend(buf)
        return out

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events) + self._tail_events()

    def dropped(self) -> int:
        """Events lost to the bounded ring since the last clear()."""
        with self._lock:
            return self._dropped

    def clear(self):
        with self._lock:
            self._events.clear()
            self._dropped = 0
            tail = self._tail
            if tail is not None:
                tail.pending.clear()
                tail.pending_t0.clear()
                tail.retained.clear()
                _m_retained.set(0)

    def export_chrome_trace(self, path: str, array: bool = False,
                            clear: bool = False, unpin: bool = True) -> int:
        """Write buffered events to ``path``; returns the event count.

        Default is JSON-lines (one event per line — Perfetto's JSON reader
        accepts it and tests round-trip it line-wise); ``array=True``
        writes the chrome://tracing JSON-array form. A ring that dropped
        events leads with a metadata event carrying ``truncated: true``
        and the drop count, so a partial trace is never mistaken for the
        whole story. Tail-retained traces are included and UNPINNED by a
        successful export — on disk they no longer need the ring-eviction
        shield (pending traces are included too but stay buffered; their
        verdict hasn't landed). ``unpin=False`` keeps the retained store
        pinned: the read-only path debug endpoints take, where the export
        goes to a scratch dir and the trace must stay fetchable."""
        with self._lock:
            evs = list(self._events) + self._tail_events()
            dropped = self._dropped
        if dropped:
            evs.insert(0, {"name": "trace_metadata", "ph": "M",
                           "pid": os.getpid(),
                           "args": {"truncated": True, "dropped": dropped}})
        with open(path, "w") as f:
            if array:
                f.write("[\n")
                f.write(",\n".join(json.dumps(e) for e in evs))
                f.write("\n]\n")
            else:
                for e in evs:
                    f.write(json.dumps(e) + "\n")
        if unpin:
            with self._lock:
                tail = self._tail
                if tail is not None:
                    tail.retained.clear()
                    _m_retained.set(0)
        if clear:
            self.clear()
        return len(evs)


def _load_events(path: str) -> list[dict]:
    """Read a Chrome-trace file in either export form (JSONL or array)."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if not stripped:
        return []
    if stripped.startswith("["):
        return json.loads(stripped)
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def merge_traces(paths, out_path=None, trace_id=None) -> list[dict]:
    """Join per-process Chrome-trace files into one event list.

    Each process (a serving driver, every fleet worker) exports its own
    file; merging concatenates their events — pids keep the processes on
    separate Perfetto rows — and sorts by timestamp. ``trace_id`` filters
    to one request's tree (events whose ``args.trace_id`` matches;
    metadata events are kept). ``out_path`` additionally writes the
    merged JSON-lines file. Returns the merged events.

    NOTE: ``ts`` is per-process ``perf_counter`` time, so cross-process
    ordering is approximate (same-host processes share the clock source;
    the per-request tree is correct regardless, via the span ids).
    """
    merged: list[dict] = []
    for p in paths:
        merged.extend(_load_events(p))
    if trace_id is not None:
        merged = [e for e in merged
                  if e.get("ph") == "M"
                  or (e.get("args") or {}).get("trace_id") == trace_id]
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    if out_path:
        with open(out_path, "w") as f:
            for e in merged:
                f.write(json.dumps(e) + "\n")
    return merged


#: the process-global tracer (the `trace.span(...)` every subsystem uses)
TRACER = Tracer()
