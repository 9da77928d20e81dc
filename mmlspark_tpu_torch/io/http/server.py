"""HTTP serving source/sink of the PyTorch port: its own copy of
``mmlspark_tpu/io/http/server.py`` (reference: io/http — HTTPSource.scala:
43,147, DistributedHTTPSource.scala:100-260 JVMSharedServer with port
probing and the MultiChannelMap of in-flight exchanges,
DistributedHTTPSink:418).

The reference turns every Spark executor into a web server whose requests
become streaming rows and whose replies are sent by the sink calling
``server.respond(batch, uuid, code, body)``. Here one process hosts the
server; the same three-piece contract is kept:

  * ``HTTPSource``   — threaded HTTP server; pending requests become rows
                       ``(id, value)`` via ``getBatch`` (continuous batching:
                       a batch is whatever arrived since the last drain, up
                       to max_rows — exactly what one bucketed device
                       dispatch wants);
  * ``HTTPSink``     — ``addBatch(df)`` completes the stored exchanges by id;
  * ``serve_pipeline`` — source -> transformer -> sink loop on a thread.

The same admission control (queue bound, ``slo.should_shed()``, draining
and the shed hint, answered 503 + Retry-After), the same probe and debug
surface (``/healthz``, ``/metrics``, ``/timeseries``, ``/debug/trace/<id>``,
``/debug/flight``), W3C traceparent propagation and the same metric and
span names as the JAX package. The fleet half waits for ROADMAP.md Queue 1
item 13b: ``/fleet/metrics`` and ``/timeseries?scope=fleet`` answer 404
until a federation is attached (none is, in the port), ``/debug/threads``
answers 501, and the race sanitizer's instrumentation of the source's
counters is left out. An elastic fit running in the process
(resilience/elastic.py) adds its fleet state to ``/healthz`` as the
``elastic`` section.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from ...core.dataframe import DataFrame
from ...core.utils import get_logger, object_column
from ... import telemetry
from ...telemetry import ledger as ledgerlib
from ...resilience import faults
from ...resilience.policy import CircuitBreaker, RetryPolicy

log = get_logger("io.http")

# serving metrics (shared by the single-process loop and the fleet workers;
# each OS process exposes its own registry at GET /metrics)
_m_req_latency = telemetry.registry.histogram(
    "mmlspark_http_request_seconds",
    "client request latency: arrival to reply written")
_m_queue_depth = telemetry.registry.gauge(
    "mmlspark_http_queue_depth",
    "requests pending batch pickup in this server")
_m_batch_rows = telemetry.registry.histogram(
    "mmlspark_serving_batch_rows",
    "rows per serving micro-batch (continuous batching)",
    buckets=telemetry.pow2_buckets(1, 4096))
_m_replies = telemetry.registry.counter(
    "mmlspark_http_replies", "replies sent by status class",
    labels=("code",))
_m_shed = telemetry.registry.counter(
    "mmlspark_http_shed_requests",
    "requests rejected with 503 + Retry-After by queue-depth load "
    "shedding (max_queue_depth exceeded)")
_m_phase = telemetry.registry.histogram(
    "mmlspark_serving_phase_seconds",
    "per-request latency attribution: seconds spent in each phase-ledger "
    "stage (queue/form/decode/dispatch/pad/device/readback/reply)",
    labels=("phase",))


_NO_FLEET = ("no fleet federation on this server (the port's federation "
             "waits for ROADMAP.md Queue 1 item 13b)")
_NO_SANITIZER = ("the race sanitizer's thread dump waits for ROADMAP.md "
                 "Queue 1 item 13b")


class _BurstyHTTPServer(ThreadingHTTPServer):
    """socketserver's default listen backlog (request_queue_size=5) makes a
    burst of concurrent clients overflow the accept queue; the kernel drops
    their SYNs and they crawl in via retransmit backoff (seconds). Serving
    layers exist to absorb bursts — raise the backlog."""
    request_queue_size = 128


def bind_with_probing(host: str, port: int, handler,
                      max_probes: int = 20) -> _BurstyHTTPServer:
    """Bind a server on ``port`` or the next free port above it (port 0 =
    kernel-assigned). The reference's probing loop,
    DistributedHTTPSource.scala:237-250 — expressed as a shared
    RetryPolicy attempt budget (zero backoff: the 'retry' is the next
    port, not the same one later)."""
    policy = RetryPolicy(name="http.bind", max_attempts=max_probes,
                         base_delay=0.0, max_delay=0.0,
                         retryable=(OSError,))
    try:
        return policy.run(lambda probe: _BurstyHTTPServer(
            (host, port + probe if port else 0), handler))
    except OSError as e:
        raise OSError(f"no free port after {max_probes} probes: {e}")


class _Exchange:
    """One in-flight request awaiting a reply (the HttpExchange analog)."""

    __slots__ = ("id", "value", "event", "code", "body", "picked",
                 "trace", "t0_ns", "ledger")

    def __init__(self, value: str):
        self.id = uuid.uuid4().hex
        self.value = value
        self.event = threading.Event()
        self.code = 500
        self.body = b""
        self.picked = False    # drained by getBatch (queue-depth bookkeeping)
        self.trace = None      # ingress-span traceparent (telemetry on only)
        self.t0_ns = time.perf_counter_ns()
        # always-on phase ledger: every serving stage stamps the envelope
        # as the request leaves it (admission is t0); the stamps become
        # serve/phase spans + mmlspark_serving_phase_seconds observations
        # at reply time, and sum to the client-observed request latency
        self.ledger = ledgerlib.PhaseLedger(self.t0_ns)


class HTTPSource:
    """Threaded HTTP server collecting requests for batch processing.

    ``max_queue_depth`` > 0 enables load shedding: a request arriving
    while that many are already awaiting batch pickup is rejected
    immediately with ``503 + Retry-After`` instead of being queued — at
    overload, a fast honest rejection (the client retries elsewhere /
    later) beats a 30s reply_timeout nobody will wait out."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", name: str = "source",
                 max_port_probes: int = 20, max_queue_depth: int = 0,
                 slo=None):
        self._pending: "queue.Queue[_Exchange]" = queue.Queue()
        self._inflight: dict[str, _Exchange] = {}
        self._lock = threading.Lock()
        self.max_queue_depth = max_queue_depth
        # optional telemetry.slo.SLOEngine: its breach state rides
        # /healthz and (for shed_on_breach objectives) gates admission
        self.slo = slo
        # graceful drain (scale-down): a draining server sheds every NEW
        # request (503 + Retry-After — clients go elsewhere) while the
        # already-admitted exchanges finish normally; the fleet retires
        # the worker once inflight hits zero. Parks nothing, loses
        # nothing.
        self._draining = False
        # optional fleet-doc provider: the COORDINATOR's health surface sets
        # this to embed the aggregated per-worker fleet healthz (plus
        # autoscaler/reconciler sections) — see io/http/fleet.fleet_doc.
        # Deliberately instance-scoped, never global: worker processes
        # (and in-process worker sources) must not recurse through the
        # aggregation probe.
        self.fleet_state = None
        # coordinator-only federation surface, same instance-scoping rule:
        # ``fleet_metrics`` (-> exposition text) answers GET
        # /fleet/metrics; ``fleet_timeseries`` (-> snapshot dict) answers
        # GET /timeseries?scope=fleet. Both stay None on workers.
        self.fleet_metrics = None
        self.fleet_timeseries = None
        # coordinator-only cross-worker trace fetch: ``fleet_trace`` (trace_id
        # -> merged event list or None) answers GET /debug/trace/<id> by
        # collecting every live worker's spans; workers and single-process
        # engines leave it None and serve their local tracer instead
        self.fleet_trace = None
        # fleet-burn shed hint pushed by the coordinator's FleetScraper
        # (control POST /shed): while set, this door sheds with the
        # coordinator-computed burn-derived Retry-After — the engine runs on
        # the coordinator, the admission control runs here
        self._shed_hint = None   # Retry-After seconds, or None
        self._t0 = time.monotonic()
        # live requests awaiting batch pickup. NOT _pending.qsize(): a
        # timed-out client's exchange lingers in the queue until a later
        # drain discards it, and qsize would keep reporting that dead work
        # as depth. Incremented on enqueue, decremented exactly once —
        # either when getBatch picks the exchange or when its client's
        # wait times out unpicked.
        self._n_pending = 0
        source = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                if api_path not in ("/", self.path):
                    self.send_error(404)
                    return
                # distributed trace ingress: honor an incoming W3C
                # traceparent, mint a fresh trace otherwise (telemetry
                # off: ctx stays None and every context hop is a no-op)
                ctx = None
                if telemetry.enabled():
                    ctx = (telemetry.context.from_headers(self.headers)
                           or telemetry.context.new_trace())
                hint = source._shed_hint
                shed = source._draining or hint is not None
                if not shed and source.max_queue_depth:
                    with source._lock:
                        shed = source._n_pending >= source.max_queue_depth
                if not shed and source.slo is not None:
                    # SLO-driven admission control: while a shed_on_breach
                    # objective's error budget burns in both windows, a
                    # fast 503 beats queueing work the budget can't afford
                    shed = source.slo.should_shed()
                if shed:
                    # Retry-After is derived from the SLO burn severity
                    # (fast-window ratio): a local engine computes it
                    # here; a fleet worker gets it pushed as the shed
                    # hint (the coordinator's engine evaluated FLEET burn).
                    # Clients back off proportionally to the overload
                    # instead of stampeding back after a fixed second.
                    retry_after = (hint if hint is not None
                                   else source.slo.retry_after()
                                   if source.slo is not None else 1)
                    _m_shed.inc()
                    _m_replies.labels(code="503").inc()
                    with telemetry.context.use(ctx):
                        telemetry.trace.instant(
                            "http/shed", depth=source.max_queue_depth,
                            retry_after=retry_after,
                            draining=source._draining)
                    if ctx is not None:
                        # shed requests are tail-retention candidates by
                        # definition: the verdict lands now, at completion
                        telemetry.trace.tail_complete(ctx.trace_id,
                                                      shed=True)
                    payload = (b'{"error": "draining, retry another '
                               b'replica"}' if source._draining else
                               b'{"error": "overloaded, retry later"}')
                    self.send_response(503)
                    self.send_header("Retry-After", str(retry_after))
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length",
                                     str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                t0 = time.perf_counter()
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length).decode("utf-8")
                ex = _Exchange(body)
                # the ingress span covers enqueue -> reply written; its
                # context rides the exchange envelope so every downstream
                # hop (batch pickup, fleet coordinator, outbound clients)
                # parents under it across threads AND processes
                with telemetry.context.use(ctx), \
                        telemetry.trace.span("http/request",
                                             bytes=length) as _sp:
                    ex.trace = telemetry.context.current_traceparent()
                    with source._lock:
                        source._inflight[ex.id] = ex
                        source._n_pending += 1
                        _m_queue_depth.set(source._n_pending)
                    source._pending.put(ex)
                    if not ex.event.wait(timeout=source.reply_timeout):
                        self.send_error(504, "batch processing timed out")
                        with source._lock:
                            source._inflight.pop(ex.id, None)
                            if not ex.picked:  # abandoned while queued
                                source._n_pending -= 1
                            _m_queue_depth.set(source._n_pending)
                        _m_replies.labels(code="504").inc()
                        # a timed-out request is exactly the evidence the
                        # tail sampler exists to keep
                        telemetry.trace.tail_complete(
                            telemetry.context.trace_id_of(ex.trace),
                            latency_s=source.reply_timeout, error=True)
                        return
                    self.send_response(ex.code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(ex.body)))
                    self.end_headers()
                    self.wfile.write(ex.body)
                    dt = time.perf_counter() - t0
                    # request completion: the tail-retention verdict lands
                    # here (slow >= quantile / errored => retained), and a
                    # retained trace id rides the latency observation as
                    # its bucket's OpenMetrics exemplar
                    tid = telemetry.context.trace_id_of(ex.trace)
                    retained = telemetry.trace.tail_complete(
                        tid, latency_s=dt, error=ex.code >= 500)
                    _m_req_latency.observe(
                        dt, exemplar=tid if retained else None)
                    _m_replies.labels(code=str(ex.code)).inc()

            def do_GET(self):
                # the observability surface gets its own chaos site: an
                # injected fault answers 503 (probes and scrapers must
                # tolerate a flapping debug plane without killing the
                # worker) — see docs/reliability.md `http.debug`
                try:
                    faults.inject("http.debug")
                except Exception:
                    self.send_error(503, "injected debug-plane fault")
                    return
                path, _, query = self.path.partition("?")
                params = dict(p.partition("=")[::2]
                              for p in query.split("&") if p)
                # Prometheus scrape surface: every serving process (the
                # single-process loop AND each fleet worker) answers
                # GET /metrics with its own registry's exposition
                if path == "/metrics":
                    payload = telemetry.prometheus_text().encode("utf-8")
                    self.send_response(200)
                    # the full 0.0.4 exposition content type — Prometheus
                    # content negotiation wants the charset too
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif path == "/fleet/metrics":
                    # the federation surface: fleet-wide merged series
                    # (aggregates + worker= children) in exposition form.
                    # Only the coordinator wires fleet_metrics; elsewhere 404.
                    if source.fleet_metrics is None:
                        self.send_error(404, _NO_FLEET)
                        return
                    payload = source.fleet_metrics().encode("utf-8")
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif path.startswith("/debug/trace/"):
                    # one request's span tree by trace id. On the fleet
                    # coordinator (fleet_trace wired) the spans are collected
                    # and merged across every live worker; elsewhere the
                    # local tracer (ring + tail-retained store) answers.
                    tid = path.rsplit("/", 1)[-1]
                    if source.fleet_trace is not None:
                        events = source.fleet_trace(tid)
                    else:
                        events = [
                            e for e in telemetry.trace.events()
                            if (e.get("args") or {}).get("trace_id") == tid]
                    if not events:
                        self.send_error(404, f"unknown trace {tid}")
                        return
                    payload = json.dumps(
                        {"trace_id": tid,
                         "events": events}).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif path == "/debug/flight":
                    # the flight-recorder bundle on demand: recent span
                    # events, metric deltas, and the armed fault plan —
                    # "it hung once" becomes an artifact
                    payload = json.dumps(
                        telemetry.flight.bundle("debug-endpoint")) \
                        .encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif path == "/debug/threads":
                    # the race sanitizer's thread dump is not ported yet
                    self.send_error(501, _NO_SANITIZER)
                elif path == "/healthz":
                    # liveness + load surface for the fleet supervisor and
                    # external orchestrators (k8s-style probes)
                    payload = json.dumps(source.health()).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif path == "/timeseries":
                    # the sampler's ring buffers as JSON: recent history
                    # of every metric series, not just the last scrape.
                    # ?scope=fleet asks for the FEDERATED rings (merged
                    # worker series) — coordinator-only, 404 elsewhere.
                    if params.get("scope") == "fleet":
                        if source.fleet_timeseries is None:
                            self.send_error(404, _NO_FLEET)
                            return
                        doc = source.fleet_timeseries()
                    else:
                        doc = telemetry.timeseries.snapshot()
                    payload = json.dumps(doc).encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self.send_error(404)

            def log_message(self, *a):
                pass

        # port probing (reference DistributedHTTPSource.scala:237-250)
        self.server = bind_with_probing(host, port, Handler, max_port_probes)
        self.host, self.port = self.server.server_address[:2]
        self.reply_timeout = 30.0
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name=f"http-{name}")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def set_draining(self, draining: bool) -> None:
        """Flip graceful-drain mode: new requests shed 503 (Retry-After
        points clients at the surviving replicas) while admitted
        exchanges run to completion."""
        self._draining = bool(draining)
        if draining:
            log.info("serving source on port %d draining: new requests "
                     "shed, %d in flight", self.port, self.inflight())

    def set_shed_hint(self, retry_after) -> None:
        """Install (or clear, with ``None``) the fleet-burn shed hint:
        the coordinator's federated SLO engine decided admission control for
        the whole fleet and pushed its burn-derived Retry-After here —
        new requests shed 503 while the hint is set."""
        self._shed_hint = int(retry_after) if retry_after else None
        if self._shed_hint is not None:
            log.info("serving source on port %d shedding on fleet burn "
                     "(Retry-After %ds)", self.port, self._shed_hint)

    def inflight(self) -> int:
        """Admitted exchanges not yet replied (queued + in a batch) —
        the count graceful drain waits out."""
        with self._lock:
            return len(self._inflight)

    def health(self) -> dict:
        """The ``GET /healthz`` payload: queue depth, shedding bound,
        uptime, and every circuit breaker's per-target state in this
        process."""
        with self._lock:
            depth = self._n_pending
            inflight = len(self._inflight)
        out = {"ok": True,
               "uptime_s": round(time.monotonic() - self._t0, 3),
               "queue_depth": depth,
               "inflight": inflight,
               "draining": self._draining,
               "fleet_shed_retry_after": self._shed_hint,
               "max_queue_depth": self.max_queue_depth,
               "breakers": CircuitBreaker.snapshot_all()}
        if self.slo is not None:
            # the SLO engine's verdicts ride the same probe surface: a
            # supervisor (or k8s) sees budget burn without a new endpoint
            out["slo"] = self.slo.healthz()
            out["ok"] = out["ok"] and out["slo"]["ok"]
        # an elastic fit running in this process surfaces its fleet state
        # on the same probe: hosts alive, stragglers, pending evict/grow
        # verdicts, the rendezvous generation
        from ...resilience.elastic import fleet_health
        fleet = fleet_health()
        if fleet is not None:
            out["elastic"] = fleet
        if self.fleet_state is not None:
            # the serving-fleet coordinator surface: every worker's healthz
            # (warm buckets, breakers, queue depth) aggregated into one
            # doc, with the autoscaler + reconciler sections — a single
            # probe shows fleet health
            try:
                f = self.fleet_state()
            except Exception as e:
                f = {"ok": False, "error": str(e)}
            out["fleet"] = f
            out["ok"] = out["ok"] and bool(f.get("ok", True))
        return out

    def drain(self, max_rows: int = 1024, timeout: float = 0.05,
              wait_first: bool = True) -> list:
        """Drain up to ``max_rows`` LIVE pending exchanges (dead ones —
        clients whose wait timed out — are discarded). Returns the raw
        :class:`_Exchange` handles: the continuous batcher needs arrival
        timestamps (``t0_ns``) for its max-wait deadline and responds by
        id later. ``wait_first=False`` makes an empty queue return
        immediately (top-up polls while a batch is forming)."""
        rows: list[_Exchange] = []
        deadline = time.monotonic() + timeout
        try:
            while len(rows) < max_rows:
                # deadline-bounded: discarding dead exchanges must not restart
                # the clock, or repeated client timeouts stall this unboundedly
                wait = (max(0.0, deadline - time.monotonic())
                        if wait_first and not rows else 0)
                ex = self._pending.get(timeout=wait)
                # a client whose wait timed out was dropped from _inflight;
                # its exchange is dead — don't hand it to the pipeline
                # (its pending-depth slot was released at abandon time)
                with self._lock:
                    alive = ex.id in self._inflight
                    if alive:
                        ex.picked = True
                        self._n_pending -= 1
                if alive:
                    ex.ledger.mark("queue")   # queue-wait phase ends here
                    rows.append(ex)
        except queue.Empty:
            pass
        with self._lock:
            _m_queue_depth.set(self._n_pending)
        return rows

    def getBatch(self, max_rows: int = 1024,
                 timeout: float = 0.05) -> DataFrame:
        """Drain up to max_rows pending requests into an (id, value) frame."""
        rows = self.drain(max_rows, timeout)
        if not rows:
            return DataFrame({"id": np.array([], dtype=object),
                              "value": np.array([], dtype=object)})
        return DataFrame({"id": object_column([r.id for r in rows]),
                          "value": object_column([r.value for r in rows])})

    def trace_for(self, ex_id: str):
        """The ingress-span traceparent of a live exchange (None when the
        exchange is gone or telemetry was off at arrival) — how the trace
        context crosses the control channel to the fleet coordinator."""
        with self._lock:
            ex = self._inflight.get(ex_id)
        return ex.trace if ex is not None else None

    def respond(self, ex_id: str, code: int, body: bytes | str):
        with self._lock:
            ex = self._inflight.pop(ex_id, None)
        if ex is None:
            log.warning("respond: unknown or timed-out exchange %s", ex_id)
            return
        ex.ledger.mark("reply")   # reply computed; waiter released below
        if ex.trace is not None:
            # per-request processing hop: arrival -> reply computed, a
            # child of the ingress span (begin/end are on different
            # threads, so this is an explicit-duration event)
            ctx = telemetry.trace.complete("serve/request", ex.t0_ns,
                                           parent=ex.trace, code=int(code))
            # the ledger becomes serve/phase child spans (their durations
            # sum to the request latency) and phase-histogram points
            ledgerlib.emit_phase_spans(telemetry.trace, ex.ledger,
                                       ctx if ctx is not None else ex.trace)
            ledgerlib.observe_phases(_m_phase, ex.ledger)
        ex.code = code
        ex.body = body.encode("utf-8") if isinstance(body, str) else body
        ex.event.set()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class HTTPSink:
    """Completes exchanges from a replies dataframe (reference
    DistributedHTTPSink.addBatch at :418-450)."""

    def __init__(self, source: HTTPSource, id_col: str = "id",
                 reply_col: str = "reply", code_col: Optional[str] = None):
        self.source = source
        self.id_col = id_col
        self.reply_col = reply_col
        self.code_col = code_col

    def addBatch(self, df: DataFrame):
        codes = df.col(self.code_col) if self.code_col else None
        ids = df.col(self.id_col)
        replies = df.col(self.reply_col)
        for i in range(df.count()):
            code = int(codes[i]) if codes is not None else 200
            self.source.respond(str(ids[i]), code, str(replies[i]))


class ServingLoop:
    """source -> pipeline -> sink continuous-batching loop. The transformer
    sees a DataFrame with columns (id, value); it must produce `reply`.

    With ``prefetch_depth >= 1`` (default 2) the next micro-batch is
    drained and assembled on a prefetch thread WHILE the current batch's
    transform (the device dispatch) runs — continuous batching with the drain
    wait off the critical path. An optional ``prepare`` callable
    (DataFrame -> DataFrame, e.g. payload decode + feature padding) also
    runs on the prefetch thread, so per-row host decode overlaps device
    compute too; it must keep the ``id`` column. Prepare failures reply
    500 to that batch's clients without stopping the loop."""

    def __init__(self, source: HTTPSource, transformer,
                 max_batch: int = 1024, prefetch_depth: int = 2,
                 prepare: Optional[Callable[[DataFrame], DataFrame]] = None):
        self.source = source
        self.sink = HTTPSink(source)
        self.transformer = transformer
        self.max_batch = max_batch
        self.prefetch_depth = prefetch_depth
        self.prepare = prepare
        # transient errors (network blips inside a transformer that calls
        # out, injected faults) get one in-memory retry before the batch
        # fails with 500s; model/code errors classify fatal and fail fast
        self._retry = RetryPolicy(name="serving.batch", max_attempts=2,
                                  base_delay=0.02, max_delay=0.1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _fail_batch(self, batch: DataFrame, e: Exception):
        log.warning("serving batch failed: %s", e)
        for ex_id in batch.col("id"):
            self.source.respond(str(ex_id), 500,
                                json.dumps({"error": str(e)}))

    def _drained(self):
        """Producer: drain + (optionally) prepare micro-batches until
        stopped. getBatch's bounded wait keeps this responsive to stop()."""
        while not self._stop.is_set():
            batch = self.source.getBatch(self.max_batch)
            if batch.count() == 0:
                continue
            _m_batch_rows.observe(batch.count())
            if self.prepare is not None:
                try:
                    with telemetry.trace.span("serve/prepare",
                                              rows=batch.count()):
                        batch = self.prepare(batch)
                except Exception as e:
                    self._fail_batch(batch, e)
                    continue
            yield batch

    def _run(self):
        from ...parallel import prefetch as prefetchlib
        it = prefetchlib.prefetched(self._drained, depth=self.prefetch_depth,
                                    name="serving", span="serve/prefetch")
        try:
            for batch in it:
                def attempt(_a, batch=batch):
                    with telemetry.trace.span("serve/batch",
                                              rows=batch.count()):
                        faults.inject("serving.transform")
                        out = self.transformer.transform(batch)
                        self.sink.addBatch(out)
                try:
                    self._retry.run(attempt)
                except Exception as e:  # reply 500s, don't hang clients
                    self._fail_batch(batch, e)
        finally:
            it.close()

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def serve_pipeline(transformer, host: str = "127.0.0.1", port: int = 0,
                   max_batch: int = 1024, prefetch_depth: int = 2,
                   prepare=None, max_queue_depth: int = 0,
                   slo=None) -> tuple[HTTPSource, ServingLoop]:
    """Convenience: spin up source + loop for a fitted transformer.
    ``slo`` (a ``telemetry.slo.SLOEngine``) surfaces objective state on
    ``/healthz`` and lets ``shed_on_breach`` objectives gate admission."""
    source = HTTPSource(host=host, port=port,
                        max_queue_depth=max_queue_depth, slo=slo)
    loop = ServingLoop(source, transformer, max_batch,
                       prefetch_depth=prefetch_depth,
                       prepare=prepare).start()
    return source, loop
