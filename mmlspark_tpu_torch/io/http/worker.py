"""Serving worker process: a client-facing HTTP server + a control channel
(the port's own copy of ``mmlspark_tpu/io/http/worker.py``).

The executor-side half of the reference's serving architecture: every Spark
executor JVM runs a JVMSharedServer holding in-flight HttpExchanges
(DistributedHTTPSource.scala:100-260), and the coordinator's micro-batch loop
pulls requests out / pushes replies back across the cluster. Here the worker
is an OS process: clients POST to its public port and block; the coordinator
process polls ``/poll`` on the control port for pending (id, value) rows and
posts grouped replies to ``/respond`` — the exchange lifecycle stays inside
the worker, so a coordinator restart (or batch replay) never loses a client
connection that's still waiting.

Run as ``python -m mmlspark_tpu_torch.io.http.worker [--host H] [--port P]
[--control-port C] [--bundle DIR] [--device cuda]``; prints ONE json line
{"port": .., "control": ..} so the spawner learns the probed ports. With
``--bundle`` the worker serves the bundle itself, every bucket captured
warm inside ``load_bundle`` before the port opens.

Not ported yet (ROADMAP.md Queue 1 item 13b): the race sanitizer's
instrumentation of the control plane's ``_unacked`` buffer and its
``GET /debug/threads`` dump (answered 501 here), and the fleet coordinator that
spawns and supervises these workers (``fleet.py``, the supervisor).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler

from ...core.utils import get_logger
from .server import _NO_SANITIZER, HTTPSource, bind_with_probing

log = get_logger("http.worker")


class WorkerServer:
    """Client server + control server inside one worker process.

    The poll handoff is AT-LEAST-ONCE: drained exchanges stay in an
    ``unacked`` buffer until the coordinator's next poll acknowledges their ids,
    so a poll response lost in transit re-delivers the same rows instead of
    stranding their clients (a drain-and-forget handoff would drop them).

    ``bundle`` turns the worker SELF-SERVING: instead of parking rows
    for a coordinator's ``/poll`` loop, the worker loads the model+executable
    bundle (io/serving/bundle.py) at startup and runs its own
    continuous-batching loop — every shape bucket's compiled executable
    deserializes from the bundle, so a supervisor-restarted worker
    answers its first request WARM (zero live-traffic compiles; the
    recompile counters on ``GET /metrics`` prove it). In the port a
    bundle's "executable" is the record of a bucket's CUDA graph capture;
    ``load_bundle`` captures every bucket again from the kernel libraries
    already built, with no ``nvcc`` run, before the source opens.
    ``device`` is where the bundle's model serves ("cuda" by default; a
    worker asked for CUDA on a machine without it raises)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 control_port: int = 0, max_queue_depth: int = 0,
                 bundle: str = None, max_wait: float = 0.01,
                 timeseries: float = None, device: str = "cuda"):
        if timeseries:
            # arm this process's sampler so the control-plane GET
            # /timeseries has history for the coordinator's FleetScraper to
            # federate (spawners pass --timeseries when federating; the
            # MMLSPARK_TPU_TIMESERIES env arms it for everything else)
            from ... import telemetry
            telemetry.timeseries.start(interval=float(timeseries))
        self.serving = None
        self.step = None
        if bundle:
            # warm BEFORE the port opens: every bucket is captured here
            from ..serving import load_bundle
            self.step = load_bundle(bundle, device=device)
        self.source = HTTPSource(host=host, port=port, name="worker",
                                 max_queue_depth=max_queue_depth)
        if self.step is not None:
            from ..serving import ContinuousServingLoop
            self.serving = ContinuousServingLoop(
                self.source, self.step, max_wait=max_wait).start()
        self._unacked: dict[str, str] = {}   # id -> value, insertion order
        self._lock = threading.Lock()
        worker = self
        worker_pid = os.getpid()

        class Control(BaseHTTPRequestHandler):
            def _json(self, code: int, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # same chaos site as the public port's debug plane: the
                # supervisor and scrapers must survive a flapping
                # control-plane GET surface (injected faults answer 503)
                from ...resilience import faults
                try:
                    faults.inject("http.debug")
                except Exception:
                    self.send_error(503, "injected debug-plane fault")
                    return
                if self.path == "/health":
                    self._json(200, {"ok": True,
                                     "port": worker.source.port})
                elif self.path == "/healthz":
                    # the supervisor's probe surface: liveness + load +
                    # breaker states (same payload shape as the public
                    # port's /healthz, plus the unacked poll backlog)
                    h = worker.source.health()
                    with worker._lock:
                        h["unacked"] = len(worker._unacked)
                    h["port"] = worker.source.port
                    if worker.step is not None:
                        # the warm-start surface: which buckets answer
                        # without a compile, and how many compiles this
                        # incarnation has paid
                        from ...ops import _build
                        h["serving"] = {
                            "warm_buckets": worker.step.warm_buckets(),
                            "buckets": worker.step.policy.buckets,
                            "compiles": worker.step.compiles(),
                            "nvcc_builds": _build.builds}
                    self._json(200, h)
                elif self.path == "/metrics":
                    # same exposition as the public port's GET /metrics, so
                    # a scraper confined to the control plane still sees
                    # this worker's registry
                    from ... import telemetry
                    body = telemetry.prometheus_text().encode("utf-8")
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/trace":
                    # the worker's span buffer as a JSON event array — how
                    # the coordinator collects per-process traces for
                    # telemetry.merge_traces without relying on a clean
                    # worker exit (workers die by SIGKILL)
                    from ... import telemetry
                    self._json(200, {"events": telemetry.trace.events(),
                                     "dropped": telemetry.trace.dropped(),
                                     "pid": worker_pid})
                elif self.path.startswith("/debug/trace/"):
                    # one trace's spans from THIS worker's tracer (ring +
                    # tail-retained store) — the coordinator's cross-worker
                    # /debug/trace/<id> fans out to these and merges
                    from ... import telemetry
                    tid = self.path.rsplit("/", 1)[-1]
                    events = [
                        e for e in telemetry.trace.events()
                        if (e.get("args") or {}).get("trace_id") == tid]
                    if not events:
                        self.send_error(404, f"unknown trace {tid}")
                        return
                    self._json(200, {"trace_id": tid, "events": events,
                                     "pid": worker_pid})
                elif self.path == "/timeseries":
                    # the worker's sampler rings: per-process metric
                    # history over the control plane (same payload as the
                    # public port's /timeseries on the serving server)
                    from ... import telemetry
                    self._json(200, telemetry.timeseries.snapshot())
                elif self.path == "/debug/flight":
                    from ... import telemetry
                    self._json(200,
                               telemetry.flight.bundle("debug-endpoint"))
                elif self.path == "/debug/threads":
                    self.send_error(501, _NO_SANITIZER)
                else:
                    self.send_error(404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/poll":
                    cap = max(1, int(req.get("max", 256)))
                    with worker._lock:
                        for ex_id in req.get("ack", ()):
                            worker._unacked.pop(str(ex_id), None)
                        backlog = len(worker._unacked)
                    # honor the coordinator's cap: the unacked backlog goes out
                    # first (oldest rows, at-least-once redelivery), and the
                    # source is only drained for the REMAINING headroom —
                    # a coordinator that falls behind must not see the response
                    # payload grow without bound
                    if backlog < cap:
                        batch = worker.source.getBatch(
                            cap - backlog,
                            timeout=float(req.get("timeout", 0.02)))
                        with worker._lock:
                            for i, v in zip(batch.col("id"),
                                            batch.col("value")):
                                worker._unacked[str(i)] = str(v)
                    with worker._lock:
                        rows = [[i, v] for i, v in itertools.islice(
                            worker._unacked.items(), cap)]
                    # trace envelope: the ingress traceparent of each row
                    # still in flight rides a side map (the rows stay
                    # [id, value] pairs — the handoff shape is stable)
                    trace = {}
                    for i, _v in rows:
                        tp = worker.source.trace_for(str(i))
                        if tp:
                            trace[str(i)] = tp
                    resp = {"rows": rows}
                    if trace:
                        resp["trace"] = trace
                    self._json(200, resp)
                elif self.path == "/respond":
                    for ex_id, code, body in req.get("replies", ()):
                        worker.source.respond(str(ex_id), int(code),
                                              str(body))
                    self._json(200, {})
                elif self.path == "/shed":
                    # fleet-burn admission control, pushed: the COORDINATOR's
                    # federated SLO engine saw the fleet-wide budget
                    # burning and tells this door to shed with its
                    # burn-derived Retry-After (cleared the same way once
                    # the burn recovers)
                    if req.get("shed"):
                        worker.source.set_shed_hint(
                            req.get("retry_after") or 1)
                    else:
                        worker.source.set_shed_hint(None)
                    self._json(200, {
                        "shed": worker.source._shed_hint is not None,
                        "retry_after": worker.source._shed_hint})
                elif self.path == "/drain":
                    # graceful scale-down, step 1: stop admitting. New
                    # client POSTs shed 503 + Retry-After; everything
                    # already admitted keeps flowing (the coordinator keeps
                    # polling / the local loop keeps serving) until
                    # /healthz shows inflight == 0 and the reconciler
                    # retires the process. The fleet parks nothing.
                    worker.source.set_draining(
                        bool(req.get("draining", True)))
                    with worker._lock:
                        backlog = len(worker._unacked)
                    self._json(200, {
                        "draining": worker.source._draining,
                        "inflight": worker.source.inflight(),
                        "unacked": backlog})
                else:
                    self.send_error(404)

            def log_message(self, *a):
                pass

        self.control = bind_with_probing(host, control_port, Control)
        self.control_port = self.control.server_address[1]
        self._thread = threading.Thread(target=self.control.serve_forever,
                                        daemon=True, name="http-control")
        self._thread.start()

    def close(self):
        if self.serving is not None:
            self.serving.stop()
        self.source.close()
        self.control.shutdown()
        self.control.server_close()


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--control-port", type=int, default=0)
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="load-shed (503 + Retry-After) past this many "
                         "queued requests; 0 = unbounded")
    ap.add_argument("--bundle", default=None,
                    help="serving-bundle directory: load the model, "
                         "capture every bucket's CUDA graph from the "
                         "built kernels and serve locally with the "
                         "continuous-batching engine (warm restart — no "
                         "live-traffic captures, no nvcc run)")
    ap.add_argument("--max-wait", type=float, default=0.01,
                    help="continuous batcher's max-wait deadline seconds "
                         "(bundle mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the bundle's model serves on "
                         "(bundle mode): cuda (default), cuda:N or cpu")
    ap.add_argument("--timeseries", type=float, default=None,
                    help="arm the in-process time-series sampler at this "
                         "tick interval (seconds) so the coordinator's fleet "
                         "federation can scrape GET /timeseries")
    args = ap.parse_args(argv)
    w = WorkerServer(args.host, args.port, args.control_port,
                     max_queue_depth=args.max_queue_depth,
                     bundle=args.bundle, max_wait=args.max_wait,
                     timeseries=args.timeseries, device=args.device)
    print(json.dumps({"port": w.source.port, "control": w.control_port}),
          flush=True)
    try:
        threading.Event().wait()   # serve until killed
    except KeyboardInterrupt:
        pass
    w.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
