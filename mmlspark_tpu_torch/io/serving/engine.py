"""The continuous-batching serving loop: admission -> buckets -> fused step
(the port's own copy of ``mmlspark_tpu/io/serving/engine.py``).

Replaces the polling ``ServingLoop`` on the model-serving hot path:

* requests are shed AT ADMISSION (the HTTP handler's queue bound + the
  SLO engine's ``should_shed()`` — 503 + Retry-After before any queueing)
  instead of timing out in the batch queue;
* the :class:`~.batcher.ContinuousBatcher` forms power-of-two bucket
  batches under a max-wait deadline;
* each bucket runs through the :class:`~.step.FusedServingStep` — one
  CUDA graph replay, captured ahead of traffic (optionally restored from
  a :mod:`.bundle`).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from ... import telemetry
from ...core.utils import get_logger
from ...resilience import faults
from ...resilience.policy import RetryPolicy
from ..http.server import HTTPSource
from .batcher import BucketPolicy, ContinuousBatcher
from .step import FusedServingStep

log = get_logger("io.serving")

_m_dispatch = telemetry.registry.histogram(
    "mmlspark_serving_dispatch_seconds",
    "device dispatch + reply encode per bucket batch (the worker-side "
    "half of request latency; fleet federation merges it bucket-wise "
    "across workers for per-worker attribution)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))


class ContinuousServingLoop:
    """Batch formation (+ host decode) pipelined against bucket dispatch.

    The producer side (a prefetch thread, same machinery as the polling
    loop's) forms bucketed batches with the :class:`ContinuousBatcher`
    and runs the host decode for each; the consumer side runs the
    device dispatch + replies — so while one bucket computes, the next
    one is already forming and decoding. ``step`` is a
    :class:`FusedServingStep` (or any object with ``decode`` /
    ``score_rows`` / ``encode`` — tests use doubles). Transient dispatch
    errors (site ``serving.batch``) get one retry; a failed batch
    replies 500 to exactly its own clients."""

    def __init__(self, source: HTTPSource, step,
                 policy: Optional[BucketPolicy] = None,
                 max_wait: float = 0.01, idle_timeout: float = 0.05,
                 prefetch_depth: int = 2):
        self.source = source
        self.step = step
        self.batcher = ContinuousBatcher(
            source, policy or getattr(step, "policy", None),
            max_wait=max_wait, idle_timeout=idle_timeout)
        self.prefetch_depth = prefetch_depth
        self._retry = RetryPolicy(name="serving.batch", max_attempts=2,
                                  base_delay=0.02, max_delay=0.1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-continuous")

    def _fail(self, exchanges, e: Exception):
        log.warning("continuous batch failed: %s", e)
        body = json.dumps({"error": str(e)})
        for ex in exchanges:
            self.source.respond(ex.id, 500, body)

    def _formed(self):
        """Producer: form bucket batches and host-decode their payloads
        while the consumer's current bucket runs on device. A row whose
        payload fails to decode answers 400 alone — it must not poison
        its whole bucket."""
        import numpy as np
        while not self._stop.is_set():
            formed = self.batcher.next_batch()
            if formed is None:
                continue
            exchanges, bucket = formed
            rows, keep = [], []
            for ex in exchanges:
                try:
                    rows.append(self.step.decode(ex.value))
                    keep.append(ex)
                except Exception as e:
                    self.source.respond(
                        ex.id, 400, json.dumps({"error": f"bad payload: "
                                                         f"{e}"}))
            if keep:
                now_ns = time.perf_counter_ns()
                for ex in keep:
                    ex.ledger.mark("decode", now_ns)
                yield keep, np.stack(rows), bucket

    def _dispatch(self, exchanges, rows, bucket: int):
        # dispatch-wait phase ends here: decode -> the consumer picked
        # this bucket off the prefetch handoff and starts device work
        now_ns = time.perf_counter_ns()
        for ex in exchanges:
            ex.ledger.mark("dispatch", now_ns)
        ledgers = [ex.ledger for ex in exchanges]

        def attempt(_a):
            with telemetry.trace.span("serve/bucket",
                                      rows=len(exchanges), bucket=bucket):
                faults.inject("serving.batch")
                if getattr(self.step, "accepts_ledgers", False):
                    out = self.step.score_rows(rows, bucket,
                                               ledgers=ledgers)
                else:   # step doubles with the bare signature
                    out = self.step.score_rows(rows, bucket)
                for ex, y in zip(exchanges, out):
                    self.source.respond(ex.id, 200, self.step.encode(y))
        t0 = time.perf_counter()
        try:
            self._retry.run(attempt)
        except Exception as e:   # reply 500s, never hang clients
            self._fail(exchanges, e)
        finally:
            # the dispatch timer is a phase VIEW of the ledger: pad start
            # (device attempt began) -> reply encoded, read off the first
            # exchange's stamps; wall clock only when the step double
            # never stamped
            led = exchanges[0].ledger.span_s("pad", "reply")
            # exemplar: the first already-retained trace in this bucket
            # (the retention verdict lands on the handler thread at reply
            # write, so this is best-effort and absent for healthy traffic)
            tid = None
            if telemetry.enabled():
                for ex in exchanges:
                    t = telemetry.context.trace_id_of(ex.trace)
                    if t and telemetry.trace.is_retained(t):
                        tid = t
                        break
            _m_dispatch.observe(
                led if led is not None else time.perf_counter() - t0,
                exemplar=tid)

    def _run(self):
        from ...parallel import prefetch as prefetchlib
        it = prefetchlib.prefetched(self._formed,
                                    depth=self.prefetch_depth,
                                    name="serving-cb",
                                    span="serve/prefetch")
        try:
            for exchanges, rows, bucket in it:
                self._dispatch(exchanges, rows, bucket)
        finally:
            it.close()

    def start(self) -> "ContinuousServingLoop":
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def serve_continuous(step: FusedServingStep, host: str = "127.0.0.1",
                     port: int = 0, max_wait: float = 0.01,
                     max_queue_depth: int = 0, slo=None,
                     bundle_dir: Optional[str] = None,
                     warm: bool = True):
    """Spin up the continuous-batching engine for a fused step; returns
    ``(source, loop)``. Admission control: ``max_queue_depth`` bounds the
    queue and ``slo`` (an :class:`~...telemetry.slo.SLOEngine`) sheds on
    burning ``shed_on_breach`` objectives — both answer 503 +
    Retry-After at the door. ``warm=True`` captures every bucket's graph
    before the first request; pass ``bundle_dir`` to additionally commit
    the model+capture bundle there (restart warm-start)."""
    if warm:
        step.compile_buckets()
    if bundle_dir is not None:
        from .bundle import save_bundle
        save_bundle(bundle_dir, step)
    source = HTTPSource(host=host, port=port,
                        max_queue_depth=max_queue_depth, slo=slo,
                        name="serving")
    loop = ContinuousServingLoop(source, step, max_wait=max_wait).start()
    return source, loop
