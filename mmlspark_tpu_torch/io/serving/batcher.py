"""Continuous batching over static shape buckets (the port's own copy of
``mmlspark_tpu/io/serving/batcher.py``).

The polling loop (``io/http/server.py`` ``getBatch``) drains *whatever
arrived* since the last drain: under light load every request rides alone
(one dispatch per row), under heavy load batch sizes are whatever the
race produced — a long ragged tail of distinct shapes, each one a fresh
CUDA-graph capture on live traffic. Serving is won the other way around
(PAPERS.md, arxiv 2605.25645): requests are admitted into a SMALL STATIC
SET of shape buckets (power-of-two row counts), each bucket captured
exactly once as a CUDA graph ahead of time (:mod:`.step`, :mod:`.bundle`),
and batch formation is governed by two knobs:

* **fill** — a batch dispatches immediately once a full ``max_batch``
  bucket's worth of rows is waiting (zero padding, maximal device
  utilization);
* **max-wait** — otherwise the OLDEST waiting request's age is bounded
  by ``max_wait``: at its deadline the batch dispatches with whatever is
  there, padded up to the smallest bucket that fits — a lone 2am request
  never waits for a full bucket.

Admission control happens BEFORE a request enters this machinery: the
HTTP handler sheds (503 + Retry-After) on queue depth and on the SLO
engine's ``should_shed()`` verdict, so overload is rejected at the door
instead of timing out in the batch queue (docs/reliability.md).
"""

from __future__ import annotations

import time
from typing import Optional

from ... import telemetry
from ...core.utils import get_logger

log = get_logger("io.serving")

_m_bucket_rows = telemetry.registry.histogram(
    "mmlspark_serving_bucket_rows",
    "dispatched bucket size (padded row count) per continuous batch",
    buckets=telemetry.pow2_buckets(1, 4096))
_m_occupancy = telemetry.registry.histogram(
    "mmlspark_serving_bucket_occupancy",
    "real rows / bucket rows of each dispatched continuous batch (1.0 = "
    "zero padding)",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_m_pad_waste = telemetry.registry.gauge(
    "mmlspark_serving_pad_waste",
    "padding fraction (pad rows / bucket rows) of the last dispatched "
    "bucket")
_m_padded_rows = telemetry.registry.counter(
    "mmlspark_serving_padded_rows_total",
    "cumulative padding rows dispatched (device work spent on filler)")
_m_form_wait = telemetry.registry.histogram(
    "mmlspark_serving_batch_wait_seconds",
    "batch-formation wait: oldest request's arrival -> its bucket "
    "dispatched (bounded by the batcher's max_wait)")


def pow2_bucket(n: int, lo: int = 8, hi: int = 1024) -> int:
    """Smallest power-of-two bucket in [lo, hi] holding ``n`` rows (n
    beyond hi is the caller's split problem — see BucketPolicy)."""
    b = lo
    while b < n and b < hi:
        b <<= 1
    return b


class BucketPolicy:
    """The static shape-bucket set: power-of-two row counts from
    ``min_bucket`` up to ``max_batch``. Every captured graph, every
    bundle entry, and every dispatched batch uses exactly one of these
    shapes — the whole serving path captures
    ``log2(max_batch/min_bucket) + 1`` graphs, ever."""

    def __init__(self, max_batch: int = 256, min_bucket: int = 8):
        if min_bucket < 1 or max_batch < min_bucket:
            raise ValueError(f"need 1 <= min_bucket <= max_batch, got "
                             f"({min_bucket}, {max_batch})")
        self.min_bucket = pow2_bucket(min_bucket, lo=1, hi=1 << 30)
        self.max_batch = pow2_bucket(max_batch, lo=self.min_bucket,
                                     hi=1 << 30)
        self.buckets = []
        b = self.min_bucket
        while b <= self.max_batch:
            self.buckets.append(b)
            b <<= 1

    def bucket_for(self, n: int) -> int:
        """The bucket a batch of ``n`` real rows dispatches in (n must
        not exceed max_batch — the batcher never forms a larger batch)."""
        if n > self.max_batch:
            raise ValueError(f"{n} rows exceed max_batch="
                             f"{self.max_batch}; split the batch")
        return pow2_bucket(max(n, 1), self.min_bucket, self.max_batch)


class ContinuousBatcher:
    """Forms bucketed batches from an :class:`~..http.server.HTTPSource`.

    ``next_batch()`` blocks (bounded by ``idle_timeout`` so callers can
    poll a stop flag) until it can return ``(exchanges, bucket)``:

    * the moment ``max_batch`` rows are waiting -> a full bucket, zero
      padding;
    * else when the oldest waiting request turns ``max_wait`` old -> all
      waiting rows (<= max_batch), padded up to ``bucket_for(n)``.

    Rows beyond ``max_batch`` stay queued in the source with their
    original arrival timestamps, so a deferred row's deadline clock
    never resets — an over-aged head-of-queue row makes the next batch
    dispatch immediately.
    """

    def __init__(self, source, policy: Optional[BucketPolicy] = None,
                 max_wait: float = 0.01, idle_timeout: float = 0.05):
        self.source = source
        self.policy = policy or BucketPolicy()
        self.max_wait = max_wait
        self.idle_timeout = idle_timeout

    def next_batch(self):
        """One formed batch ``(exchanges, bucket_rows)`` or ``None``
        after an idle ``idle_timeout`` with nothing waiting (the caller's
        chance to check its stop flag)."""
        cap = self.policy.max_batch
        buf = self.source.drain(cap, timeout=self.idle_timeout)
        if not buf:
            return None
        # fill-or-deadline: top up until a full bucket is reached or the
        # oldest request's max-wait budget is spent
        deadline_ns = buf[0].t0_ns + int(self.max_wait * 1e9)
        while len(buf) < cap:
            remain = (deadline_ns - time.perf_counter_ns()) / 1e9
            if remain <= 0:
                break
            more = self.source.drain(cap - len(buf),
                                     timeout=min(remain, 0.005))
            if more:
                buf.extend(more)
        bucket = self.policy.bucket_for(len(buf))
        now_ns = time.perf_counter_ns()
        # the batch is formed and its pad bucket chosen: stamp every
        # member's phase ledger (deferred rows drained into a LATER batch
        # get their form stamp then — their queue/form phases stay honest
        # because the ledger clock is the arrival t0, never reset)
        for ex in buf:
            ex.ledger.mark("form", now_ns)
        _m_bucket_rows.observe(bucket)
        _m_occupancy.observe(len(buf) / bucket)
        _m_pad_waste.set((bucket - len(buf)) / bucket)
        if bucket > len(buf):
            _m_padded_rows.inc(bucket - len(buf))
        # batch_wait is a phase VIEW of the oldest member's ledger:
        # admission -> form stamp, the same number the pre-ledger timer
        # measured, now derived from the shared stamps
        wait_s = buf[0].ledger.elapsed_s("form")
        _m_form_wait.observe(max(0.0, wait_s if wait_s is not None
                                 else (now_ns - buf[0].t0_ns) / 1e9))
        return buf, bucket
