"""PowerBI writer of the PyTorch port (reference: io/powerbi/.../
PowerBIWriter.scala:21-45 — JSON POST of row batches per partition to a
push-dataset url): the port's own copy of ``mmlspark_tpu/io/powerbi.py``,
with the same fault site (``powerbi.post``), status handling and retry
policy, sending through the standard library's ``urllib``
(:func:`.http.transformer.request`) where the JAX package uses
``requests``."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.utils import get_logger
from .http.transformer import request
from ..resilience import faults
from ..resilience.policy import RetryPolicy

log = get_logger("io.powerbi")


def _jsonable_rows(df: DataFrame) -> list[dict]:
    rows = []
    for r in df.iterRows():
        out = {}
        for k, v in r.items():
            if isinstance(v, (np.generic,)):
                v = v.item()
            elif isinstance(v, np.ndarray):
                v = v.tolist()
            out[k] = v
        rows.append(out)
    return rows


def _post_batch(url: str, payload: str, timeout: float):
    """One POST; non-2xx raises IOError tagged ``transient`` for 5xx/429
    so the shared RetryPolicy classification can tell a rate-limit blip
    from a 4xx that will never succeed."""
    faults.inject("powerbi.post")
    resp = request("POST", url, data=payload,
                   headers={"Content-Type": "application/json"},
                   timeout=timeout)
    if not (200 <= resp.status_code < 300):
        err = IOError(f"PowerBI POST failed: {resp.status_code} "
                      f"{resp.text[:200]}")
        err.transient = resp.status_code >= 500 or resp.status_code == 429
        raise err
    return resp


def write(df: DataFrame, url: str, batch_size: int = 1000,
          timeout: float = 30.0, retry: Optional[RetryPolicy] = None) -> int:
    """POST rows as JSON arrays in batches per partition; returns the number
    of batches sent. Raises on non-2xx like the reference's writer.
    ``retry`` (a shared RetryPolicy) re-attempts transient failures —
    connection errors, timeouts, 5xx/429 — per batch; default None keeps
    the single-attempt contract (StreamWriter supplies its own backoff)."""
    sent = 0
    for part in df.partitions():
        for batch in part.iterBatches(batch_size):
            payload = json.dumps({"rows": _jsonable_rows(batch)})
            if retry is None:
                _post_batch(url, payload, timeout)
            else:
                retry.run(lambda _a, p=payload: _post_batch(url, p,
                                                            timeout))
            sent += 1
    return sent


class StreamWriter:
    """Continuous micro-batch POST loop (reference PowerBIWriter.stream wires
    the same POST into Spark structured streaming; here the source is any
    callable returning the next DataFrame batch — e.g. an HTTPSource's
    getBatch or a generator over a live table)."""

    def __init__(self, get_batch, url: str, interval: float = 1.0,
                 batch_size: int = 1000, timeout: float = 30.0,
                 retry: Optional[RetryPolicy] = None):
        import threading
        self._get_batch = get_batch
        self.url = url
        self.interval = interval
        self.batch_size = batch_size
        self.timeout = timeout
        self.batches_sent = 0
        self.errors = 0
        # the shared backoff schedule (replacing this writer's old
        # fixed-interval retry): attempts are unbounded — at-least-once
        # delivery retries forever — but the wait between them grows with
        # the consecutive-failure streak, full-jitter, capped at 30s
        self.retry = retry or RetryPolicy(
            name="powerbi.stream", max_attempts=2 ** 31,
            base_delay=max(interval, 1e-3), max_delay=30.0)
        self._fail_streak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        pending = None               # at-least-once: a failed batch is
        while not self._stop.is_set():  # retried, never dropped
            if pending is None:
                try:
                    df = self._get_batch()
                except Exception as e:  # source failure: log, keep streaming
                    log.warning("powerbi stream source failed: %s", e)
                    self.errors += 1
                    df = None
            else:
                df = pending
            if df is not None and len(df):
                try:
                    self.batches_sent += write(df, self.url,
                                               batch_size=self.batch_size,
                                               timeout=self.timeout)
                    pending = None
                    self._fail_streak = 0
                except Exception as e:  # sink failure: retry this batch
                    log.warning("powerbi stream post failed (will retry): %s",
                                e)
                    self.errors += 1
                    pending = df
                    self._fail_streak += 1
            # throttle EVERY tick — the PowerBI push API is rate-limited
            # and a down endpoint must not spin the loop hot. A failure
            # streak stretches the wait by the policy's jittered backoff.
            wait = self.interval
            if self._fail_streak:
                wait = max(wait, self.retry.backoff(self._fail_streak - 1))
            self._stop.wait(wait)

    def start(self) -> "StreamWriter":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def stream(get_batch, url: str, interval: float = 1.0,
           batch_size: int = 1000) -> StreamWriter:
    """Start a continuous writer; returns the running StreamWriter
    (reference PowerBIWriter.stream returns the StreamingQuery the same
    way)."""
    return StreamWriter(get_batch, url, interval=interval,
                        batch_size=batch_size).start()
