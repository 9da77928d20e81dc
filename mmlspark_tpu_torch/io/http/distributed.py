"""Distributed HTTP serving: N worker servers behind one batching loop (the
port's own copy of ``mmlspark_tpu/io/http/distributed.py``).

The DistributedHTTPSource analog (reference: io/http/.../
DistributedHTTPSource.scala:270 — every executor JVM runs a JVMSharedServer
with port probing :237-250; in-flight exchanges live in a round-robin
MultiChannelMap :37-98; replies are routed back by (batch, uuid) from
DistributedHTTPSink:418). Here workers are port-probed HTTP servers in one
serving process (the executor analog on a GPU host); their requests merge
into one columnar micro-batch so the whole fleet feeds a single device
dispatch. Nothing here is multi-host.

Exchange ids are worker-qualified ("<worker>:<uuid>"), which keeps the
source surface identical to HTTPSource — the plain ServingLoop/HTTPSink
drive the whole fleet unchanged.

``SharedVariable`` reproduces the reference's cross-task JVM-singleton state
(SharedVariable.scala:18-65): one process-wide value per key, created once,
visible to every thread.
"""

from __future__ import annotations

import threading

import numpy as np

from ...core.dataframe import DataFrame
from ...core.utils import get_logger, object_column
from .server import HTTPSource, ServingLoop

log = get_logger("http.distributed")


class SharedVariable:
    """Process-wide lazily-created singletons keyed by name (reference
    SharedVariable.scala:18-65). Factories run under a PER-KEY lock, outside
    the registry lock — a slow factory (30s model load) never blocks other
    keys, and a factory may itself get() other keys."""

    _pool: dict[str, object] = {}
    _key_locks: dict[str, threading.Lock] = {}
    _registry_lock = threading.Lock()

    @classmethod
    def get(cls, key: str, factory):
        with cls._registry_lock:
            if key in cls._pool:
                return cls._pool[key]
            key_lock = cls._key_locks.setdefault(key, threading.Lock())
        with key_lock:
            with cls._registry_lock:
                if key in cls._pool:      # lost the race: another thread built it
                    return cls._pool[key]
            value = factory()
            with cls._registry_lock:
                cls._pool[key] = value
            return value

    @classmethod
    def remove(cls, key: str) -> None:
        with cls._registry_lock:
            cls._pool.pop(key, None)
            cls._key_locks.pop(key, None)

    @classmethod
    def clear(cls) -> None:
        with cls._registry_lock:
            cls._pool.clear()
            cls._key_locks.clear()


class DistributedHTTPSource:
    """N port-probed worker servers whose requests merge into one batch.

    Same (getBatch/respond/close) surface as HTTPSource; rows are
    (id, value) with worker-qualified ids. HTTPSource itself probes upward
    from the requested port (the reference's probing loop,
    DistributedHTTPSource.scala:237-250).
    """

    def __init__(self, n_workers: int = 2, host: str = "127.0.0.1",
                 base_port: int = 0, max_queue_depth: int = 0):
        self.workers: list[HTTPSource] = []
        for _ in range(n_workers):
            self.workers.append(HTTPSource(host=host, port=base_port,
                                           max_queue_depth=max_queue_depth))
            if base_port:
                base_port = self.workers[-1].port + 1
        log.info("distributed source on ports %s",
                 [w.port for w in self.workers])

    @property
    def urls(self) -> list[str]:
        return [w.url for w in self.workers]

    def getBatch(self, max_rows: int = 1024,
                 timeout: float = 0.05) -> DataFrame:
        per = max(1, max_rows // max(1, len(self.workers)))
        ids, values = [], []
        for wi, w in enumerate(self.workers):
            batch = w.getBatch(per, timeout=timeout)
            ids.extend(f"{wi}:{ex_id}" for ex_id in batch.col("id"))
            values.extend(batch.col("value").tolist())
        # skewed traffic: hand idle workers' unused quota to busy ones
        # (zero-timeout second pass, so it only drains already-queued rows)
        budget = max_rows - len(ids)
        for wi, w in enumerate(self.workers):
            if budget <= 0:
                break
            batch = w.getBatch(budget, timeout=0)
            got = batch.count()
            if got:
                ids.extend(f"{wi}:{ex_id}" for ex_id in batch.col("id"))
                values.extend(batch.col("value").tolist())
                budget -= got
        if not ids:
            return DataFrame({"id": np.array([], dtype=object),
                              "value": np.array([], dtype=object)})
        return DataFrame({"id": object_column(ids),
                          "value": object_column(values)})

    def trace_for(self, ex_id: str):
        """Ingress traceparent of a worker-qualified exchange (the same
        envelope surface HTTPSource exposes)."""
        wi, raw = ex_id.split(":", 1)
        return self.workers[int(wi)].trace_for(raw)

    def respond(self, ex_id: str, code: int, body) -> None:
        wi, raw = ex_id.split(":", 1)
        self.workers[int(wi)].respond(raw, code, body)

    def close(self) -> None:
        for w in self.workers:
            w.close()


class DistributedServingLoop(ServingLoop):
    """The plain batching loop over the whole worker fleet; stop() also
    shuts the fleet down."""

    def stop(self):
        super().stop()
        self.source.close()


def serve_distributed(transformer, n_workers: int = 2,
                      host: str = "127.0.0.1", base_port: int = 0,
                      max_batch: int = 1024, prefetch_depth: int = 2,
                      prepare=None, max_queue_depth: int = 0):
    """Spin up the worker fleet + loop; returns (source, loop). One
    transformer call (one device dispatch) serves every worker's in-flight
    requests per micro-batch; the next micro-batch drains (and optionally
    ``prepare``s) on the loop's prefetch thread meanwhile."""
    source = DistributedHTTPSource(n_workers=n_workers, host=host,
                                   base_port=base_port,
                                   max_queue_depth=max_queue_depth)
    loop = DistributedServingLoop(source, transformer, max_batch,
                                  prefetch_depth=prefetch_depth,
                                  prepare=prepare).start()
    return source, loop
