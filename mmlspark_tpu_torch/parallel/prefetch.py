"""Bounded asynchronous prefetching: overlap host batch prep + H2D transfer
with device compute.

The port of ``mmlspark_tpu/parallel/prefetch.py``, with its telemetry (the
queue-depth gauge, the produce and stall histograms and the optional
producer span, under the JAX package's names; nothing is measured while
telemetry is off). The trainer's feed path is a producer/consumer pair: the producer is HOST work (index gather, staging
into pinned memory, the non-blocking copy to the card) and the consumer is
the training step. Here the host work for step ``s+1..s+depth`` runs on a
daemon thread while step ``s`` runs, so the consuming loop receives batches
already on their way to the device.

Semantics (the contract the tests pin):

  * **bounded depth** — at most ``depth`` produced-but-unconsumed items
    exist at any moment (a semaphore slot is acquired BEFORE the producer
    runs, so prefetched device batches never hold more than ``depth``
    batches of device memory);
  * **in-order** — items arrive exactly in producer order (one worker
    thread, one FIFO queue), so a prefetched fit replays the synchronous
    loss trajectory bit for bit;
  * **exception propagation** — a producer error re-raises at the
    consuming ``next()``; the worker never dies silently and the consumer
    never deadlocks on a dead producer;
  * **prompt shutdown** — ``close()`` (or exiting the ``with`` block)
    wakes a blocked producer and joins the thread; safe to call from a
    consumer that exits early (divergence halt).

CUDA note: the producer enqueues its copies on its thread's current stream,
which is the default stream unless the caller set another; the training
step runs on the same stream, so a copy is ordered before the step that
reads it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional, Union

from .. import telemetry
from ..telemetry.registry import _state

# prefetch telemetry (off-by-default no-ops; MMLSPARK_TPU_TELEMETRY=1)
_m_queue_depth = telemetry.registry.gauge(
    "mmlspark_prefetch_queue_depth",
    "prefetched items currently produced but not yet consumed")
_m_produce_time = telemetry.registry.histogram(
    "mmlspark_prefetch_produce_seconds",
    "host prep + device copy start per prefetched item (producer thread) "
    "— the work the prefetcher hides behind device compute")
_m_producer_stall = telemetry.registry.histogram(
    "mmlspark_prefetch_producer_stall_seconds",
    "time the producer spent blocked because `depth` items were already "
    "outstanding (consumer-bound; harmless)")
_m_consumer_stall = telemetry.registry.histogram(
    "mmlspark_prefetch_consumer_stall_seconds",
    "time the consumer spent waiting for the next prefetched item "
    "(host-bound; the stall the prefetcher exists to shrink)")

#: queue sentinels (kind tags; unique objects, compared by identity)
_ITEM, _DONE, _ERROR = object(), object(), object()


class DevicePrefetcher:
    """Iterator running ``source`` on a background thread, ``depth`` ahead.

    ``source`` is an iterable (or a zero-arg callable returning one) whose
    ``next()`` performs the per-item host work — build the batch AND start
    its copy to the device there, so the consumer receives device tensors.

    ``depth=0`` is honored by :func:`prefetched`, which returns the plain
    iterator (the synchronous path); ``DevicePrefetcher`` itself requires
    ``depth >= 1``. ``span`` names a trace span around each produced item
    (recorded while telemetry is on).
    """

    def __init__(self, source: Union[Iterable, Callable[[], Iterable]],
                 depth: int = 2, name: str = "prefetch",
                 span: Optional[str] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        self.name = name
        #: items the producer thread has finished (monotonic); lets tests
        #: assert a prefetched run actually ran ahead
        self.items = 0
        self._source = source
        self._span = span
        # slots acquired BEFORE producing bound produced-but-unconsumed
        # items at exactly `depth`; the queue itself can stay unbounded
        self._slots = threading.Semaphore(depth)
        self._q: "queue.Queue[tuple[object, object]]" = queue.Queue()
        self._stop = threading.Event()
        # consumer-side cursor: thread-confined, never touched by the
        # producer thread (whose entry point is _work)
        self._finished = False
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name=f"prefetch-{name}")
        self._thread.start()

    # ---- producer (worker thread) ----
    def _acquire_slot(self) -> bool:
        """Blocking slot acquire that stays responsive to close()."""
        t0 = time.perf_counter() if _state.enabled else 0.0
        while not self._stop.is_set():
            if self._slots.acquire(timeout=0.05):
                if _state.enabled:
                    _m_producer_stall.observe(time.perf_counter() - t0)
                return True
        return False

    def _work(self):
        try:
            it = iter(self._source() if callable(self._source)
                      else self._source)
            while not self._stop.is_set():
                if not self._acquire_slot():
                    return              # closed while waiting for a slot
                if _state.enabled:
                    t0 = time.perf_counter()
                    if self._span:
                        with telemetry.trace.span(self._span,
                                                  source=self.name):
                            item = next(it, _DONE)
                    else:
                        item = next(it, _DONE)
                    if item is not _DONE:
                        _m_produce_time.observe(time.perf_counter() - t0)
                else:
                    item = next(it, _DONE)
                if item is _DONE:
                    break
                self.items += 1
                self._q.put((_ITEM, item))
                _m_queue_depth.set(self._q.qsize())
        except BaseException as e:       # re-raised at the consumer's next()
            self._q.put((_ERROR, e))
        else:
            self._q.put((_DONE, None))

    # ---- consumer ----
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter() if _state.enabled else 0.0
        while True:
            try:
                kind, item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                # the worker's except/else clauses always enqueue a
                # terminal record, but a worker killed without running them
                # (interpreter teardown) must not hang us
                if not self._thread.is_alive():
                    self._finished = True
                    raise RuntimeError(
                        f"prefetch worker {self.name!r} died without "
                        f"delivering") from None
        if kind is _ITEM:
            self._slots.release()
            if _state.enabled:
                _m_consumer_stall.observe(time.perf_counter() - t0)
                _m_queue_depth.set(self._q.qsize())
            return item
        self._finished = True
        if kind is _ERROR:
            self.close()
            raise item
        self._thread.join(timeout=5.0)
        raise StopIteration

    # ---- lifecycle ----
    def close(self):
        """Stop the producer and reclaim the thread. Idempotent; safe on
        early consumer exit — a producer blocked on a full prefetch window
        wakes within one slot-poll tick."""
        self._stop.set()
        self._finished = True
        try:
            while True:
                self._q.get_nowait()
                self._slots.release()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        _m_queue_depth.set(0)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def prefetched(source: Union[Iterable, Callable[[], Iterable]],
               depth: int = 2, name: str = "prefetch",
               span: Optional[str] = None) -> Iterator:
    """``DevicePrefetcher`` when ``depth >= 1``, the plain (synchronous)
    iterator when ``depth == 0`` — the one switch call sites need. The
    returned iterator always supports ``close()`` so consumer ``finally``
    blocks are uniform."""
    if depth <= 0:
        return _SyncIter(iter(source() if callable(source) else source))
    return DevicePrefetcher(source, depth=depth, name=name, span=span)


class _SyncIter:
    """Plain iterator with a no-op close() (depth=0)."""

    __slots__ = ("_it",)

    def __init__(self, it: Iterator):
        self._it = it

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def close(self):
        pass
