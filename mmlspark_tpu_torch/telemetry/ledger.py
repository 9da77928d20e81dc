"""Per-request phase ledger: monotonic-clock phase stamps accumulated on
the serving exchange envelope.

Every request admitted by the continuous serving path carries one
:class:`PhaseLedger` (a slot on the HTTP ``_Exchange``). Each stage of
the pipeline stamps the ledger when the request *leaves* that stage:

======== ==============================================================
phase    covers (end stamped by)
======== ==============================================================
queue    admission -> picked out of the pending queue (``drain``)
form     pick -> batch formed / pad bucket selected (``next_batch``)
decode   batch -> host payload decode done (``_formed``)
dispatch decode -> the engine began the device attempt (``_dispatch``)
pad      attempt start -> padded batch buffer filled (``score_rows``)
device   pad -> device execution complete (a stream synchronize)
readback readback of device results to host (``.cpu()``)
reply    reply encoded and the waiter released (``respond``)
======== ==============================================================

The stamps are raw ``time.perf_counter_ns()`` values — the same clock as
the client-observed ``mmlspark_http_request_seconds`` observation — so
the phase durations sum to the end-to-end request latency up to the
reply-write syscall. Stamping is always on (two attribute lookups and a
``perf_counter_ns`` per phase); span emission and metric observation
remain gated behind the telemetry switch.

At request completion :func:`emit_phase_spans` turns the ledger into
``serve/phase`` child spans (one per phase, the phase name in the span
args) under the request's trace, and :func:`observe_phases` feeds the
``mmlspark_serving_phase_seconds{phase=...}`` histogram that the SLO /
autoscale read path and ``bench_serving.py --open-loop`` consume.

The PyTorch port's own copy of ``mmlspark_tpu/telemetry/ledger.py`` (it
imports no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

#: canonical stamp order; a ledger may be missing a suffix (shed or
#: errored requests never reach the later stages) but never reorders.
PHASES = ("queue", "form", "decode", "dispatch", "pad", "device",
          "readback", "reply")


class PhaseLedger:
    """Append-only (phase, perf_counter_ns) stamps for one request."""

    __slots__ = ("t0_ns", "stamps")

    def __init__(self, t0_ns: Optional[int] = None):
        self.t0_ns = int(t0_ns) if t0_ns is not None \
            else time.perf_counter_ns()
        self.stamps: list[tuple[str, int]] = []

    def mark(self, phase: str, t_ns: Optional[int] = None) -> None:
        """Stamp the end of ``phase`` (now unless ``t_ns`` given)."""
        self.stamps.append(
            (phase, int(t_ns) if t_ns is not None
             else time.perf_counter_ns()))

    def spans_ns(self) -> Iterator[tuple[str, int, int]]:
        """Yield ``(phase, start_ns, end_ns)`` for each stamped phase;
        each phase starts where the previous one ended (the first starts
        at admission)."""
        prev = self.t0_ns
        for phase, t in self.stamps:
            yield phase, prev, t
            prev = t

    def phase_s(self, phase: str) -> Optional[float]:
        """Duration of one phase in seconds, or None if not stamped."""
        for name, start, end in self.spans_ns():
            if name == phase:
                return (end - start) / 1e9
        return None

    def span_s(self, first: str, last: str) -> Optional[float]:
        """Seconds from the *start* of ``first`` to the *end* of
        ``last``; None unless both phases are stamped in order."""
        start = end = None
        for name, s, e in self.spans_ns():
            if name == first:
                start = s
            if name == last:
                end = e
        if start is None or end is None or end < start:
            return None
        return (end - start) / 1e9

    def elapsed_s(self, phase: Optional[str] = None) -> Optional[float]:
        """Seconds from admission to the end of ``phase`` (or to the
        last stamp when ``phase`` is None). None if unstamped."""
        if not self.stamps:
            return None
        if phase is None:
            return (self.stamps[-1][1] - self.t0_ns) / 1e9
        for name, t in self.stamps:
            if name == phase:
                return (t - self.t0_ns) / 1e9
        return None

    def total_s(self) -> Optional[float]:
        """Admission to last stamp — what the phase spans sum to."""
        return self.elapsed_s()

    def as_dict(self) -> dict:
        """Phase -> seconds map (for debug payloads and the bench)."""
        return {name: (end - start) / 1e9
                for name, start, end in self.spans_ns()}


def emit_phase_spans(trace, ledger: PhaseLedger, parent) -> None:
    """Record one ``serve/phase`` span per stamped phase on ``trace``
    (a Tracer) under ``parent`` (a SpanContext / traceparent). The span
    name is a single literal — the phase rides the ``phase`` arg — so
    the span catalogue stays enumerable."""
    for i, (phase, start, end) in enumerate(ledger.spans_ns()):
        trace.complete("serve/phase", start, end_ns=end, parent=parent,
                       phase=phase, seq=i)


def observe_phases(hist, ledger: PhaseLedger) -> None:
    """Feed every stamped phase duration into a labelled histogram
    (``hist.labels(phase=...).observe(seconds)``)."""
    for phase, start, end in ledger.spans_ns():
        hist.labels(phase=phase).observe((end - start) / 1e9)
