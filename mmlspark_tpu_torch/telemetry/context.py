"""Distributed trace context: W3C-style ``traceparent`` propagation.

A request that crosses client -> serving server -> fleet driver -> device
step leaves disconnected span fragments unless every hop shares one
trace identity. This module carries that identity:

  * a :class:`SpanContext` is ``(trace_id, span_id)`` — 16-byte /
    8-byte ids rendered as the W3C ``traceparent`` header
    (``00-<32 hex>-<16 hex>-01``), so any HTTP client or proxy that
    already speaks trace-context interoperates;
  * ingress (the serving HTTP handler) parses the incoming header or
    mints a fresh trace, and every downstream hop — control-channel
    polls, reply deliveries, outbound HTTPTransformer requests —
    forwards the CURRENT span's traceparent;
  * in-process the context rides a thread-local stack: entering a
    :meth:`Tracer.span` while a trace is active pushes a child context,
    so nested spans parent correctly with no explicit bookkeeping, and
    retry/breaker/fault instants auto-tag the request that owned them.

Everything here is inert until a context is installed (``use()``), so
the disabled-telemetry fast path never touches it.

Cross-process assembly: each process exports its own Chrome-trace file;
:func:`mmlspark_tpu_torch.telemetry.merge_traces` joins them into one file
whose events share ``args.trace_id`` — Perfetto then shows the
per-request tree spanning pids.

The PyTorch port's own copy of ``mmlspark_tpu/telemetry/context.py`` (it
imports no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import threading
import uuid
from typing import Optional

#: header name, W3C trace-context
TRACEPARENT = "traceparent"


class SpanContext:
    """One (trace_id, span_id) hop identity. Immutable by convention."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self) -> "SpanContext":
        """Same trace, fresh span id (the caller records ``self.span_id``
        as the parent)."""
        return SpanContext(self.trace_id, _new_span_id())

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def __repr__(self):
        return f"SpanContext({self.to_traceparent()})"

    def __eq__(self, other):
        return (isinstance(other, SpanContext)
                and other.trace_id == self.trace_id
                and other.span_id == self.span_id)


def _new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def new_trace() -> SpanContext:
    """Fresh root context (request ingress with no incoming header)."""
    return SpanContext(uuid.uuid4().hex, _new_span_id())


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """``00-<trace>-<span>-<flags>`` -> context, or None on anything
    malformed (a bad header must not fail a request — it just starts a
    fresh trace)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


def trace_id_of(ctx) -> Optional[str]:
    """The 32-hex trace id of a :class:`SpanContext` or raw
    ``traceparent`` string (None on anything malformed). The tail
    sampler and exemplar observe sites key on the trace id alone — a
    request's hops share it while span ids differ."""
    if isinstance(ctx, SpanContext):
        return ctx.trace_id
    if isinstance(ctx, str):
        parsed = parse_traceparent(ctx)
        return parsed.trace_id if parsed is not None else None
    return None


def from_headers(headers) -> Optional[SpanContext]:
    """Extract a context from an HTTP headers mapping (case-insensitive
    ``get`` — http.server's Message and requests' dicts both work)."""
    try:
        return parse_traceparent(headers.get(TRACEPARENT))
    except Exception:
        return None


# ---------------------------------------------------------- current context

class _Stack(threading.local):
    def __init__(self):
        self.items: list = []


_stack = _Stack()


def current() -> Optional[SpanContext]:
    items = _stack.items
    return items[-1] if items else None


def current_traceparent() -> Optional[str]:
    ctx = current()
    return ctx.to_traceparent() if ctx is not None else None


def _push(ctx: SpanContext):
    _stack.items.append(ctx)


def _pop():
    if _stack.items:
        _stack.items.pop()


class use:
    """Install ``ctx`` as the current context for the with-body.

    Accepts a :class:`SpanContext`, a raw ``traceparent`` string, or
    ``None`` (no-op — call sites pass whatever the envelope carried
    without checking)."""

    __slots__ = ("_ctx",)

    def __init__(self, ctx):
        if isinstance(ctx, str):
            ctx = parse_traceparent(ctx)
        self._ctx = ctx

    def __enter__(self):
        if self._ctx is not None:
            _push(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        if self._ctx is not None:
            _pop()
        return False
