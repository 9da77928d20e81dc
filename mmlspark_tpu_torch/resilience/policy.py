"""Shared retry and circuit-breaking policies.

Every network/IO call site in the framework recovers through these two
classes instead of hand-rolled loops: :class:`RetryPolicy` decides *whether*
and *when* to try again (transient-vs-fatal classification, exponential
backoff with full jitter, a hard deadline budget), :class:`CircuitBreaker`
decides whether to try *at all* (a target that keeps failing is skipped
until a reset-timeout probe succeeds, so a dead worker is not hammered on
every poll round).

Both are cheap when idle and thread-safe when shared: serving loops, the
fleet driver, and the supervisor all update the same breaker concurrently.
Telemetry: ``mmlspark_retry_attempts_total{policy}``,
``mmlspark_retry_exhausted_total{policy}``,
``mmlspark_breaker_state{breaker,target}`` (0 closed / 1 half-open /
2 open), ``mmlspark_breaker_opens_total{breaker,target}`` and
``mmlspark_breaker_short_circuits_total{breaker,target}``.

The PyTorch port's own copy of ``mmlspark_tpu/resilience/policy.py`` (it
imports no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
import urllib.error
import weakref
from typing import Callable, Optional, Sequence, Union

from .. import telemetry
from ..core.utils import get_logger

log = get_logger("resilience.policy")

_m_retries = telemetry.registry.counter(
    "mmlspark_retry_attempts_total",
    "retried attempts (beyond the first) by policy name",
    labels=("policy",))
_m_exhausted = telemetry.registry.counter(
    "mmlspark_retry_exhausted_total",
    "operations that failed after exhausting their retry budget",
    labels=("policy",))
_m_breaker_state = telemetry.registry.gauge(
    "mmlspark_breaker_state",
    "circuit state per target: 0 closed, 1 half-open, 2 open",
    labels=("breaker", "target"))
_m_breaker_opens = telemetry.registry.counter(
    "mmlspark_breaker_opens_total",
    "closed/half-open -> open transitions", labels=("breaker", "target"))
_m_breaker_short = telemetry.registry.counter(
    "mmlspark_breaker_short_circuits_total",
    "calls rejected without attempting because the circuit was open",
    labels=("breaker", "target"))


def default_transient(exc: BaseException) -> bool:
    """The shared transient-vs-fatal classification: network-shaped errors
    (connection loss, timeouts, 5xx/429 responses, a peer dying
    mid-response) are worth another attempt; everything else — bad input,
    assertion failures, programming errors — is fatal and re-raises
    immediately. Call sites can tag any exception transient explicitly by
    setting ``exc.transient = True`` (the PowerBI writer does this for 5xx
    status codes carried inside an IOError)."""
    marked = getattr(exc, "transient", None)
    if marked is not None:
        return bool(marked)
    if isinstance(exc, urllib.error.HTTPError):  # URLError subclass: check
        return exc.code >= 500 or exc.code == 429  # the code first
    return isinstance(exc, (ConnectionError, TimeoutError,
                            InterruptedError, urllib.error.URLError,
                            http.client.HTTPException, OSError))


class RetryPolicy:
    """Exponential backoff with FULL jitter and a deadline budget.

    Full jitter (delay ~ U(0, min(max_delay, base * mult**attempt))) is the
    AWS-architecture-blog result: under correlated failure a fleet of
    retriers with deterministic backoff re-synchronizes into thundering
    herds; uniform jitter spreads them. ``deadline`` bounds the TOTAL time
    budget across attempts (sleeps are clipped to the remaining budget and
    an attempt never starts past it) — a serving path must fail a request
    while the client is still listening, not 2^n seconds later.

    ``retryable`` is the transient classification: ``None`` uses
    :func:`default_transient`, a tuple of exception types uses isinstance,
    a callable is a predicate. Fatal errors re-raise immediately without
    consuming the budget.

    Use ``run(fn)``: ``fn(attempt)`` is called with the 0-based attempt
    index (call sites that re-read replayable state on retry — the fleet's
    ``getBatch`` — key off it; most ignore it).
    """

    def __init__(self, name: str = "retry", max_attempts: int = 4,
                 base_delay: float = 0.05, multiplier: float = 2.0,
                 max_delay: float = 2.0, deadline: Optional[float] = None,
                 retryable: Union[None, Sequence[type], Callable] = None,
                 seed: Optional[int] = None, sleep: Callable = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.name = name
        self.max_attempts = max_attempts
        self.base_delay = base_delay
        self.multiplier = multiplier
        self.max_delay = max_delay
        self.deadline = deadline
        self._retryable = retryable
        # a private Random instance even when unseeded (Random(None) seeds
        # from OS entropy): jitter draws never contend on — or reseed —
        # the process-global random state other threads may rely on
        self._rng = random.Random(seed)
        self._sleep = sleep

    def is_transient(self, exc: BaseException) -> bool:
        r = self._retryable
        if r is None:
            return default_transient(exc)
        if callable(r) and not isinstance(r, (tuple, list)):
            return bool(r(exc))
        return isinstance(exc, tuple(r))

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay before attempt ``attempt + 1``."""
        cap = min(self.max_delay,
                  self.base_delay * (self.multiplier ** attempt))
        return self._rng.uniform(0.0, cap) if cap > 0 else 0.0

    def run(self, fn: Callable, *, on_retry: Optional[Callable] = None):
        """``fn(attempt)`` until success / fatal error / budget exhausted.
        ``on_retry(attempt, exc)`` fires before each backoff sleep."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                return fn(attempt)
            except Exception as e:
                if not self.is_transient(e):
                    raise
                delay = self.backoff(attempt)
                remaining = (None if self.deadline is None
                             else self.deadline - (time.monotonic() - t0))
                if attempt + 1 >= self.max_attempts or (
                        remaining is not None and remaining <= delay):
                    _m_exhausted.labels(policy=self.name).inc()
                    # instants auto-tag the current distributed trace
                    # context, so a request's trace shows WHICH retries
                    # it owned (telemetry off: one flag check)
                    telemetry.trace.instant("retry/exhausted",
                                            policy=self.name,
                                            attempts=attempt + 1,
                                            error=type(e).__name__)
                    raise
                _m_retries.labels(policy=self.name).inc()
                telemetry.trace.instant("retry", policy=self.name,
                                        attempt=attempt,
                                        error=type(e).__name__)
                if on_retry is not None:
                    on_retry(attempt, e)
                if delay > 0:
                    self._sleep(delay)
                attempt += 1


class BreakerOpen(ConnectionError):
    """Raised by :meth:`CircuitBreaker.call` when the circuit is open.
    Subclasses ConnectionError so the default RetryPolicy classification
    treats a short-circuited call as transient (retry later, elsewhere)."""

    def __init__(self, breaker: str, target: str):
        super().__init__(f"circuit {breaker!r} open for target {target!r}")
        self.breaker = breaker
        self.target = target


_STATE_NUM = {"closed": 0, "half_open": 1, "open": 2}


class _Target:
    __slots__ = ("state", "failures", "opened_at", "probes")

    def __init__(self):
        self.state = "closed"
        self.failures = 0      # consecutive failures while closed
        self.opened_at = 0.0
        self.probes = 0        # in-flight half-open probes


class CircuitBreaker:
    """Per-target closed/open/half-open circuit.

    ``failure_threshold`` CONSECUTIVE failures open the circuit for
    ``reset_timeout`` seconds, during which :meth:`allow` answers False
    (the caller skips the target — one cheap gauge read instead of a
    doomed network round-trip + timeout). After the window one probe
    (``half_open_max``) is let through: success closes the circuit,
    failure re-opens it for another window.

    Targets are independent (the fleet driver keys by worker index), and
    every live breaker is visible to ``GET /healthz`` via
    :meth:`snapshot_all`.
    """

    _instances: "weakref.WeakSet[CircuitBreaker]" = weakref.WeakSet()

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout: float = 1.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self.half_open_max = max(1, half_open_max)
        self._clock = clock
        self._targets: dict[str, _Target] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        CircuitBreaker._instances.add(self)

    def _get(self, target: str) -> _Target:   # requires-lock: _lock
        t = self._targets.get(target)
        if t is None:
            t = self._targets.setdefault(target, _Target())
        return t

    def _set_state(self, target: str, t: _Target, state: str):
        t.state = state
        _m_breaker_state.labels(breaker=self.name,
                                target=target).set(_STATE_NUM[state])

    def allow(self, target: str = "default") -> bool:
        with self._lock:
            t = self._get(target)
            if t.state == "closed":
                return True
            if t.state == "open":
                if self._clock() - t.opened_at < self.reset_timeout:
                    _m_breaker_short.labels(breaker=self.name,
                                            target=target).inc()
                    return False
                self._set_state(target, t, "half_open")
                t.probes = 0
            # half-open: admit up to half_open_max concurrent probes
            if t.probes < self.half_open_max:
                t.probes += 1
                return True
            _m_breaker_short.labels(breaker=self.name, target=target).inc()
            return False

    def record(self, target: str = "default", ok: bool = True):
        # the state transition is decided under the lock; log + tracer
        # emission happens AFTER release — log handlers do stream/file IO
        # and the tracer takes its own lock, and neither may stall every
        # thread contending this breaker (graftlint: lock-blocking-call)
        transition = None
        with self._lock:
            t = self._get(target)
            if ok:
                if t.state != "closed":
                    transition = "close"
                t.failures = 0
                t.probes = 0
                self._set_state(target, t, "closed")
            elif t.state == "half_open" or (
                    t.state == "closed"
                    and t.failures + 1 >= self.failure_threshold):
                t.opened_at = self._clock()
                t.failures = 0
                t.probes = 0
                if t.state != "open":
                    transition = "open"
                    _m_breaker_opens.labels(breaker=self.name,
                                            target=target).inc()
                self._set_state(target, t, "open")
            else:
                t.failures += 1
        if transition == "close":
            telemetry.trace.instant("breaker/close", breaker=self.name,
                                    target=target)
            log.info("breaker %s/%s: probe ok, closing circuit",
                     self.name, target)
        elif transition == "open":
            telemetry.trace.instant("breaker/open", breaker=self.name,
                                    target=target)
            log.warning("breaker %s/%s: opening circuit for %.2fs",
                        self.name, target, self.reset_timeout)

    def call(self, fn: Callable, target: str = "default"):
        """Run ``fn()`` through the circuit: short-circuit with
        :class:`BreakerOpen` when open, record the outcome otherwise."""
        if not self.allow(target):
            raise BreakerOpen(self.name, target)
        try:
            result = fn()
        except Exception:
            self.record(target, ok=False)
            raise
        self.record(target, ok=True)
        return result

    def state(self, target: str = "default") -> str:
        with self._lock:
            return self._get(target).state

    def reset(self, target: Optional[str] = None):
        """Force closed (a supervisor restoring a worker resets its
        circuit so the first poll isn't short-circuited)."""
        with self._lock:
            targets = ([target] if target is not None
                       else list(self._targets))
            for tg in targets:
                t = self._targets.get(tg)
                if t is not None:
                    t.failures = 0
                    t.probes = 0
                    self._set_state(tg, t, "closed")

    def snapshot(self) -> dict:
        with self._lock:
            return {tg: t.state for tg, t in sorted(self._targets.items())}

    @classmethod
    def snapshot_all(cls) -> dict:
        """{breaker_name: {target: state}} for every live breaker in this
        process — the ``GET /healthz`` breaker report."""
        out: dict = {}
        for b in list(cls._instances):
            snap = b.snapshot()
            if snap:
                out.setdefault(b.name, {}).update(snap)
        return out
