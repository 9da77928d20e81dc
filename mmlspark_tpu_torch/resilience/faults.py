"""Deterministic, env-gated fault injection.

Chaos engineering needs faults that are (a) OFF by default with no
measurable overhead, (b) seeded so a failing CI run replays exactly, and
(c) injected at NAMED sites inside the real code paths rather than via
monkeypatching, so the recovery path exercised is the one production runs.

Spec grammar (``MMLSPARK_TPU_FAULTS`` or :func:`configure`)::

    site:kind:rate[:arg[:arg2]] [; site:kind:rate...]

    fleet.poll:error:0.1                 10% of driver poll round-trips raise
    dataplane.put:delay:0.05:0.02        5% of device puts sleep 20ms
    trainer.step:error:1.0:5             every step faults AFTER 5 clean calls
    serving.transform:error:1.0:0:1      fault the first call only (budget 1)

Kinds:

* ``error`` — raise :class:`InjectedFault` (a ConnectionError subclass, so
  the shared RetryPolicy classifies it transient). Optional args:
  ``after`` (skip the first N calls — arms a mid-run kill) and ``budget``
  (max injections — fail-once-then-recover scenarios).
* ``delay`` — sleep ``arg`` seconds (default 10ms): latency injection for
  tail-latency and timeout testing.

Each (site, fault) pair draws from its own ``random.Random`` seeded from
``seed ^ crc32(site)`` (``MMLSPARK_TPU_FAULTS_SEED``, default 0), so sites
are independent and the whole run is reproducible. Injection sites call
:func:`inject` — one function call + module-bool check when disabled.

Registered sites (see docs/reliability.md): ``fleet.poll``,
``fleet.respond``, ``fleet.transform``, ``fleet.spawn``,
``fleet.drain``, ``serving.transform``,
``serving.batch``, ``serving.bundle_load``,
``http.request``, ``http.debug``, ``powerbi.post``, ``dataplane.put``,
``dataplane.allgather``, ``trainer.step``, ``supervisor.probe``,
``supervisor.heartbeat``, ``supervisor.rejoin``, ``elastic.step``,
``elastic.remesh``, ``elastic.evict``, ``autoscale.verdict``,
``distributed.rendezvous``, ``distributed.lease``, ``ckpt.write``,
``ckpt.rename``, ``ckpt.shard``, ``downloader.fetch``,
``codegen.write``, ``federation.scrape``, ``federation.merge``,
``automl.trial``, ``automl.promote``, ``automl.report``.

The PyTorch port's own copy of ``mmlspark_tpu/resilience/faults.py`` (it
imports no jax): the same metric, span and environment-variable names, so a
deployment's settings and dashboards carry over.
"""

from __future__ import annotations

import threading
import time
import zlib
from random import Random
from typing import Optional

from .. import telemetry
from ..core.utils import get_logger

log = get_logger("resilience.faults")

_m_injected = telemetry.registry.counter(
    "mmlspark_faults_injected_total",
    "faults injected by site and kind", labels=("site", "kind"))

KINDS = ("error", "delay")

#: the canonical injection-site registry. graftlint's ``fault-site``
#: consistency rule keeps this tuple in lockstep with the actual
#: ``faults.inject(...)`` call sites across the tree, and
#: :func:`configure` warns when a chaos spec names a site not listed
#: here — a typo'd site would otherwise inject nothing, silently.
SITES = ("fleet.poll", "fleet.respond", "fleet.transform",
         "fleet.spawn", "fleet.drain",
         "serving.transform", "serving.batch", "serving.bundle_load",
         "http.request", "http.debug",
         "powerbi.post", "dataplane.put", "dataplane.allgather",
         "trainer.step", "supervisor.probe", "supervisor.heartbeat",
         "supervisor.rejoin", "elastic.step", "elastic.remesh",
         "elastic.evict", "autoscale.verdict",
         "distributed.rendezvous", "distributed.lease", "ckpt.write",
         "ckpt.rename", "ckpt.shard", "downloader.fetch",
         "codegen.write", "federation.scrape", "federation.merge",
         "automl.trial", "automl.promote", "automl.report")


class InjectedFault(ConnectionError):
    """The error kind's exception. ConnectionError subclass: transient
    under the default RetryPolicy classification, so injected faults
    exercise the same recovery path a real network blip would."""

    def __init__(self, site: str):
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


class _Fault:
    __slots__ = ("site", "kind", "rate", "delay", "after", "budget",
                 "rng", "lock", "calls", "injected")

    def __init__(self, site: str, kind: str, rate: float, args: list,
                 seed: int):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} for site "
                             f"{site!r} (kinds: {KINDS})")
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault rate for {site!r} must be in [0, 1], "
                             f"got {rate}")
        self.site = site
        self.kind = kind
        self.rate = rate
        self.delay = float(args[0]) if kind == "delay" and args else 0.01
        self.after = int(float(args[0])) if kind == "error" and args else 0
        self.budget = (int(float(args[1]))
                       if kind == "error" and len(args) > 1 else None)
        self.rng = Random(seed ^ zlib.crc32(site.encode()))
        self.lock = threading.Lock()
        self.calls = 0
        self.injected = 0


_plans: dict[str, list[_Fault]] = {}
_active = False


def parse(spec: str) -> list[tuple[str, str, float, list]]:
    """Parse the fault-spec grammar; raises ValueError on malformed specs
    (a typo'd chaos config must fail loudly, not silently inject nothing)."""
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 3:
            raise ValueError(
                f"malformed fault spec {part!r}: need site:kind:rate[:arg]")
        site, kind, rate = fields[0].strip(), fields[1].strip(), fields[2]
        out.append((site, kind, float(rate), fields[3:]))
    return out


def configure(spec: str, seed: Optional[int] = None) -> int:
    """Install a fault plan (replacing any previous one); returns the
    number of faults armed. ``seed=None`` reads
    ``MMLSPARK_TPU_FAULTS_SEED`` (default 0)."""
    global _active
    if seed is None:
        from ..core.env import fault_seed
        seed = fault_seed()
    plans: dict[str, list[_Fault]] = {}
    for site, kind, rate, args in parse(spec):
        if site not in SITES:
            # warn, don't raise: tests arm ad-hoc sites, but a typo'd
            # production chaos spec must at least say so in the log
            log.warning("fault spec names unregistered site %r "
                        "(registered: %s)", site, ", ".join(SITES))
        plans.setdefault(site, []).append(_Fault(site, kind, rate, args,
                                                 seed))
    _plans.clear()
    _plans.update(plans)
    _active = bool(_plans)
    n = sum(len(v) for v in _plans.values())
    if n:
        log.warning("fault injection ARMED: %d fault(s) at sites %s "
                    "(seed %d)", n, sorted(_plans), seed)
    return n


def clear():
    """Disarm all faults; :func:`inject` returns to its no-op fast path."""
    global _active
    _plans.clear()
    _active = False


def active() -> bool:
    return _active


def snapshot() -> dict:
    """{site: [{kind, rate, calls, injected}]} — test/bench introspection."""
    return {site: [{"kind": f.kind, "rate": f.rate, "calls": f.calls,
                    "injected": f.injected} for f in fs]
            for site, fs in sorted(_plans.items())}


def inject(site: str):
    """The injection site hook. Disabled (the default): one module-bool
    check and return. Armed: draw from the site's seeded RNG; raise
    :class:`InjectedFault` or sleep per the plan."""
    if not _active:
        return
    faults = _plans.get(site)
    if not faults:
        return
    for f in faults:
        with f.lock:
            f.calls += 1
            if f.kind == "error" and f.calls <= f.after:
                continue
            if f.budget is not None and f.injected >= f.budget:
                continue
            hit = f.rate >= 1.0 or f.rng.random() < f.rate
            if hit:
                f.injected += 1
        if hit:
            _m_injected.labels(site=site, kind=f.kind).inc()
            # fault markers land in the span trace (tagged with the
            # owning request's context when one is active) AND the
            # flight-recorder ring — a chaos-run artifact shows exactly
            # which injections preceded the failure
            telemetry.trace.instant("fault/injected", site=site,
                                    kind=f.kind)
            if f.kind == "delay":
                time.sleep(f.delay)
            else:
                raise InjectedFault(site)


def _init_from_env():
    from ..core.env import fault_spec
    spec = fault_spec()
    if spec:
        configure(spec)


_init_from_env()
