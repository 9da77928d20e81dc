"""Elastic training: heartbeats, death verdicts, re-mesh, resume.

The port of ``mmlspark_tpu/resilience/elastic.py``: the same heartbeat
files (``hb_<host>.json``, the same keys and values, so a directory
written by one package reads the same in the other), metric names, fault
sites and environment variables. A fit that loses a host **re-meshes over
the survivors and resumes from the latest consensus checkpoint**, losing
zero committed steps: the barrier-execution recovery shape of JAMPI
(arxiv 2007.01811), a failed collective stage re-running from its barrier,
here the checkpoint.

Three pieces:

* :class:`HostHeartbeat` — one per host, a background thread writing
  ``hb_<host>.json`` (atomic write-then-rename) into a directory on the
  job's shared storage every ``interval`` seconds, carrying the host's
  latest committed ``(epoch, step)`` and a monotonic ``seq``. A host that
  stops beating *is* the failure signal: a preempted VM cannot be asked.
* :class:`TrainSupervisor` — probes heartbeat freshness (fault site
  ``supervisor.heartbeat``), declares a host dead once its ``seq`` has not
  advanced for the ``grace`` window on the reader's monotonic clock, and
  answers restart-vs-shrink: **shrink** while the survivors satisfy
  ``min_hosts``, **restart** (relaunch against the same checkpointDir)
  below it. A relaunched host's ``joining`` heartbeat earns a **grow**
  verdict (fault site ``supervisor.rejoin``); a host flagged slow by the
  rolling-MAD ``telemetry.slo.StepTimeAnomalyDetector`` for
  ``evict_after`` consecutive passes earns an **evict** verdict.
* :class:`ElasticFitCoordinator` — drives ``learner._fit(df,
  elastic_ctx)`` in a recovery loop. Every optimizer step passes through
  :meth:`ElasticStepContext.check_step` (fault site ``elastic.step``); a
  death verdict on a mesh member raises :class:`HostLossError` out of the
  step loop, a grow or evict verdict with a committed checkpoint behind
  it raises :class:`HostRejoinError` or :class:`HostEvictError`, and the
  coordinator re-meshes (fault sites ``elastic.remesh``,
  ``elastic.evict``) and re-enters the fit, which resumes from the
  ``(epoch, step)`` consensus checkpoint. Boosted fits
  (``models/gbdt/engine.fit_gbdt_elastic``) resume from the per-iteration
  snapshot the engine hands :meth:`ElasticStepContext.save_snapshot`.

One process rehearses a fleet with *simulated* hosts: ``n_hosts > 1``
failure domains over the process's one rank (a rank is a device in the
port). Every attempt runs on that device whatever the membership, with the
same global batch, so a re-meshed fit computes the uninterrupted fit's
steps bit for bit; the attempt journal records the hosts, and ``devices``
as the attempt's rank count. Killing a simulated host's heartbeat
exercises verdict -> re-mesh -> resume as a real preemption would, and
:meth:`ElasticFitCoordinator.relaunch_host` the grow half.

Multi-process fleets (one rank a process, ``torch.distributed``) run the
same heartbeats and verdicts. Without :func:`~..parallel.distributed.
elastic_initialize` the coordinator fails FAST on a lost member
(:class:`HostLossError` or :class:`ElasticFleetLost`, never a hung
collective) so the launcher relaunches at full size against the
checkpointDir. With it, the fleet re-enters the same fit through
``parallel/distributed``'s :class:`RendezvousCoordinator`: a fresh store
and process group for each generation, generation-stamped membership,
barrier re-entry — a ``kill -9``'d process relaunches and joins the
running fit. A failed collective raises at once on gloo (a dead peer's
socket closes); the coordinator then waits out one grace window for the
verdict that names the lost member before it negotiates the next
generation.

Environment: ``MMLSPARK_TPU_ELASTIC_GRACE`` (death-verdict window,
seconds; the ``elasticGraceSeconds`` param overrides),
``MMLSPARK_TPU_ELASTIC_HB`` (heartbeat write interval, default grace/4),
``MMLTPU_REJOIN_TIMEOUT`` (how long a below-quorum fleet waits for
rejoining hosts).
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
from typing import Callable, Optional

from .. import telemetry
from ..core.utils import get_logger
from . import faults
from .policy import default_transient

log = get_logger("resilience.elastic")

_m_host_losses = telemetry.registry.counter(
    "mmlspark_elastic_host_losses_total",
    "hosts declared dead by the train supervisor", labels=("host",))
_m_remeshes = telemetry.registry.counter(
    "mmlspark_elastic_remeshes_total",
    "fit recoveries that rebuilt the mesh over surviving hosts")
_m_attempt_failures = telemetry.registry.counter(
    "mmlspark_elastic_attempt_failures_total",
    "elastic fit attempts that ended in a classified-transient failure "
    "without a host verdict (retried on the same mesh)")
_m_recovery_seconds = telemetry.registry.histogram(
    "mmlspark_elastic_recovery_seconds",
    "host-loss detection -> first optimizer step committed on the "
    "re-meshed (or retried) fit")
_m_hosts_alive = telemetry.registry.gauge(
    "mmlspark_elastic_hosts_alive",
    "hosts currently alive in the elastic training fleet")
_m_steps_replayed = telemetry.registry.counter(
    "mmlspark_elastic_steps_replayed_total",
    "committed-but-unchekpointed steps re-run after a resume (the work a "
    "smaller checkpointEverySteps would have saved)")
_m_stragglers = telemetry.registry.counter(
    "mmlspark_elastic_stragglers_total",
    "hosts flagged anomalously slow by the rolling-MAD step-time "
    "detector (each flag episode counts once)", labels=("host",))
_m_rejoins = telemetry.registry.counter(
    "mmlspark_elastic_rejoins_total",
    "grow verdicts: relaunched hosts whose joining heartbeat stayed "
    "fresh through the rejoin grace window", labels=("host",))
_m_grows = telemetry.registry.counter(
    "mmlspark_elastic_grows_total",
    "fit recoveries that re-meshed the fleet LARGER (joiners admitted "
    "at a checkpoint boundary)")
_m_grow_recovery_seconds = telemetry.registry.histogram(
    "mmlspark_elastic_grow_recovery_seconds",
    "grow re-mesh start -> first optimizer step committed on the grown "
    "mesh (the cost of admitting a rejoined host)")
_m_heartbeat_errors = telemetry.registry.counter(
    "mmlspark_elastic_heartbeat_errors_total",
    "heartbeat writes that exhausted their retry budget (shared-FS "
    "trouble; the beacon thread stays alive and keeps trying)",
    labels=("host",))
_m_evictions = telemetry.registry.counter(
    "mmlspark_elastic_evictions_total",
    "proactive straggler EVICTIONS: hosts dropped from the mesh at a "
    "checkpoint boundary after sustaining straggler verdicts for "
    "evict_after consecutive passes (alive but slow; eligible to "
    "rejoin through the grow path once recovered)", labels=("host",))


class HostLossError(RuntimeError):
    """A mesh-member host was declared dead mid-fit. Deliberately NOT a
    ConnectionError: the per-step retry policy must not absorb it — the
    recovery is a re-mesh + checkpoint resume, not a redispatch."""

    def __init__(self, hosts):
        self.hosts = sorted(hosts)
        super().__init__(f"host(s) {', '.join(self.hosts)} declared dead "
                         f"mid-fit")


class HostEvictError(RuntimeError):
    """A sustained-straggler host earned an EVICT verdict and a
    checkpoint boundary has committed since: the step loop unwinds so
    the coordinator can re-mesh WITHOUT the slow host — the same unwind
    a host loss uses, fired *before* the host fails. The evicted host
    stays alive and rejoins through the joining-heartbeat grow path once
    it recovers. Not a ConnectionError: the per-step retry must not
    absorb it."""

    def __init__(self, hosts):
        self.hosts = sorted(hosts)
        super().__init__(f"host(s) {', '.join(self.hosts)} evicted as "
                         f"sustained stragglers at checkpoint boundary")


class RendezvousPending(RuntimeError):
    """Multi-process fleets: the leader committed a rendezvous proposal
    whose ``unwind_at`` boundary this process has now reached — unwind
    the step loop and join the new generation. Every process raises after
    the SAME committed step, so a grow/evict re-mesh never strands a peer
    mid-collective."""

    def __init__(self, generation: int):
        self.generation = generation
        super().__init__(f"rendezvous generation {generation} pending")


class HostRejoinError(RuntimeError):
    """A relaunched host earned a grow verdict and a checkpoint boundary
    has committed since: the step loop unwinds so the coordinator can
    re-mesh over survivors + joiner — the host-loss unwind pointed the
    other way (the fleet gets bigger). Not a ConnectionError: the
    per-step retry must not absorb it."""

    def __init__(self, hosts):
        self.hosts = sorted(hosts)
        super().__init__(f"host(s) {', '.join(self.hosts)} rejoining "
                         f"at checkpoint boundary")


class ElasticFleetLost(RuntimeError):
    """Survivors fell below ``min_hosts`` (or the failure budget ran out):
    in-job recovery is off the table; relaunch the fleet against the same
    checkpointDir to resume."""


def _grace_default() -> float:
    try:
        return float(os.environ.get("MMLSPARK_TPU_ELASTIC_GRACE", "") or 2.0)
    except ValueError:
        return 2.0


def _hb_interval_default(grace: float) -> float:
    try:
        v = os.environ.get("MMLSPARK_TPU_ELASTIC_HB", "")
        return float(v) if v else max(0.05, grace / 4.0)
    except ValueError:
        return max(0.05, grace / 4.0)


def heartbeat_dir(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "heartbeats")


def _collective_error(e: BaseException) -> bool:
    """A failed collective: torch raises ``DistBackendError`` (NCCL) or a
    RuntimeError from gloo's transport when a peer's socket closes."""
    import torch
    backend_error = getattr(torch.distributed, "DistBackendError", None)
    if backend_error is not None and isinstance(e, backend_error):
        return True
    msg = str(e)
    return isinstance(e, RuntimeError) and any(
        s in msg for s in ("gloo", "NCCL", "Connection reset",
                           "Connection closed", "Broken pipe"))


def _host_groups(n_hosts: int) -> dict:
    """host id -> ranks. ``n_hosts > 1`` in a world of one rank makes
    simulated failure domains over that rank (a rank is a device: every
    host's attempt runs on it). A real fleet's failure domain is a process
    (what a preemption or a kill takes): by default one host per rank,
    named by its launch rank as ``mesh.stable_host_id`` names it;
    ``n_hosts > 1`` there is the mesh module's contiguous rank chunks."""
    from ..parallel import mesh as meshlib
    world = meshlib.effective_process_count()
    if n_hosts > 1 and world == 1:
        return {f"host{g}": [0] for g in range(n_hosts)}
    if n_hosts <= 1 and world > 1:
        from ..parallel.dataplane import allgather_pyobj
        ids = allgather_pyobj(meshlib.stable_host_id())
        return {h: [r] for r, h in enumerate(ids)}
    return dict(meshlib.host_device_groups(n_hosts))


# ---- fleet-health surface (GET /healthz) -----------------------------------
# The active coordinator registers here and every /healthz payload embeds
# the snapshot, so an operator sees fleet state without scraping metrics.

_fleet_lock = threading.Lock()
_fleet = None                        # guarded-by: _fleet_lock


def _register_fleet(coord):
    global _fleet
    with _fleet_lock:
        _fleet = coord


def _unregister_fleet(coord):
    global _fleet
    with _fleet_lock:
        if _fleet is coord:
            _fleet = None


def fleet_health():
    """The active elastic fleet's state for ``GET /healthz`` (None when
    no elastic fit is running in this process): hosts alive/dead, the
    straggler set, pending evict/grow verdicts, and the current
    rendezvous generation."""
    with _fleet_lock:
        coord = _fleet
    if coord is None:
        return None
    sup = coord.supervisor
    alive = sup.alive_hosts()
    return {
        "hosts_alive": len(alive),
        "alive": alive,
        "dead": sorted(sup.dead_hosts()),
        "stragglers": sorted(sup.straggler_hosts()),
        "pending_evict": sorted(sup.evict_verdicts()),
        "pending_grow": sorted(sup.joining_hosts()),
        "mesh_hosts": sorted(coord._mesh_hosts),
        "rendezvous_generation": (coord._rdzv.generation
                                  if coord._rdzv is not None else 0),
    }


class HostHeartbeat:
    """Background liveness beacon for one host.

    Writes ``hb_<host>.json`` with ``{host, seq, time, epoch, step}`` (and
    ``generation``, ``joining`` when set) every ``interval`` seconds
    (write-then-rename: a torn read must never look like a dead host).
    ``seq`` is a per-beacon monotonic counter — the freshness signal
    readers trust: a verdict compares *reader-observed seq advancement*
    against the reader's own monotonic clock, so a host with a skewed
    wall clock can neither be falsely declared dead nor kept alive as a
    ghost. ``time`` stays informational (and feeds the straggler
    detector's same-writer deltas). ``beat(epoch, step)`` advances the
    carried progress; :meth:`kill` stops the thread WITHOUT a farewell
    write (the simulated preemption); :meth:`throttle` makes the carried
    progress advance only every k-th beat (the simulated straggler)."""

    def __init__(self, host_id: str, directory: str, interval: float,
                 joining: bool = False):
        from .policy import RetryPolicy
        self.host_id = host_id
        self.directory = directory
        self.interval = interval
        self._lock = threading.Lock()
        self._pos = (0, -1)          # guarded-by: _lock
        self._joining = joining      # guarded-by: _lock
        self._seq = 0                # guarded-by: _lock
        self._generation = 0         # guarded-by: _lock
        self._throttle = 1           # guarded-by: _lock
        self._beats = 0              # guarded-by: _lock
        self._stop = threading.Event()
        # a transient shared-FS hiccup must not silence the beacon (a
        # silent beacon IS a death verdict): each write is retried, and
        # exhaustion is counted and survived
        self._retry = RetryPolicy(name="elastic.heartbeat", max_attempts=3,
                                  base_delay=min(0.05, interval / 4),
                                  max_delay=max(0.05, interval / 2),
                                  retryable=lambda e: isinstance(
                                      e, (OSError, ValueError)))
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"heartbeat-{host_id}")

    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"hb_{self.host_id}.json")

    def beat(self, epoch: int, step: int):
        with self._lock:
            self._beats += 1
            if self._throttle <= 1:
                self._pos = (epoch, step)
            elif self._beats % self._throttle == 0:
                # simulated straggler: the carried position advances ONE
                # step per k real beats, so heartbeat-derived
                # seconds-per-step reads k times the fleet cadence
                pe, ps = self._pos
                self._pos = (epoch, ps + 1 if epoch == pe else 0)

    def throttle(self, every: int):
        """Simulated straggler: carried progress advances only every
        ``every``-th :meth:`beat` (1 = healthy). The beacon keeps beating
        — a straggler is alive — but its seconds-per-step, as derived
        from heartbeat progress, multiplies by ``every``."""
        with self._lock:
            self._throttle = max(1, int(every))

    def set_joining(self, joining: bool):
        """Flip the rejoin flag and publish it at once (best effort): a
        stale ``joining`` doc lingering one interval after admission
        would read as a relaunch self-report and re-kill the member."""
        with self._lock:
            self._joining = joining
        try:
            self._write()
        except OSError:
            pass    # the beacon thread retries within one interval

    def set_generation(self, generation: int):
        """Stamp the rendezvous generation this host belongs to into its
        heartbeat (multi-process fleets)."""
        with self._lock:
            self._generation = int(generation)

    def _write(self):
        with self._lock:
            self._seq += 1
            (epoch, step), joining = self._pos, self._joining
            seq, generation = self._seq, self._generation
        doc = {"host": self.host_id, "seq": seq, "time": time.time(),
               "epoch": epoch, "step": step}
        if generation:
            doc["generation"] = generation
        if joining:
            doc["joining"] = True
        # a tmp file per writer thread (set_joining publishes from the
        # caller's thread while the beacon keeps beating). No fsync before
        # the rename on purpose: a heartbeat needs READ atomicity, not
        # crash durability — a host that crashes SHOULD look dead
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    def _run(self):
        while not self._stop.is_set():
            try:
                self._retry.run(lambda _a: self._write())
            except Exception as e:   # exhausted: count, survive, retry
                _m_heartbeat_errors.labels(host=self.host_id).inc()
                log.warning("heartbeat %s write failed after retries: %s",
                            self.host_id, e)
            self._stop.wait(self.interval)

    def start(self) -> "HostHeartbeat":
        os.makedirs(self.directory, exist_ok=True)
        self._write()
        self._thread.start()
        return self

    def stop(self):
        """Clean shutdown (fit finished): stop and join the thread."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2)

    def kill(self):
        """Simulated preemption: the beacon stops mid-air, no final write.
        The supervisor's grace window turns the silence into a verdict."""
        self._stop.set()


class TrainSupervisor:
    """Death-verdict loop over an elastic training fleet's heartbeats.

    ``probe(host_id) -> age_seconds | None`` is pluggable (tests inject
    ages); the default reads the heartbeat file and measures how long its
    ``seq`` has not advanced. A host whose heartbeat is older than
    ``grace`` — or missing past the same window — is declared dead exactly
    once; verdicts are sticky (a zombie heartbeat resuming after its
    verdict stays dead: rejoining means relaunching, with a ``joining``
    heartbeat the grow pass turns into a verdict).
    """

    def __init__(self, host_ids, directory: str,
                 grace: Optional[float] = None,
                 min_hosts: int = 1,
                 probe: Optional[Callable] = None,
                 probe_interval: Optional[float] = None,
                 anomaly_detector=None,
                 rejoin_grace: Optional[float] = None,
                 evict_after: int = 0,
                 self_host: Optional[str] = None):
        from ..telemetry.slo import StepTimeAnomalyDetector
        self.host_ids = list(host_ids)
        self.directory = directory
        #: this process's own host id on a real fleet (None in the
        #: one-process simulation, where every host is "us"): a running
        #: process is self-evidently alive, so the death pass skips it
        self.self_host = self_host
        self.grace = grace if grace is not None else _grace_default()
        self.min_hosts = max(1, min_hosts)
        #: consecutive straggler-flagged passes that promote the advisory
        #: verdict into an EVICT verdict (0 = advisory only, never evict)
        self.evict_after = max(0, int(evict_after))
        #: how long a relaunched host's ``joining`` heartbeat must stay
        #: fresh before the GROW verdict lands (default: the death grace)
        self.rejoin_grace = (rejoin_grace if rejoin_grace is not None
                             else self.grace)
        self._probe = probe or self._probe_file
        self.probe_interval = (probe_interval if probe_interval is not None
                               else max(0.05, self.grace / 4.0))
        #: rolling-MAD step-time detector fed from heartbeat progress; a
        #: STRAGGLER verdict is advisory unless evict_after promotes it
        #: (anomaly_detector=False disables it)
        self.anomaly = (StepTimeAnomalyDetector()
                        if anomaly_detector is None
                        else (anomaly_detector or None))
        self._lock = threading.Lock()
        self._dead: set[str] = set()        # guarded-by: _lock
        self._joining: dict[str, float] = {}     # guarded-by: _lock
        self._join_seen: dict[str, float] = {}   # guarded-by: _lock
        self._progress: dict[str, tuple] = {}    # guarded-by: _lock
        self._flagged: set[str] = set()     # guarded-by: _lock
        # reader-observed freshness: host -> (last seq, monotonic instant
        # the reader first saw it); writer wall-clock skew cannot fake
        # either verdict direction
        self._fresh: dict[str, tuple] = {}       # guarded-by: _lock
        self._join_fresh: dict[str, tuple] = {}  # guarded-by: _lock
        self._streak: dict[str, int] = {}        # guarded-by: _lock
        self._evict: dict[str, float] = {}       # guarded-by: _lock
        self._started_at = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="train-supervisor")
        _m_hosts_alive.set(len(self.host_ids))

    # ---- probing ----
    def _read_doc(self, host_id: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.directory,
                                   f"hb_{host_id}.json"),
                      "r", encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _doc_age(self, host_id: str, doc: dict,
                 table: dict) -> Optional[float]:
        """Seconds since the doc's ``seq`` last ADVANCED on the reader's
        monotonic clock (``table`` is the per-verdict-kind observation
        map). A doc without ``seq`` falls back to the writer's wall time."""
        seq = doc.get("seq")
        if not isinstance(seq, int):
            try:
                return max(0.0, time.time() - float(doc["time"]))
            except (KeyError, TypeError, ValueError):
                return None
        now = time.monotonic()
        with self._lock:
            prev = table.get(host_id)
            if prev is None or prev[0] != seq:
                table[host_id] = (seq, now)
                return 0.0
            return now - prev[1]

    def _probe_file(self, host_id: str) -> Optional[float]:
        """Heartbeat age in seconds; None when the file is missing or
        unreadable (counted against the host once the startup grace is
        spent)."""
        doc = self._read_doc(host_id)
        if doc is None:
            return None
        age = self._doc_age(host_id, doc, self._fresh)
        if age is None:
            return None
        # an in-mesh host writing a JOINING heartbeat is a fresh process
        # self-reporting a restart: its old membership is gone, so the
        # beating file still produces a death verdict; the grow path then
        # readmits the new incarnation
        if doc.get("joining"):
            return float("inf")
        self._note_progress(host_id, doc)
        return age

    def _note_progress(self, host_id: str, doc: dict):
        """Feed the anomaly detector from heartbeat progress: successive
        probes of the same epoch yield (wall delta / steps advanced)."""
        if self.anomaly is None:
            return
        try:
            cur = (int(doc["epoch"]), int(doc["step"]), float(doc["time"]))
        except (KeyError, TypeError, ValueError):
            return
        with self._lock:
            prev = self._progress.get(host_id)
            self._progress[host_id] = cur
        if prev is None:
            return
        pe, ps, pt = prev
        e, s, t = cur
        if e == pe and s > ps and t > pt:
            self.anomaly.observe(host_id, (t - pt) / (s - ps))

    def tick(self):
        """One verdict pass (public: deterministic tests drive it; the
        background thread calls it every ``probe_interval``)."""
        verdicts = []
        for host_id in self.host_ids:
            if host_id == self.self_host:
                continue
            with self._lock:
                if host_id in self._dead:
                    continue
            faults.inject("supervisor.heartbeat")
            age = self._probe(host_id)
            if age is None:
                # missing file: fatal only once the fleet has had time to
                # write its first beats
                if time.monotonic() - self._started_at < self.grace:
                    continue
                verdicts.append((host_id, None))
            elif age > self.grace:
                verdicts.append((host_id, age))
        for host_id, age in verdicts:
            with self._lock:
                if host_id in self._dead:
                    continue
                self._dead.add(host_id)
                alive = len(self.host_ids) - len(self._dead)
            _m_host_losses.labels(host=host_id).inc()
            _m_hosts_alive.set(alive)
            telemetry.trace.instant("elastic/host_loss", host=host_id,
                                    age=age)
            telemetry.flight.note("elastic/host_loss", host=host_id,
                                  age=age, alive=alive)
            log.warning(
                "host %s declared DEAD (heartbeat %s, grace %.2fs); "
                "%d host(s) remain", host_id,
                "missing" if age is None else f"{age:.2f}s old",
                self.grace, alive)
        self._grow_pass()
        self._straggler_pass()

    def _grow_pass(self):
        """GROW verdicts, the death pass's mirror: a dead host whose
        heartbeat beats again WITH the ``joining`` flag, fresh through
        ``rejoin_grace``, earns a verdict the coordinator admits at the
        next checkpoint boundary (a flagless resurrection stays dead)."""
        with self._lock:
            candidates = [h for h in self._dead if h not in self._joining]
        verdicts = []
        for host_id in candidates:
            faults.inject("supervisor.rejoin")
            doc = self._read_doc(host_id)
            age = (self._doc_age(host_id, doc, self._join_fresh)
                   if doc is not None and doc.get("joining") else None)
            fresh = age is not None and age <= self.grace
            now = time.monotonic()
            with self._lock:
                if not fresh:
                    # stale or flagless: the relaunch flapped (or was a
                    # zombie); restart its window
                    self._join_seen.pop(host_id, None)
                    continue
                t0 = self._join_seen.setdefault(host_id, now)
                if now - t0 < self.rejoin_grace:
                    continue
                self._join_seen.pop(host_id, None)
                self._joining[host_id] = now
            verdicts.append(host_id)
        for host_id in verdicts:
            _m_rejoins.labels(host=host_id).inc()
            telemetry.trace.instant("elastic/rejoin", host=host_id)
            telemetry.flight.note("elastic/rejoin", host=host_id)
            log.warning("host %s earned a GROW verdict (joining heartbeat "
                        "fresh through the %.2fs rejoin window); eligible "
                        "to re-enter the mesh at the next checkpoint "
                        "boundary", host_id, self.rejoin_grace)

    def joining_hosts(self) -> dict:
        """Hosts holding a grow verdict -> verdict time (monotonic)."""
        with self._lock:
            return dict(self._joining)

    def admit(self, host_id: str):
        """The coordinator admitted a rejoined host: clear its death
        verdict and grow state so the death pass watches it again, from a
        fresh grace window."""
        with self._lock:
            self._dead.discard(host_id)
            self._joining.pop(host_id, None)
            self._join_seen.pop(host_id, None)
            self._join_fresh.pop(host_id, None)
            self._evict.pop(host_id, None)
            self._streak.pop(host_id, None)
            self._fresh.pop(host_id, None)
            alive = len(self.host_ids) - len(self._dead)
        _m_hosts_alive.set(alive)

    def _straggler_pass(self):
        """Flag the hosts the rolling-MAD detector calls stragglers (and
        unflag recovered ones). With ``evict_after`` > 0 a host flagged
        for that many CONSECUTIVE passes earns an EVICT verdict, subject
        to the floors: the survivors must still satisfy ``min_hosts``, and
        the coordinator host (lowest alive) is never evicted. Bookkeeping
        under the lock; metrics, instants and logs after release."""
        if self.anomaly is None:
            return
        current = self.anomaly.stragglers()
        evict_verdicts = []
        with self._lock:
            current -= self._dead
            newly = current - self._flagged
            self._flagged = current
            alive = [h for h in self.host_ids if h not in self._dead]
            now = time.monotonic()
            for h in list(self._streak):
                if h not in current:
                    self._streak.pop(h)
            for h in sorted(current):
                self._streak[h] = self._streak.get(h, 0) + 1
                if (self.evict_after > 0 and h not in self._evict
                        and self._streak[h] >= self.evict_after
                        and alive and h != min(alive)
                        and len(alive) - len(self._evict) - 1
                        >= self.min_hosts):
                    self._evict[h] = now
                    evict_verdicts.append(h)
        med = (self.anomaly.host_medians()
               if (newly or evict_verdicts) else {})
        for host_id in sorted(newly):
            _m_stragglers.labels(host=host_id).inc()
            telemetry.trace.instant("elastic/straggler", host=host_id,
                                    median_s=med.get(host_id))
            telemetry.flight.note("elastic/straggler", host=host_id,
                                  median_s=med.get(host_id))
            log.warning("host %s flagged as STRAGGLER (median step "
                        "%.4fs vs fleet %s); still alive — advisory only",
                        host_id, med.get(host_id, float("nan")),
                        {h: round(v, 4) for h, v in med.items()})
        for host_id in evict_verdicts:
            telemetry.trace.instant("elastic/evict", host=host_id,
                                    stage="verdict",
                                    median_s=med.get(host_id))
            telemetry.flight.note("elastic/evict", host=host_id,
                                  stage="verdict")
            log.warning(
                "host %s earned an EVICT verdict (straggler for %d "
                "consecutive passes, median step %.4fs); dropped at the "
                "next committed checkpoint boundary", host_id,
                self.evict_after, med.get(host_id, float("nan")))

    def evict_verdicts(self) -> dict:
        """Hosts holding an evict verdict -> verdict time (monotonic)."""
        with self._lock:
            return dict(self._evict)

    def mark_evicted(self, host_id: str):
        """The coordinator dropped an evicted host: record the (sticky)
        death verdict and clear its straggler state, so a held flag cannot
        block the rejoin it is entitled to once recovered."""
        with self._lock:
            self._dead.add(host_id)
            self._evict.pop(host_id, None)
            self._streak.pop(host_id, None)
            self._flagged.discard(host_id)
            alive = len(self.host_ids) - len(self._dead)
        if self.anomaly is not None:
            self.anomaly.forget(host_id)
        _m_evictions.labels(host=host_id).inc()
        _m_hosts_alive.set(alive)

    def straggler_hosts(self) -> set[str]:
        """Hosts currently flagged anomalously slow (advisory)."""
        with self._lock:
            return set(self._flagged)

    def dead_hosts(self) -> set[str]:
        with self._lock:
            return set(self._dead)

    def alive_hosts(self) -> list[str]:
        with self._lock:
            return [h for h in self.host_ids if h not in self._dead]

    def decision(self) -> str:
        """``"shrink"`` when the survivors can keep training in-job,
        ``"restart"`` when they cannot (relaunch against the same
        checkpointDir — consensus resume carries the run over)."""
        return ("shrink" if len(self.alive_hosts()) >= self.min_hosts
                else "restart")

    def _run(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:   # a probe bug must not kill the loop
                log.warning("train-supervisor tick failed: %s", e)
            self._stop.wait(self.probe_interval)

    def clear_stale_heartbeats(self):
        """Remove ``hb_*.json`` ghosts of a PREVIOUS run (not modified
        within the grace window, judged by the file's mtime — the
        filesystem's clock, not the dead writer's), so a supervisor on a
        reused checkpointDir does not read last week's heartbeat as an
        instant death. This run's fresh files are untouched."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in names:
            if not (name.startswith("hb_") and name.endswith(".json")):
                continue
            path = os.path.join(self.directory, name)
            try:
                stale = time.time() - os.path.getmtime(path) > self.grace
            except OSError:
                stale = True     # unreadable ghosts go too
            if stale:
                try:
                    os.remove(path)
                    log.info("cleared stale heartbeat %s from a previous "
                             "run", name)
                except OSError:
                    pass

    def start(self) -> "TrainSupervisor":
        self.clear_stale_heartbeats()
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)


class ElasticStepContext:
    """The per-step hook the trainer's step loop (and the boosting loop)
    calls during an elastic fit. Cheap when nothing is wrong: one
    fault-site check and one set read per optimizer step."""

    def __init__(self, coordinator: "ElasticFitCoordinator"):
        self._coord = coordinator

    def check_step(self):
        """Runs inside the step dispatch, BEFORE the device work. An
        injected ``elastic.step`` fault is a ConnectionError (the trainer's
        retry-once policy absorbs singles). A death verdict on a mesh
        member raises :class:`HostLossError`; a grow verdict with a
        checkpoint boundary committed behind it raises
        :class:`HostRejoinError`; a sustained-straggler evict verdict with
        a boundary behind it raises :class:`HostEvictError` (all
        non-transient: they skip the retry and unwind to the re-mesh)."""
        faults.inject("elastic.step")
        dead = self._coord.dead_mesh_hosts()
        if dead:
            raise HostLossError(dead)
        if self._coord._multiproc:
            # grow/evict in a real fleet must unwind every process at the
            # same step: they go through the leader's rendezvous proposal
            # (check_rendezvous); only a dead member unwinds alone
            return
        grow = self._coord.pending_grow()
        if grow:
            raise HostRejoinError(grow)
        evict = self._coord.pending_evict()
        if evict:
            raise HostEvictError(evict)

    def step_committed(self, epoch: int, step: int):
        """Each completed optimizer step: advances this process's
        heartbeat progress, closes a pending recovery-time measurement,
        and feeds the committed-step journal. Multi-process fleets also
        poll the rendezvous doc here — the deterministic unwind point."""
        self._coord.note_step(epoch, step)
        self._coord.check_rendezvous(epoch, step)

    def checkpoint_saved(self, epoch: int, step: Optional[int]):
        """A checkpoint COMMITTED (rename + manifest durable; on the async
        path from the writer thread after the commit). Checkpoint
        boundaries are where grow and evict re-meshes become eligible."""
        self._coord.note_checkpoint(epoch, step)

    def resumed(self, pos, params_digest: Optional[str]):
        """The trainer reports the checkpoint position (None for a fresh
        start) and a digest of the restored params: the bit-exact resume
        evidence."""
        self._coord.note_resume(pos, params_digest)

    # ---- in-memory boosting-state candidates (elastic GBDT fits) ----
    def save_snapshot(self, state):
        """The GBDT engine's per-iteration boosting-state candidate
        (newest wins) a re-meshed attempt resumes from. Paired with
        :meth:`checkpoint_saved`, so grow boundaries work for boosted fits
        too."""
        self._coord.snapshot = state

    def latest_snapshot(self):
        return self._coord.snapshot


class ElasticFitCoordinator:
    """Drives a ``TorchLearner`` fit (or any ``attempt_fn``) through host
    loss.

    ``fit(df)``: build the host groups, start heartbeats and the
    supervisor, then loop ``learner._fit(df, elastic_ctx=ctx)`` until it
    returns a model. A :class:`HostLossError`
    (or an exhausted-transient failure that a fresh verdict pass
    attributes to a dead host) re-meshes: the survivors form the next
    pool, and the next attempt resumes from the latest consensus
    checkpoint. Failures with *no* dead host burn the ``max_failures``
    budget and retry on the same mesh.
    """

    def __init__(self, learner=None, n_hosts: int = 0,
                 min_hosts: int = 1,
                 grace: Optional[float] = None,
                 max_failures: int = 5,
                 heartbeat_interval: Optional[float] = None,
                 max_hosts: int = 0,
                 rejoin_grace: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 evict_after: int = 0):
        ckdir = checkpoint_dir or (learner.getCheckpointDir()
                                   if learner is not None else "")
        if not ckdir:
            raise ValueError(
                "elastic fit requires checkpointDir: recovery is a resume "
                "from the consensus checkpoint — without one a host loss "
                "restarts from scratch, losing every committed step")
        self.learner = learner
        self.checkpoint_dir = ckdir
        self.grace = grace if grace is not None else _grace_default()
        self.min_hosts = max(1, min_hosts)
        self.max_failures = max(1, max_failures)
        self._hb_interval = (heartbeat_interval
                             if heartbeat_interval is not None
                             else _hb_interval_default(self.grace))
        from ..parallel import distributed as dist
        self._rdzv = dist.rendezvous_coordinator()
        if self._rdzv is not None:
            # rendezvous-armed fleet: membership is the LAUNCH fleet
            # (stable host ids = launch ranks), whatever the current
            # generation's size, so a dropped host's rejoin can be seen
            n_env = int(os.environ.get(dist.ENV_NUM_PROCESSES, "0") or 0)
            hosts = sorted(set(self._rdzv.ranks)
                           | {f"host{i}" for i in range(n_env)}
                           | {self._rdzv.host_id})
            self.groups = {h: [] for h in hosts}
        else:
            self.groups = _host_groups(n_hosts)
        #: grow ceiling: the mesh never grows past this many hosts
        #: (0 = the launch fleet size)
        self.max_hosts = max_hosts or len(self.groups)
        self.hb_dir = heartbeat_dir(ckdir)
        self.heartbeats = {h: HostHeartbeat(h, self.hb_dir,
                                            self._hb_interval)
                           for h in self.groups}
        self.supervisor = TrainSupervisor(
            list(self.groups), self.hb_dir, grace=self.grace,
            min_hosts=self.min_hosts, rejoin_grace=rejoin_grace,
            evict_after=evict_after,
            self_host=(self._rdzv.host_id if self._rdzv is not None
                       else None))
        self.attempts: list[dict] = []   # per-attempt journal
        self.committed: list[tuple] = []   # (epoch, step) journal
        self.snapshot = None   # GBDT boosting-state candidate (newest wins)
        self._mesh_hosts: set[str] = set()
        self._multiproc = False
        self._pending_recovery_t0: Optional[float] = None
        self._recovery_kind = "loss"
        self._last_ckpt_pos: Optional[tuple] = None
        self._last_ckpt_t: Optional[float] = None
        self._rdzv_cache: tuple = (0.0, 0.0, None)  # (checked, mtime, doc)

    # ---- state read by the step hook (fit thread) ----
    def dead_mesh_hosts(self) -> set[str]:
        return self.supervisor.dead_hosts() & self._mesh_hosts

    def pending_grow(self) -> set[str]:
        """Joiners eligible to enter at THIS step: a grow verdict, a
        checkpoint boundary committed since it (the re-entry replays ~zero
        steps), and room under ``max_hosts``."""
        join = self.supervisor.joining_hosts()
        if not join:
            return set()
        room = self.max_hosts - len(self._mesh_hosts)
        if room <= 0:
            return set()
        ckpt_t = self._last_ckpt_t
        eligible = sorted(h for h, t in join.items()
                          if h not in self._mesh_hosts
                          and ckpt_t is not None and ckpt_t >= t)
        return set(eligible[:room])

    def pending_evict(self) -> set[str]:
        """Evict verdicts eligible to fire at THIS step: a checkpoint
        boundary committed since the verdict, and the mesh stays at or
        above ``min_hosts`` without them."""
        ev = self.supervisor.evict_verdicts()
        if not ev:
            return set()
        ckpt_t = self._last_ckpt_t
        if ckpt_t is None:
            return set()
        eligible = sorted(h for h, t in ev.items()
                          if h in self._mesh_hosts and ckpt_t >= t)
        room = len(self._mesh_hosts) - self.min_hosts
        return set(eligible[:max(0, room)])

    # ---- multi-process rendezvous polling (step hook, fit thread) ----
    def _read_rdzv_doc(self) -> Optional[dict]:
        """The current rendezvous doc, mtime-cached and stat-throttled:
        one os.stat per 50 ms at most, one re-read per actual change."""
        rdzv = self._rdzv
        if rdzv is None:
            return None
        checked, mtime, doc = self._rdzv_cache
        now = time.monotonic()
        if now - checked < 0.05:
            return doc
        try:
            cur = os.path.getmtime(rdzv.path)
        except OSError:
            self._rdzv_cache = (now, 0.0, None)
            return None
        if cur != mtime:
            doc = rdzv.read()
        self._rdzv_cache = (now, cur, doc)
        return doc

    def _is_leader(self) -> bool:
        """Lease-aware: the fresh leaseholder leads; an expired or absent
        lease falls back to the lowest-rank mesh host."""
        return bool(self._mesh_hosts) and self._rdzv.host_id \
            == self._rdzv.elect_leader(self._mesh_hosts)

    def check_rendezvous(self, epoch: int, step: int):
        """Multi-process fleets only (one-process fits no-op): the LEADER
        promotes boundary-armed grow/evict verdicts into a rendezvous
        proposal whose ``unwind_at`` names a step a checkpoint interval
        ahead; EVERY process polls the doc each committed step and raises
        :class:`RendezvousPending` once it commits that step."""
        if not self._multiproc or self._rdzv is None:
            return
        rdzv = self._rdzv
        doc = self._read_rdzv_doc()
        if (doc is None or doc["generation"] <= rdzv.generation) \
                and self._is_leader():
            # hold leadership while the fit runs
            rdzv.lease.maybe_renew()
            grow = self.pending_grow()
            evict = self.pending_evict()
            if grow or evict:
                members = sorted((self._mesh_hosts - evict) | grow)
                margin = 1
                if self.learner is not None:
                    margin = max(
                        1, self.learner.getCheckpointEverySteps() or 1)
                doc = rdzv.propose(members,
                                   unwind_at=(epoch, step + margin))
                self._rdzv_cache = (0.0, 0.0, None)
        if doc is not None and doc["generation"] > rdzv.generation:
            ua = doc.get("unwind_at")
            if ua is None or (epoch, step) >= (int(ua[0]), int(ua[1])):
                raise RendezvousPending(doc["generation"])

    def note_step(self, epoch: int, step: int):
        self.committed.append((epoch, step))
        for h in self._mesh_hosts:
            hb = self.heartbeats.get(h)
            # only beacons whose thread runs in THIS process (all of them
            # in one process; just our own on a real fleet)
            if hb is not None and hb._thread.is_alive():
                hb.beat(epoch, step)
        if self._pending_recovery_t0 is not None:
            dt = time.monotonic() - self._pending_recovery_t0
            self._pending_recovery_t0 = None
            if self._recovery_kind == "grow":
                _m_grow_recovery_seconds.observe(dt)
                self.attempts[-1]["grow_recovery_s"] = dt
                log.info("elastic grow complete: first step committed "
                         "%.2fs after the grow re-mesh began", dt)
            elif self._recovery_kind == "evict":
                _m_recovery_seconds.observe(dt)
                self.attempts[-1]["evict_recovery_s"] = dt
                log.info("elastic evict complete: first step committed "
                         "%.2fs after the straggler was dropped", dt)
            else:
                _m_recovery_seconds.observe(dt)
                self.attempts[-1]["recovery_s"] = dt
                log.info("elastic recovery complete: first step committed "
                         "%.2fs after the failure", dt)

    def note_checkpoint(self, epoch: int, step: Optional[int]):
        """A checkpoint committed durably: verdicts older than this
        instant become admissible."""
        self._last_ckpt_pos = (epoch, step)
        self._last_ckpt_t = time.monotonic()

    def note_resume(self, pos, params_digest):
        self._last_ckpt_pos = pos
        self.attempts[-1]["resume_pos"] = pos
        self.attempts[-1]["resume_digest"] = params_digest
        if pos is not None and self.committed:
            # steps the previous attempt committed past the checkpoint are
            # about to be re-run: the measurable cost of the interval (an
            # epoch checkpoint covers every step of its epoch)
            e, s = pos
            after = (e, float("inf") if s is None else s)
            replay = sum(1 for c in self.committed if c > after)
            if replay:
                _m_steps_replayed.inc(replay)
            self.attempts[-1]["replayed"] = replay

    # ---- the recovery loop ----
    def _pool(self) -> list:
        """The surviving hosts' ranks (every simulated host shares the one
        rank of a one-process fleet)."""
        self._mesh_hosts = set(self.supervisor.alive_hosts())
        return sorted({r for h in self._mesh_hosts for r in self.groups[h]})

    def fit(self, df):
        """Drive ``learner.fit``'s core through the recovery loop."""
        return self.run(lambda _devices, ctx: self.learner._fit(
            df, elastic_ctx=ctx))

    def fit_stream(self, batches_fn):
        """Drive ``learner.fitStream``'s core through the recovery loop: a
        host loss re-meshes and re-enters the stream (the epoch restarts —
        a generator cannot seek — with the checkpointed optimizer state)."""
        return self.run(lambda _devices, ctx: self.learner._fit_stream(
            batches_fn, elastic_ctx=ctx))

    def relaunch_host(self, host_id: str) -> HostHeartbeat:
        """Simulated RELAUNCH of a killed host (one-process failure
        domains): a fresh beacon carrying the ``joining`` flag, exactly the
        heartbeat a relaunched host process writes on boot."""
        if host_id not in self.groups:
            raise ValueError(f"unknown host {host_id!r}")
        old = self.heartbeats.get(host_id)
        if old is not None:
            old.kill()
        hb = HostHeartbeat(host_id, self.hb_dir, self._hb_interval,
                           joining=True)
        self.heartbeats[host_id] = hb
        hb.start()
        return hb

    def run(self, attempt_fn):
        """The recovery loop: ``attempt_fn(devices, ctx)`` until it
        returns. :class:`HostLossError` shrinks the mesh,
        :class:`HostRejoinError` grows it back, :class:`HostEvictError`
        drops a sustained straggler (all re-enter from the consensus
        checkpoint); transient failures without a verdict burn the
        ``max_failures`` budget on the same mesh."""
        from ..parallel import mesh as meshlib
        if meshlib.effective_process_count() > 1 or self._rdzv is not None:
            # a real multi-process fleet: with a RendezvousCoordinator
            # armed the fleet re-enters the SAME fit; without one it fails
            # fast and the launcher relaunches at full size
            return self._run_multiprocess(attempt_fn)
        ctx = ElasticStepContext(self)
        for h in self.heartbeats.values():
            h.start()
        self.supervisor.start()
        _register_fleet(self)
        failures = 0
        try:
            while True:
                if self.attempts:
                    # the failed attempt's state (held by reference cycles
                    # through its traceback) goes before this attempt
                    # allocates its own: a re-entry must not grow memory
                    gc.collect()
                pool = self._pool()
                self.attempts.append({"hosts": sorted(self._mesh_hosts),
                                      "devices": len(pool)})
                try:
                    with telemetry.trace.span("elastic/attempt",
                                              hosts=len(self._mesh_hosts),
                                              devices=len(pool)):
                        return attempt_fn(pool, ctx)
                except HostLossError as e:
                    self._pending_recovery_t0 = time.monotonic()
                    self._recovery_kind = "loss"
                    self._remesh(e.hosts)
                except HostRejoinError as e:
                    self._pending_recovery_t0 = time.monotonic()
                    self._recovery_kind = "grow"
                    self._grow(e.hosts)
                except HostEvictError as e:
                    self._pending_recovery_t0 = time.monotonic()
                    self._recovery_kind = "evict"
                    self._evict(e.hosts)
                except Exception as e:
                    if not default_transient(e):
                        raise
                    # transient exhaustion with no verdict yet: force a
                    # probe pass — the failure may BE the dying host
                    self._pending_recovery_t0 = time.monotonic()
                    self._recovery_kind = "loss"
                    self.supervisor.tick()
                    dead = self.dead_mesh_hosts()
                    if dead:
                        self._remesh(dead, cause=e)
                    else:
                        failures += 1
                        _m_attempt_failures.inc()
                        if failures >= self.max_failures:
                            raise ElasticFleetLost(
                                f"elastic fit failed {failures} times "
                                f"without a host verdict; last error: "
                                f"{e!r}") from e
                        log.warning(
                            "elastic fit attempt failed transiently (%r); "
                            "retrying from the latest checkpoint on the "
                            "same mesh (%d/%d)", e, failures,
                            self.max_failures)
        finally:
            _unregister_fleet(self)
            self.supervisor.stop()
            for h in self.heartbeats.values():
                h.stop()

    def _grow(self, hosts):
        """Admit grow-verdict holders back into the mesh (capped by
        ``max_hosts``): the next attempt's pool is survivors + joiners,
        resumed from the checkpoint boundary that armed the grow."""
        faults.inject("elastic.remesh")
        admitted = []
        for h in sorted(hosts):
            if len(self.supervisor.alive_hosts()) >= self.max_hosts:
                log.warning("host %s holds a grow verdict but the fleet "
                            "is at elasticMaxHosts (%d); leaving it "
                            "parked", h, self.max_hosts)
                break
            self.supervisor.admit(h)
            hb = self.heartbeats.get(h)
            if hb is not None:
                hb.set_joining(False)
            admitted.append(h)
        if not admitted:
            return
        _m_grows.inc()
        telemetry.trace.instant("elastic/grow",
                                joined=",".join(admitted),
                                alive=len(self.supervisor.alive_hosts()))
        telemetry.flight.note("elastic/grow", joined=admitted)
        log.warning(
            "growing the mesh: host(s) %s rejoin at checkpoint %s; "
            "%d host(s) in the pool", admitted, self._last_ckpt_pos,
            len(self.supervisor.alive_hosts()))

    def _evict(self, hosts):
        """Drop sustained-straggler hosts at a committed checkpoint
        boundary. The floors are re-checked here (a death verdict may
        have landed since): survivors must satisfy ``min_hosts`` and the
        coordinator host (lowest alive) is never evicted."""
        faults.inject("elastic.evict")
        victims = []
        for h in sorted(hosts):
            alive = set(self.supervisor.alive_hosts())
            if h not in alive or h not in self._mesh_hosts:
                continue
            if len(alive) - 1 < self.min_hosts:
                log.warning("host %s holds an evict verdict but dropping "
                            "it would leave %d < min_hosts (%d); leaving "
                            "it in the mesh", h, len(alive) - 1,
                            self.min_hosts)
                continue
            if h == min(alive):
                log.warning("host %s holds an evict verdict but is the "
                            "coordinator host; never evicted", h)
                continue
            self.supervisor.mark_evicted(h)
            victims.append(h)
        if not victims:
            return
        _m_remeshes.inc()
        telemetry.trace.instant("elastic/evict",
                                evicted=",".join(victims), stage="remesh",
                                alive=len(self.supervisor.alive_hosts()))
        telemetry.flight.note("elastic/evict", evicted=victims,
                              stage="remesh")
        log.warning(
            "evicting straggler host(s) %s at checkpoint %s: %d host(s) "
            "remain; resuming from the consensus checkpoint — the "
            "evicted host rejoins via the grow path once recovered",
            victims, self._last_ckpt_pos,
            len(self.supervisor.alive_hosts()))

    def _remesh(self, dead_hosts, cause=None):
        faults.inject("elastic.remesh")
        if self.supervisor.decision() == "restart":
            raise ElasticFleetLost(
                f"{len(self.supervisor.alive_hosts())} host(s) alive < "
                f"min_hosts ({self.min_hosts}); relaunch the fleet against "
                f"checkpointDir {self.checkpoint_dir!r} to resume from the "
                f"last committed step")
        _m_remeshes.inc()
        telemetry.trace.instant("elastic/remesh",
                                dead=",".join(sorted(dead_hosts)),
                                alive=len(self.supervisor.alive_hosts()))
        telemetry.flight.note("elastic/remesh", dead=sorted(dead_hosts))
        log.warning(
            "re-meshing after loss of %s: %d host(s) remain; resuming "
            "from the consensus checkpoint%s", sorted(dead_hosts),
            len(self.supervisor.alive_hosts()),
            f" (trigger: {cause!r})" if cause is not None else "")

    def _await_verdict(self) -> set[str]:
        """After a collective failed with no verdict yet: verdict passes
        for up to one grace window (gloo raises the moment a peer's socket
        closes, before its heartbeat goes stale). Returns the dead mesh
        hosts (empty when none was found)."""
        deadline = time.monotonic() + self.grace + 2 * self._hb_interval
        while True:
            self.supervisor.tick()
            dead = self.dead_mesh_hosts()
            doc = self._rdzv.read() if self._rdzv is not None else None
            if dead or (doc is not None
                        and doc["generation"] > self._rdzv.generation) \
                    or time.monotonic() >= deadline:
                return dead
            time.sleep(max(0.02, self.supervisor.probe_interval / 2))

    def _run_multiprocess(self, attempt_fn):
        from ..parallel import mesh as meshlib
        ctx = ElasticStepContext(self)
        if self._rdzv is None:
            # fixed-fleet posture (no elastic_initialize): detection +
            # fail-fast; the launcher relaunches at full size and the
            # consensus resume carries the run over
            host_id = meshlib.stable_host_id()
            hb = self.heartbeats.get(host_id)
            self._mesh_hosts = set(self.groups)
            if hb is not None:
                hb.start()
            self.supervisor.start()
            _register_fleet(self)
            try:
                self.attempts.append({
                    "hosts": sorted(self.groups),
                    "devices": meshlib.effective_process_count()})
                try:
                    return attempt_fn(None, ctx)
                except Exception as e:
                    if isinstance(e, (HostLossError, ElasticFleetLost)) \
                            or not _collective_error(e):
                        raise
                    dead = self._await_verdict()
                    raise ElasticFleetLost(
                        f"a collective failed ({e}); dead host(s): "
                        f"{sorted(dead) or 'no verdict yet'}. Relaunch the "
                        f"fleet at full size against checkpointDir "
                        f"{self.checkpoint_dir!r} to resume from the last "
                        f"committed step") from e
            finally:
                _unregister_fleet(self)
                self.supervisor.stop()
                if hb is not None:
                    hb.stop()
        # ---- rendezvous-armed elastic fleet ----
        self._multiproc = True
        rdzv = self._rdzv
        host_id = rdzv.host_id
        hb = rdzv.heartbeat
        if hb is not None:
            # reuse the PROCESS-LEVEL beacon elastic_initialize started: it
            # must keep proving liveness across re-rendezvous gaps
            hb.interval = min(hb.interval, self._hb_interval)
            self.heartbeats[host_id] = hb
        else:
            hb = self.heartbeats.get(host_id)
            if hb is None:
                hb = self.heartbeats[host_id] = HostHeartbeat(
                    host_id, self.hb_dir, self._hb_interval)
            hb.start()
        hb.set_generation(rdzv.generation)
        self.supervisor.start()
        _register_fleet(self)
        failures = 0
        try:
            while True:
                e = None
                if self.attempts:
                    gc.collect()   # the failed attempt's state goes first
                self._mesh_hosts = set(rdzv.ranks) or {host_id}
                self.attempts.append({
                    "hosts": sorted(self._mesh_hosts),
                    "devices": meshlib.effective_process_count(),
                    "generation": rdzv.generation})
                with telemetry.trace.span("elastic/attempt",
                                          hosts=len(self._mesh_hosts),
                                          generation=rdzv.generation):
                    kind, val = self._attempt_in_thread(attempt_fn, ctx)
                if kind == "ok":
                    return val
                e, val = val, None
                if isinstance(e, RendezvousPending):
                    self._pending_recovery_t0 = time.monotonic()
                    self._recovery_kind = "grow"
                    self._rendezvous_cycle(hb)
                elif isinstance(e, (HostLossError, HostEvictError)):
                    self._pending_recovery_t0 = time.monotonic()
                    self._recovery_kind = "loss"
                    self._rendezvous_cycle(hb, dead=set(e.hosts))
                else:
                    # a failed collective is how a peer death usually
                    # surfaces here: look for a verdict BEFORE deciding
                    # the error is fatal
                    coll_err = _collective_error(e)
                    if coll_err:
                        dead = self._await_verdict()
                    else:
                        self.supervisor.tick()
                        dead = self.dead_mesh_hosts()
                    doc = rdzv.read()
                    if dead or (doc is not None
                                and doc["generation"] > rdzv.generation):
                        self._pending_recovery_t0 = time.monotonic()
                        self._recovery_kind = "loss"
                        self._rendezvous_cycle(hb, dead=dead)
                    elif not default_transient(e) and not coll_err:
                        raise e
                    else:
                        failures += 1
                        _m_attempt_failures.inc()
                        if failures >= self.max_failures:
                            raise ElasticFleetLost(
                                f"elastic fit failed {failures} times "
                                f"without a host verdict; last error: "
                                f"{e!r}") from e
                        if coll_err:
                            # a failed collective with no verdict: the
                            # group's state is out of step (a peer
                            # re-rendezvoused or aborted) — a FRESH
                            # generation (new store, new group) recovers
                            log.warning(
                                "collective failed without a verdict "
                                "(%r); minting a fresh generation "
                                "(%d/%d)", e, failures, self.max_failures)
                            self._pending_recovery_t0 = time.monotonic()
                            self._recovery_kind = "loss"
                            self._rendezvous_cycle(hb)
                        else:
                            log.warning(
                                "elastic fit attempt failed transiently "
                                "(%r); retrying from the latest "
                                "checkpoint (%d/%d)", e, failures,
                                self.max_failures)
        finally:
            _unregister_fleet(self)
            if self.learner is not None:
                self.learner._active_fit_thread = None
            self.supervisor.stop()
            if hb is not rdzv.heartbeat:
                hb.stop()   # the process-level beacon outlives the fit

    def _attempt_in_thread(self, attempt_fn, ctx):
        """Run one fit attempt on a WATCHED worker thread. A collective
        whose peer died may block until the process group's timeout (NCCL
        waits it out), and a thread pinned inside it cannot be cancelled.
        The watchdog sees the (background-thread) heartbeat verdict or a
        newer rendezvous doc, gives the attempt a short grace to unwind
        CLEANLY (check_step raising, or the collective surfacing its
        error), and otherwise FAILS FAST with :class:`ElasticFleetLost`: a
        thread pinned in the dead generation must never be reused in the
        next one, so the clean recovery is a process relaunch, which
        re-enters the SAME rendezvous lineage and consensus-resumes."""
        rdzv = self._rdzv
        result: dict = {}
        done = threading.Event()

        def body():
            try:
                result["value"] = attempt_fn(None, ctx)
            except BaseException as e:   # delivered to the main loop
                result["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=body, daemon=True,
                             name="elastic-attempt")
        if self.learner is not None:
            self.learner._active_fit_thread = t
        t.start()
        poll = min(0.1, max(0.02, self._hb_interval))
        while not done.wait(poll):
            dead = self.dead_mesh_hosts()
            doc = rdzv.read()
            newer = (doc is not None
                     and doc["generation"] > rdzv.generation)
            if not (dead or newer):
                continue
            # verdict landed: the attempt should unwind via check_step
            # within a step or two — unless it is pinned in a collective
            if done.wait(max(1.0, 2 * self.grace)):
                break
            why = (f"dead: {sorted(dead)}" if dead
                   else f"generation {doc['generation']} pending")
            log.warning("fit attempt pinned inside a dead collective "
                        "(%s); failing fast — relaunch this process to "
                        "rejoin the rendezvous lineage", why)
            raise ElasticFleetLost(
                f"fit attempt pinned inside a dead collective ({why}); "
                f"this process fails fast instead of waiting out the "
                f"process group's timeout. Relaunch it against "
                f"checkpointDir {self.checkpoint_dir!r}: it will rejoin "
                f"the rendezvous lineage (generation "
                f"{rdzv.generation} + 1) and resume from the last "
                f"committed step")
        t.join(timeout=5)
        if "error" in result:
            return "error", result["error"]
        return "ok", result.get("value")

    def _rendezvous_cycle(self, hb, dead=frozenset()):
        """One membership change on a real fleet: agree on the next
        generation's members, tear the dead generation down, form a fresh
        store and process group (hosted by the generation's leader), and
        barrier back in. Retries with exponential backoff — a retry after
        a failed join negotiates a newer generation rather than re-joining
        the failed one; exhaustion falls back to relaunch-at-full-size
        (:class:`ElasticFleetLost`)."""
        from ..parallel import distributed as dist
        rdzv = self._rdzv
        host_id = rdzv.host_id
        backoff = 0.2
        last_err = None
        doc = None
        for attempt in range(self.max_failures):
            try:
                doc = rdzv.read()
                if not (last_err is None and doc is not None
                        and doc["generation"] > rdzv.generation
                        and host_id in doc.get("ranks", {})):
                    doc = self._negotiate_generation(hb, dead)
                rdzv.join(doc)
                break
            except (dist.RendezvousError, ConnectionError, OSError) as e:
                last_err = e
                log.warning("re-rendezvous attempt %d/%d failed (%s); "
                            "backing off %.1fs", attempt + 1,
                            self.max_failures, e, backoff)
                time.sleep(backoff)
                backoff = min(5.0, backoff * 2)
        else:
            raise ElasticFleetLost(
                f"re-rendezvous failed {self.max_failures} times (last: "
                f"{last_err!r}); relaunch the fleet at full size against "
                f"checkpointDir {self.checkpoint_dir!r} to resume from "
                f"the last committed step") from last_err
        # joined: reconcile verdict state with the new membership
        grew = len(doc["ranks"]) > len(self._mesh_hosts)
        for h in doc["ranks"]:
            if h in self.supervisor.dead_hosts():
                self.supervisor.admit(h)
        hb.set_joining(False)
        hb.set_generation(rdzv.generation)
        self._mesh_hosts = set(doc["ranks"])
        self._rdzv_cache = (0.0, 0.0, None)
        if grew:
            _m_grows.inc()
        else:
            _m_remeshes.inc()
        telemetry.trace.instant("elastic/remesh" if not grew
                                else "elastic/grow",
                                generation=rdzv.generation,
                                alive=len(self._mesh_hosts))
        log.warning("re-rendezvoused into generation %d with %d host(s) "
                    "%s", rdzv.generation, len(doc["ranks"]),
                    sorted(doc["ranks"]))

    def _negotiate_generation(self, hb, dead):
        """Decide the next generation's membership and either propose it
        (leader) or await it (everyone else). Below ``min_hosts`` the
        fleet WAITS for joining heartbeats to restore quorum, so a killed
        process that relaunches re-enters the same fit. The leader is
        elected among the running survivors: a parked joiner (the
        relaunched lowest-rank host, say) cannot propose."""
        from ..parallel import distributed as dist
        rdzv = self._rdzv
        host_id = rdzv.host_id
        deadline = time.monotonic() + float(os.environ.get(
            dist.ENV_REJOIN_TIMEOUT, dist.DEFAULT_REJOIN_TIMEOUT))
        while True:
            self.supervisor.tick()
            alive = set(self.supervisor.alive_hosts()) - set(dead)
            joiners = set(self.supervisor.joining_hosts())
            # a dead-verdict host whose heartbeat is FRESH and stamped with
            # the current (or newer) generation is a live member
            # mis-verdicted across a rendezvous gap: its flagless beacon
            # cannot earn a grow verdict, so recognize it here
            for h in self.supervisor.dead_hosts():
                if h in dead or h in joiners:
                    continue
                d = self.supervisor._read_doc(h)
                if (d is not None
                        and int(d.get("generation") or 0)
                        >= rdzv.generation):
                    age = self.supervisor._doc_age(
                        h, d, self.supervisor._join_fresh)
                    if age is not None and age <= self.grace:
                        joiners.add(h)
            members = sorted(alive)
            for h in sorted(joiners - alive):
                if len(members) < self.max_hosts:
                    members.append(h)
            members = sorted(members)
            if host_id not in members:
                # evicted (or mis-verdicted): park as a joiner until a
                # future generation readmits us
                hb.set_joining(True)
                return rdzv.await_membership(rdzv.generation + 1)
            if len(members) >= self.min_hosts:
                # lease-aware election among the running survivors: the
                # fresh leaseholder proposes; an expired lease is taken
                # over by the lowest-rank survivor
                running = sorted(alive) or members
                if host_id == rdzv.elect_leader(running, max_age=0.0):
                    return rdzv.propose(members, leaders=running)
                # follower: wait as long as the leader might (it may be
                # holding for quorum before proposing)
                return rdzv.await_membership(
                    rdzv.generation + 1,
                    timeout=max(5.0, deadline - time.monotonic()))
            if time.monotonic() >= deadline:
                raise ElasticFleetLost(
                    f"{len(members)} host(s) alive < min_hosts "
                    f"({self.min_hosts}) and no rejoin within the "
                    f"window; relaunch the fleet against checkpointDir "
                    f"{self.checkpoint_dir!r} to resume")
            log.warning("fleet below min_hosts (%d alive, need %d); "
                        "waiting for joining heartbeats",
                        len(members), self.min_hosts)
            time.sleep(max(0.1, self.supervisor.probe_interval))
