"""Multi-process rendezvous over ``torch.distributed`` (the port of
``mmlspark_tpu/parallel/distributed.py``).

Every process calls :func:`initialize` (or :func:`initialize_from_env`
under a launcher that exports the ``MMLTPU_*`` contract). Process 0's
address holds a ``TCPStore`` (``host:port``; ``file:///path`` names a
``FileStore`` on shared storage instead), and the default process group
forms on it: NCCL when the ranks' device is CUDA, gloo on the CPU. A CUDA
rank never falls back to gloo. Each rank drives one device,
``cuda:LOCAL_RANK`` by default. A second, gloo, group over the same ranks
carries the host-side object gathers (``parallel.dataplane``), so the
prefetch thread's agreements never interleave with the training
collectives of the main thread.

Failure model: a worker missing at rendezvous fails the job within
``MMLTPU_INIT_TIMEOUT`` (default 120 s, LightGBM's bound) with a
``RuntimeError`` naming the timeout; a worker dying between collectives
fails its peers' next collective (gloo at once, when the dead peer's
socket closes; NCCL within the process group's timeout,
``MMLTPU_HEARTBEAT_TIMEOUT``, default 600 s), the role of the JAX
coordination service's heartbeats.

Elastic fleets (:func:`elastic_initialize`) re-enter the same fit after a
member loss instead: generation-stamped membership in ``rendezvous.json``
on the job's shared checkpoint storage, proposals serialized by a
:class:`LeaderLease`, and a FRESH store and process group for each
generation — a ``TCPStore`` hosted by that generation's leader at the
address its proposal publishes, then the group at the new rank and world
size. :func:`teardown_for_rendezvous` releases the old groups without any
collective (aborting NCCL communicators rather than destroying them
through a barrier), and the exit handler never runs a collective when a
peer is dead.

``configure_xla_cache`` has no counterpart: there is no XLA program to
cache (the port's kernels are built once into ``mmlspark_tpu_torch/_build``).
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time
from typing import Optional, Sequence

import torch

from .. import telemetry
from ..core.utils import get_logger
from . import mesh as meshlib

log = get_logger("distributed")

_m_generation = telemetry.registry.gauge(
    "mmlspark_rendezvous_generation",
    "the process-group generation this process is currently joined to "
    "(bumped by every elastic re-rendezvous; 0 = never rendezvoused)")
_m_rendezvous = telemetry.registry.counter(
    "mmlspark_rendezvous_total",
    "re-rendezvous joins completed (a fresh store and process group + "
    "barrier re-entry into a new generation)")
_m_lease_term = telemetry.registry.gauge(
    "mmlspark_lease_term",
    "the leader-lease term this process last observed (bumped by every "
    "takeover; 0 = no lease yet)")
_m_lease_renewals = telemetry.registry.counter(
    "mmlspark_lease_renewals",
    "leader-lease renewals written by this process as the holder")
_m_lease_takeovers = telemetry.registry.counter(
    "mmlspark_lease_takeovers",
    "leader-lease acquisitions (fresh grants and expired-lease "
    "takeovers by the lowest-rank fresh host)")

# launcher-agnostic env contract (the JAX package's names)
ENV_COORDINATOR = "MMLTPU_COORDINATOR"       # "host:port" of process 0
ENV_NUM_PROCESSES = "MMLTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "MMLTPU_PROCESS_ID"
ENV_INIT_TIMEOUT = "MMLTPU_INIT_TIMEOUT"     # seconds to wait at rendezvous
ENV_HEARTBEAT_TIMEOUT = "MMLTPU_HEARTBEAT_TIMEOUT"  # collective timeout

DEFAULT_INIT_TIMEOUT = 120
DEFAULT_HEARTBEAT_TIMEOUT = 600

_initialized = False
_device: Optional[torch.device] = None
_host_group = None
_store = None


def is_initialized() -> bool:
    return _initialized


def device() -> torch.device:
    """This rank's device: the one :func:`initialize` chose, else (a group
    made by hand) the current CUDA device under NCCL and the CPU
    otherwise."""
    if _device is not None:
        return _device
    dist = torch.distributed
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_group():
    """The gloo group of the host-side object gathers (the default group
    where :func:`initialize` did not make one)."""
    return _host_group


def _rank_device(dev: str, process_id: int,
                 local_device_ids: Optional[Sequence[int]]) -> torch.device:
    d = torch.device(dev)
    if d.type == "cpu":
        return d
    if d.type != "cuda":
        raise ValueError(f"ranks run on cuda or cpu, not {d}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"distributed device={dev!r} but torch sees no CUDA device; pass "
            f"device='cpu' for a gloo group on the CPU")
    if d.index is not None:
        return d
    if local_device_ids:
        return torch.device("cuda", int(local_device_ids[0]))
    local = os.environ.get("LOCAL_RANK", "")
    idx = int(local) if local.isdigit() else process_id
    return torch.device("cuda", idx % torch.cuda.device_count())


def _make_store(address: str, num_processes: int, process_id: int,
                timeout: datetime.timedelta, is_master: Optional[bool] = None):
    dist = torch.distributed
    if address.startswith("file://"):
        store = dist.FileStore(address[len("file://"):], num_processes)
        store.set_timeout(timeout)
        return store
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r} is not "
                         f"host:port or file:///path")
    return dist.TCPStore(host, int(port), num_processes,
                         is_master=(process_id == 0 if is_master is None
                                    else is_master),
                         timeout=timeout, wait_for_workers=True)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               init_timeout: Optional[int] = None,
               heartbeat_timeout: Optional[int] = None,
               device: str = "cuda") -> None:
    """Join the process group. Blocks until all ``num_processes`` processes
    check in; a worker that never shows up fails the rendezvous after
    ``init_timeout`` seconds (default 120) with a ``RuntimeError``.
    ``device`` ("cuda", "cuda:N" or "cpu") is this rank's device: CUDA
    ranks form an NCCL group (one device a rank: ``local_device_ids[0]``,
    else ``LOCAL_RANK``, else the process id modulo the device count), CPU
    ranks a gloo group."""
    if _initialized:
        log.info("distributed runtime already initialized; skipping")
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id")
    _form_group(coordinator_address, int(num_processes), int(process_id),
                local_device_ids, init_timeout, heartbeat_timeout, device)


def _form_group(address: str, num_processes: int, process_id: int,
                local_device_ids, init_timeout: Optional[int],
                heartbeat_timeout: Optional[int], device: str,
                store_master: Optional[bool] = None) -> None:
    """The store, the check-in barrier, the default group and the gloo
    host group (``initialize``'s body; an elastic generation passes
    ``store_master`` — its leader hosts the store, whatever its rank)."""
    global _initialized, _device, _host_group, _store
    if init_timeout is None:
        init_timeout = int(os.environ.get(ENV_INIT_TIMEOUT,
                                          DEFAULT_INIT_TIMEOUT))
    if heartbeat_timeout is None:
        heartbeat_timeout = int(os.environ.get(ENV_HEARTBEAT_TIMEOUT,
                                               DEFAULT_HEARTBEAT_TIMEOUT))
    dev = _rank_device(device, process_id, local_device_ids)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist = torch.distributed
    wait = datetime.timedelta(seconds=init_timeout)
    try:
        store = _make_store(address, num_processes, process_id, wait,
                            store_master)
        # every rank checks in within the rendezvous bound before the group
        # forms (its own connect waits the collective timeout instead)
        store.set(f"mmltpu/joined/{process_id}", "1")
        store.wait([f"mmltpu/joined/{r}" for r in range(num_processes)],
                   wait)
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=store,
            rank=process_id, world_size=num_processes,
            timeout=datetime.timedelta(seconds=heartbeat_timeout), **kw)
        _host_group = dist.new_group(backend="gloo")
    except Exception as e:   # a missing peer or an unreachable coordinator
        if dist.is_initialized():
            dist.destroy_process_group()
        raise RuntimeError(
            f"distributed rendezvous at {address} failed within "
            f"{init_timeout} s (process {process_id} of {num_processes}): "
            f"{type(e).__name__}: {e}") from e
    _store = store
    _device = dev
    _initialized = True
    log.info("distributed init: rank %d/%d on %s (%s)", dist.get_rank(),
             dist.get_world_size(), dev, dist.get_backend())


def initialize_from_env(device: str = "cuda") -> bool:
    """Initialize from the ``MMLTPU_*`` env contract when present. Returns
    True when distributed init ran; False means single-process mode — both
    are valid, same downstream code."""
    addr = os.environ.get(ENV_COORDINATOR)
    if not addr:
        return False
    initialize(coordinator_address=addr,
               num_processes=int(os.environ[ENV_NUM_PROCESSES]),
               process_id=int(os.environ[ENV_PROCESS_ID]), device=device)
    return True


def shutdown() -> None:
    global _initialized, _device, _host_group, _store
    if _initialized:
        meshlib._clear_cache()
        torch.distributed.destroy_process_group()
        _initialized = False
        _device = None
        _host_group = None
        _store = None


def global_mesh(axes: Optional[dict] = None) -> "meshlib.Mesh":
    """A mesh over ALL ranks. Default: one ``data`` axis over the world
    (pure DP); pass ``axes`` for dp x tp x sp x ep layouts, ``data``
    outermost."""
    if axes is None:
        axes = {"data": meshlib.effective_process_count()}
    return meshlib.make_mesh(axes)


def process_barrier(name: str = "barrier") -> None:
    """Block until every rank reaches this point: an all-reduce of one per
    rank over the default group, on the ranks' devices (NCCL on cards)."""
    if not meshlib.distributed_active():
        return
    dist = torch.distributed
    ones = torch.ones(1, dtype=torch.int32, device=device())
    dist.all_reduce(ones)
    total = int(ones.item())
    if total != dist.get_world_size():
        raise RuntimeError(f"barrier {name!r}: {total} of "
                           f"{dist.get_world_size()} ranks arrived")




# ---- elastic re-rendezvous -------------------------------------------------
#
# The fail-fast model above is right for fixed fleets: a dead peer fails
# the job and the launcher relaunches at full size. Elastic fleets want the
# JAMPI barrier-re-entry shape instead (arxiv 2007.01811): the survivors
# tear the process group down, the generation's leader hosts a NEW store,
# and every member re-enters the rendezvous barrier under a new generation
# — so a kill -9'd process can relaunch and join the *same running fit*,
# and a straggler can be evicted without losing the fleet.
#
# The generation is carried by an atomically-renamed ``rendezvous.json``
# on the job's shared checkpoint storage (the trust anchor the consensus
# checkpoints use): {generation, address, leader, ranks, ...}. Only the
# leader writes it; everyone else polls. A process may only ever JOIN a
# generation strictly newer than the one it last held AND that names it in
# ``ranks`` — a stale process can never join the wrong incarnation; it
# parks in the joining-heartbeat path until a future generation names it.
#
# Teardown never runs a collective: the old groups are aborted (an NCCL
# communicator whose peer died could hang a destroy), the mesh cache is
# dropped, and the old store is kept referenced (bounded by the number of
# generations) so nothing it still serves closes under a peer.

RENDEZVOUS_DOC = "rendezvous.json"

ENV_HOST_ADDRESS = "MMLTPU_HOST_ADDRESS"     # advertised rendezvous addr
ENV_REJOIN_TIMEOUT = "MMLTPU_REJOIN_TIMEOUT"  # seconds to wait for a
DEFAULT_REJOIN_TIMEOUT = 120.0                # generation that names us

_leaked_incarnations: list = []   # earlier generations' stores
_rdzv_coordinator: Optional["RendezvousCoordinator"] = None


class RendezvousError(RuntimeError):
    """A re-rendezvous attempt failed (proposal raced, barrier timed out,
    the group refused to form). Retried with backoff by the caller;
    exhaustion falls back to relaunch-at-full-size (ElasticFleetLost)."""


def rendezvous_coordinator() -> Optional["RendezvousCoordinator"]:
    """The process-wide rendezvous coordinator, armed by
    :func:`elastic_initialize` (None = fixed-fleet mode: a member loss
    fails fast and the launcher relaunches)."""
    return _rdzv_coordinator


LEASE_DOC = "lease.json"
ENV_LEASE_TIMEOUT = "MMLTPU_LEASE_TIMEOUT"
DEFAULT_LEASE_TIMEOUT = 5.0


class LeaderLease:
    """A renewable leader lease over one shared-storage file.

    "Lowest-rank survivor proposes" is a rule each host evaluates from its
    own heartbeat view, and two hosts with briefly divergent views could
    both propose. The lease serializes proposals:

    * ``lease.json`` carries ``{holder, term, seq, time}``. The holder
      renews it (``seq`` + 1, same ``term``) while it leads; every renewal
      is an atomic rename, so readers never see a torn doc.
    * Freshness is judged like the heartbeats: a reader tracks when the
      ``(term, seq)`` pair last *advanced on its own monotonic clock*. A
      lease that has not advanced for ``timeout`` seconds
      (``MMLTPU_LEASE_TIMEOUT``, default 5) is **expired**.
    * An expired (or absent) lease is taken over with ``term + 1``
      (:meth:`RendezvousCoordinator.propose` enforces *who*); the takeover
      re-reads the file after its rename, so of two racing takeovers
      exactly one proceeds.
    * A **stale leader can never publish**: its term is behind the file's,
      so :meth:`renew` refuses, ``propose`` re-validates the lease after
      the doc rename, and followers refuse docs stamped with an old
      ``lease_term``.
    """

    def __init__(self, directory: str, host_id: str,
                 timeout: Optional[float] = None):
        self.directory = directory
        self.host_id = host_id
        if timeout is None:
            timeout = float(os.environ.get(ENV_LEASE_TIMEOUT,
                                           DEFAULT_LEASE_TIMEOUT))
        self.timeout = float(timeout)
        #: the term THIS process last acquired (0 = never held): a
        #: relaunched process starts at 0 and must re-acquire
        self.term = 0
        self._seen: tuple[int, int] = (0, 0)   # last observed (term, seq)
        self._seen_at = time.monotonic()       # reader clock at last advance
        self._last_renewal = 0.0
        self._cache: tuple[float, Optional[dict]] = (0.0, None)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, LEASE_DOC)

    def read(self) -> Optional[dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc.get("term"), int):
                return None
            return doc
        except (OSError, ValueError):
            return None

    def observe(self, max_age: float = 0.0) -> Optional[dict]:
        """Read the lease and advance the reader-side freshness clock
        whenever ``(term, seq)`` moved (fault site ``distributed.lease``).
        ``max_age`` > 0 reuses the last read within that window."""
        if max_age > 0:
            at, doc = self._cache
            if time.monotonic() - at < max_age:
                return doc
        from ..resilience import faults
        faults.inject("distributed.lease")
        doc = self.read()
        self._cache = (time.monotonic(), doc)
        if doc is not None:
            key = (int(doc.get("term", 0)), int(doc.get("seq", 0)))
            if key != self._seen:
                self._seen = key
                self._seen_at = time.monotonic()
            _m_lease_term.set(key[0])
        return doc

    def expired(self, max_age: float = 0.0) -> bool:
        """True when the lease is absent, or its ``(term, seq)`` has not
        advanced for ``timeout`` seconds of THIS reader's monotonic clock
        (a reader that just started watching a stale file waits out one
        full window)."""
        if self.observe(max_age=max_age) is None:
            return True
        return time.monotonic() - self._seen_at >= self.timeout

    def held(self) -> bool:
        """True while the file names this process as holder at the term
        it acquired."""
        doc = self.read()
        return (self.term > 0 and doc is not None
                and doc.get("holder") == self.host_id
                and int(doc.get("term", 0)) == self.term)

    def _write(self, term: int, seq: int):
        os.makedirs(self.directory, exist_ok=True)
        doc = {"holder": self.host_id, "term": term, "seq": seq,
               "time": time.time()}
        # a tmp file per process and thread (racing takeovers must not
        # clobber each other's). No fsync before the rename on purpose: a
        # lease needs READ atomicity — a leader that crashes SHOULD lose it
        tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)
        self._seen = (term, seq)
        self._seen_at = time.monotonic()
        self._cache = (self._seen_at, doc)

    def renew(self):
        """Holder-side keep-alive: bump ``seq`` at the held term. Raises
        :class:`RendezvousError` when the lease moved on (deposed)."""
        from ..resilience import faults
        faults.inject("distributed.lease")
        doc = self.read()
        if (doc is None or doc.get("holder") != self.host_id
                or int(doc.get("term", 0)) != self.term or self.term == 0):
            raise RendezvousError(
                f"{self.host_id} lost the leader lease (now held by "
                f"{(doc or {}).get('holder')!r} at term "
                f"{(doc or {}).get('term')})")
        self._write(self.term, int(doc.get("seq", 0)) + 1)
        self._last_renewal = time.monotonic()
        _m_lease_renewals.inc()

    def maybe_renew(self):
        """Opportunistic holder keep-alive, throttled to a third of the
        timeout (callers invoke it per committed step)."""
        if self.term == 0:
            return
        if time.monotonic() - self._last_renewal < self.timeout / 3.0:
            return
        try:
            self.renew()
        except RendezvousError:
            self.term = 0      # deposed: stop renewing a lost lease

    def acquire(self) -> dict:
        """Take (over) the lease at ``term + 1``. Refused while another
        holder is fresh; a write race is resolved by the post-rename
        re-read — exactly one contender's doc stands."""
        from ..resilience import faults
        faults.inject("distributed.lease")
        doc = self.observe()
        if (doc is not None and doc.get("holder") != self.host_id
                and not self.expired()):
            raise RendezvousError(
                f"leader lease is held fresh by {doc['holder']!r} (term "
                f"{doc['term']}); {self.host_id} must not take over")
        new_term = (int(doc.get("term", 0)) if doc else 0) + 1
        self._write(new_term, 1)
        cur = self.read()
        if (cur is None or cur.get("holder") != self.host_id
                or int(cur.get("term", 0)) != new_term):
            raise RendezvousError(
                f"lease takeover raced: {self.host_id} wrote term "
                f"{new_term} but the file now holds "
                f"{(cur or {}).get('holder')!r} at term "
                f"{(cur or {}).get('term')}")
        self.term = new_term
        self._last_renewal = time.monotonic()
        _m_lease_takeovers.inc()
        _m_lease_term.set(new_term)
        telemetry.trace.instant("lease/takeover", holder=self.host_id,
                                term=new_term)
        telemetry.flight.note("lease/takeover", holder=self.host_id,
                              term=new_term)
        log.warning("leader lease acquired by %s at term %d",
                    self.host_id, new_term)
        return cur


def _advertised_address() -> str:
    """The address peers reach THIS host on (a generation's store binds
    here when this host leads it)."""
    addr = os.environ.get(ENV_HOST_ADDRESS)
    if addr:
        return addr
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _release_groups():
    """Drop every process group of this process without a collective:
    abort them (NCCL communicators abort rather than destroy, which could
    wait on a dead peer), or destroy where this torch has no abort."""
    from torch.distributed import distributed_c10d as c10d
    meshlib._clear_cache()
    abort = getattr(c10d, "_abort_process_group", None)
    if abort is not None:
        abort()
    else:
        torch.distributed.destroy_process_group()


_exit_handler_registered = False


def _register_exit_handler():
    """At interpreter exit, release a still-formed elastic group. When
    every current-generation peer's heartbeat file is fresh (the fleet is
    exiting together) the groups are destroyed; when a peer is dead they
    are aborted, so no exit path waits on a dead peer."""
    global _exit_handler_registered
    if _exit_handler_registered:
        return
    _exit_handler_registered = True
    import atexit

    def _release_at_exit():
        dist = torch.distributed
        if not (dist.is_available() and dist.is_initialized()):
            return
        rdzv = _rdzv_coordinator
        healthy = True
        if rdzv is not None and rdzv.ranks:
            now = time.time()
            for h in rdzv.ranks:
                if h == rdzv.host_id:
                    continue
                try:
                    fresh = now - os.path.getmtime(os.path.join(
                        rdzv.directory, f"hb_{h}.json")) <= 10.0
                except OSError:
                    fresh = False
                if not fresh:
                    healthy = False
                    break
        try:
            if healthy:
                meshlib._clear_cache()
                dist.destroy_process_group()
            else:
                _release_groups()
        except Exception as e:   # exiting: report, never raise
            log.warning("process group release at exit failed: %s", e)

    atexit.register(_release_at_exit)


def teardown_for_rendezvous() -> None:
    """Detach from the current (possibly dead) generation WITHOUT a
    collective: the default group, the gloo host group and the mesh's
    per-axis groups are aborted, the mesh cache dropped, and the store
    kept referenced. The next :func:`initialize`-shaped join forms a fresh
    group."""
    global _initialized, _device, _host_group, _store
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        _release_groups()
    else:
        meshlib._clear_cache()
    if _store is not None:
        _leaked_incarnations.append(_store)
    _initialized = False
    _device = None
    _host_group = None
    _store = None


class RendezvousCoordinator:
    """Generation-stamped membership + barrier re-entry for one elastic
    job (one instance per process; ``host_id`` is the process's STABLE
    identity — its launch rank — which survives re-ranking across
    generations). ``device`` is the kind of the ranks' device ("cuda":
    NCCL groups, "cpu": gloo), as :func:`initialize` takes it."""

    def __init__(self, directory: str, host_id: str,
                 init_timeout: Optional[int] = None,
                 lease_timeout: Optional[float] = None,
                 device: str = "cuda"):
        self.directory = directory
        self.host_id = host_id
        self.device = device
        self.generation = 0
        self.ranks: dict[str, int] = {}
        #: proposals are serialized by a leader lease — see LeaderLease
        self.lease = LeaderLease(directory, host_id,
                                 timeout=lease_timeout)
        #: the PROCESS-LEVEL heartbeat beacon (started by
        #: elastic_initialize, reused by the fit coordinator): the host
        #: must never go silent between joining a generation and the fit
        #: taking over
        self.heartbeat = None
        self.init_timeout = (init_timeout if init_timeout is not None
                             else int(os.environ.get(
                                 ENV_INIT_TIMEOUT, DEFAULT_INIT_TIMEOUT)))

    @property
    def path(self) -> str:
        return os.path.join(self.directory, RENDEZVOUS_DOC)

    def read(self) -> Optional[dict]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc.get("generation"), int):
                return None
            return doc
        except (OSError, ValueError):
            return None

    def elect_leader(self, members, max_age: float = 0.05) -> str:
        """Lease-aware leader election over ``members``: the fresh lease
        holder when it is a member, else the lowest-rank member (who takes
        over the expired or absent lease at propose time)."""
        members = sorted(members)
        doc = self.lease.observe(max_age=max_age)
        if doc is not None and not self.lease.expired(max_age=max_age):
            holder = doc.get("holder")
            if holder in members:
                return holder
        return members[0] if members else self.host_id

    def propose(self, hosts, unwind_at: Optional[tuple] = None,
                leaders=None) -> dict:
        """Leader-side: mint the next generation over ``hosts`` (ranks in
        sorted host order) and commit the doc atomically. The proposer
        hosts the generation's store at the doc's ``address``. ``unwind_at``
        tells still-stepping members the (epoch, step) after which they
        unwind and join — the deterministic grow/evict boundary.
        ``leaders`` (default ``hosts``) are the hosts that may lead: the
        running survivors, when a parked joiner is among ``hosts``.

        Proposals are serialized by the leader lease: the fresh holder
        renews and proposes; an absent or expired lease is taken over by
        the lowest-rank host of ``leaders``; anyone else is refused. After
        the doc rename the lease is re-validated — a leader deposed
        mid-proposal raises instead of publishing, and a fresh leader
        whose doc was overwritten by a stale straggler rewrites it."""
        from ..resilience import faults
        faults.inject("distributed.rendezvous")
        hosts = sorted(set(hosts))
        lead = sorted(set(leaders)) if leaders else hosts
        if self.lease.held():
            self.lease.renew()
        else:
            lease_doc = self.lease.observe()
            if (lease_doc is not None
                    and lease_doc.get("holder") != self.host_id
                    and not self.lease.expired()):
                raise RendezvousError(
                    f"{self.host_id} proposed a generation but "
                    f"{lease_doc['holder']!r} holds a fresh leader lease "
                    f"(term {lease_doc['term']})")
            if self.host_id != lead[0]:
                raise RendezvousError(
                    f"{self.host_id} proposed a generation but {lead[0]} "
                    f"is the surviving leader (lowest-rank fresh host "
                    f"takes the expired lease)")
            self.lease.acquire()
        cur = self.read()
        gen = max(self.generation,
                  cur["generation"] if cur else 0) + 1
        doc = {"generation": gen,
               "address": f"{_advertised_address()}:{_free_port()}",
               "leader": self.host_id,
               "ranks": {h: i for i, h in enumerate(hosts)},
               "num_processes": len(hosts),
               "lease_term": self.lease.term,
               "time": time.time()}
        if unwind_at is not None:
            doc["unwind_at"] = list(unwind_at)
        os.makedirs(self.directory, exist_ok=True)
        for _attempt in range(8):
            # the checkpoints' commit discipline (fsync BEFORE the atomic
            # rename): a torn doc would strand relaunched processes on a
            # generation that never existed
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            if not self.lease.held():
                raise RendezvousError(
                    f"{self.host_id} lost the leader lease during the "
                    f"proposal; generation {gen} is void (refused by "
                    f"generation at every follower)")
            stood = self.read()
            if (stood is not None
                    and stood.get("generation") == gen
                    and stood.get("address") == doc["address"]
                    and stood.get("lease_term") == self.lease.term):
                break
            log.warning("rendezvous doc overwritten by a stale proposal; "
                        "leaseholder %s rewrites generation %d",
                        self.host_id, gen)
        else:
            raise RendezvousError(
                f"rendezvous doc for generation {gen} would not stand "
                f"after 8 rewrites")
        log.warning("rendezvous generation %d proposed: %d host(s) %s at "
                    "%s (lease term %d)", gen, len(hosts), hosts,
                    doc["address"], self.lease.term)
        return doc

    def await_membership(self, min_generation: int,
                         timeout: Optional[float] = None) -> dict:
        """Follower-side: poll the doc until a generation >=
        ``min_generation`` names this host. A doc that omits us (evicted,
        or the leader has not seen our joining heartbeat yet) keeps us
        parked — the stale-generation guard."""
        from ..resilience import faults
        faults.inject("distributed.rendezvous")
        if timeout is None:
            timeout = float(os.environ.get(ENV_REJOIN_TIMEOUT,
                                           DEFAULT_REJOIN_TIMEOUT))
        deadline = time.monotonic() + timeout
        while True:
            doc = self.read()
            if doc is not None and "lease_term" in doc:
                # a stale leader's LATE proposal, stamped with a lease term
                # the fleet has moved past: refused (the fresh leaseholder
                # rewrites the doc; keep polling)
                lease_doc = self.lease.read()
                if (lease_doc is not None
                        and int(doc["lease_term"])
                        < int(lease_doc.get("term", 0))):
                    doc = None
            if (doc and doc["generation"] >= min_generation
                    and self.host_id in doc.get("ranks", {})):
                return doc
            if time.monotonic() >= deadline:
                raise RendezvousError(
                    f"no rendezvous generation >= {min_generation} named "
                    f"{self.host_id} within {timeout:.0f}s")
            time.sleep(0.05)

    def join(self, doc: dict) -> None:
        """Tear down the old generation and enter ``doc``'s: a fresh store
        (hosted by the doc's leader) and process group at this host's new
        rank, every member checked in before anyone dispatches a
        collective. Refuses a doc whose generation is not strictly newer
        than the one this process last held, or that omits it."""
        gen = int(doc["generation"])
        if gen <= self.generation:
            raise RendezvousError(
                f"stale generation {gen} (this process already held "
                f"{self.generation}) — refusing to join an old "
                f"incarnation")
        rank = doc["ranks"].get(self.host_id)
        if rank is None:
            raise RendezvousError(
                f"generation {gen} does not include {self.host_id}")
        leader = doc.get("leader")
        with telemetry.trace.span("distributed/rendezvous",
                                  generation=gen, rank=rank,
                                  hosts=len(doc["ranks"])):
            teardown_for_rendezvous()
            try:
                _form_group(doc["address"], int(doc["num_processes"]),
                            int(rank), None, self.init_timeout, None,
                            self.device,
                            store_master=(leader == self.host_id
                                          if leader is not None else None))
            except RuntimeError as e:
                raise RendezvousError(
                    f"generation {gen} did not form: {e}") from e
        _register_exit_handler()
        self.generation = gen
        self.ranks = dict(doc["ranks"])
        _m_generation.set(gen)
        _m_rendezvous.inc()
        telemetry.flight.note("distributed/rendezvous", generation=gen,
                              rank=rank, hosts=len(doc["ranks"]))
        log.warning("joined rendezvous generation %d as rank %d/%d on %s",
                    gen, rank, int(doc["num_processes"]), _device)


def _member_docs(directory: str, doc: dict, self_host: str):
    """(host, heartbeat doc, seconds since the file changed) of each OTHER
    member the doc names, for the ones whose heartbeat reads."""
    now = time.time()
    for host in doc.get("ranks", {}):
        if host == self_host:
            continue
        path = os.path.join(directory, f"hb_{host}.json")
        try:
            mtime = os.path.getmtime(path)
            with open(path, "r", encoding="utf-8") as f:
                yield host, json.load(f), now - mtime
        except (OSError, ValueError):
            continue


def _incarnation_live(directory: str, doc: dict, self_host: str,
                      window: float = 10.0) -> bool:
    """Is the doc's generation still running? True when any OTHER member's
    heartbeat file was modified within ``window`` seconds (reader-side FS
    mtime) and is stamped with the doc's generation (or a newer one): that
    member has joined it. A ``joining`` heartbeat does NOT count: it is a
    parked waiter, not a running member — two relaunched processes must
    not each mistake the other for a live fit and park forever."""
    gen = int(doc.get("generation", 0))
    return any(age <= window and not member.get("joining")
               and int(member.get("generation") or 0) >= gen
               for _h, member, age in _member_docs(directory, doc,
                                                   self_host))


def _generation_forming(directory: str, doc: dict, self_host: str,
                        init_timeout: float) -> bool:
    """Is the doc's generation still forming, with a place for us? It
    names this host, it was written within the rendezvous bound, and no
    other member's heartbeat is stamped with it yet (its members are still
    checking in, so joining completes its barrier)."""
    if self_host not in doc.get("ranks", {}):
        return False
    if time.time() - float(doc.get("time") or 0.0) > init_timeout:
        return False
    gen = int(doc.get("generation", 0))
    return not any(int(member.get("generation") or 0) >= gen
                   for _h, member, _a in _member_docs(directory, doc,
                                                      self_host))


def elastic_initialize(checkpoint_dir: str,
                       host_id: Optional[str] = None,
                       rejoin_timeout: Optional[float] = None,
                       device: str = "cuda") -> bool:
    """Elastic-fleet entry point: join (or REJOIN) the job's current
    generation through the shared-storage rendezvous protocol instead of
    the fixed-fleet env contract. Every launch and relaunch calls this;
    the three cases resolve themselves:

    * **fresh job** (no rendezvous doc, or one still forming that names
      us): the env-contract leader (process 0) proposes generation 1 over
      the launch fleet; everyone joins it.
      Returns False (single-process mode) when the env contract is
      absent. A world of one process is a real group in the port (a rank
      is a device), so ``MMLTPU_NUM_PROCESSES=1`` forms generation 1.
    * **rejoin** (doc present, generation live, we are not in it): a
      relaunched or evicted host. Write a ``joining`` heartbeat and park
      until the running fit's leader admits us into a future generation
      at a checkpoint boundary, then join it.
    * **full relaunch** (doc present, generation dead): process 0 proposes
      generation N+1 over the launch fleet and consensus-resume carries
      the run over.

    ``device`` is the ranks' device kind ("cuda": NCCL, "cpu": gloo).
    Returns True when a generation was joined."""
    global _rdzv_coordinator
    addr = os.environ.get(ENV_COORDINATOR)
    n_env = int(os.environ.get(ENV_NUM_PROCESSES, "0") or 0)
    pid_env = int(os.environ.get(ENV_PROCESS_ID, "0") or 0)
    if host_id is None:
        host_id = meshlib.stable_host_id()
    from ..resilience.elastic import (HostHeartbeat, _grace_default,
                                      _hb_interval_default, heartbeat_dir)
    hb_dir = heartbeat_dir(checkpoint_dir)
    os.makedirs(hb_dir, exist_ok=True)
    rdzv = RendezvousCoordinator(hb_dir, host_id, device=device)
    hb = HostHeartbeat(host_id, hb_dir,
                       _hb_interval_default(_grace_default()))
    doc = rdzv.read()
    launch_hosts = [f"host{i}" for i in range(n_env)]
    if doc is None:
        if not addr or n_env < 1:
            return False                    # single-process mode
        if pid_env == 0:
            doc = rdzv.propose(launch_hosts)
        else:
            doc = rdzv.await_membership(1, timeout=rejoin_timeout)
        hb.start()
        rdzv.join(doc)
    elif _generation_forming(hb_dir, doc, host_id, rdzv.init_timeout):
        # the generation's leader proposed it moments ago and its members
        # are still checking in (this process started late): join it
        hb.start()
        rdzv.join(doc)
    elif _incarnation_live(hb_dir, doc, host_id):
        # REJOIN a running fit: park behind a joining heartbeat until a
        # generation names us. Even when the live doc still names this
        # host (killed and relaunched before the leader noticed), the old
        # generation's connections are gone — only a fresh generation is
        # joinable; the joining flag self-reports the restart
        hb.set_joining(True)
        hb.start()
        log.warning("rendezvous doc generation %d is live; %s parks "
                    "with a joining heartbeat until readmitted",
                    doc["generation"], host_id)
        target = rdzv.await_membership(doc["generation"] + 1,
                                       timeout=rejoin_timeout)
        rdzv.join(target)
        hb.set_joining(False)
    else:
        # dead generation: full-fleet relaunch over the env contract
        if not addr or n_env < 1:
            return False
        if pid_env == 0:
            doc = rdzv.propose(launch_hosts)
        else:
            doc = rdzv.await_membership(doc["generation"] + 1,
                                        timeout=rejoin_timeout)
        hb.start()
        rdzv.join(doc)
    # the beacon OUTLIVES this call (the fit coordinator reuses it)
    hb.set_generation(rdzv.generation)
    rdzv.heartbeat = hb
    _rdzv_coordinator = rdzv
    return True
