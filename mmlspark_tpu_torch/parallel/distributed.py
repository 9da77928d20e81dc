"""Multi-process rendezvous over ``torch.distributed`` (the port of
``mmlspark_tpu/parallel/distributed.py``, its non-elastic half).

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
fails its peers' next collective within the process group's timeout
(``MMLTPU_HEARTBEAT_TIMEOUT``, default 600 s), the role of the JAX
coordination service's heartbeats.

``configure_xla_cache`` has no counterpart: there is no XLA program to
cache (the port's kernels are built once into ``mmlspark_tpu_torch/_build``).
The elastic half — ``LeaderLease``, ``RendezvousCoordinator``,
``elastic_initialize`` and ``teardown_for_rendezvous`` — belongs with
``resilience/elastic.py`` (ROADMAP.md Queue 1 item 13b) and raises
naming it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch

from ..core.utils import get_logger
from . import mesh as meshlib

log = get_logger("distributed")

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
                timeout: datetime.timedelta):
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
                         is_master=process_id == 0, timeout=timeout,
                         wait_for_workers=True)


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
    global _initialized, _device, _host_group, _store
    if _initialized:
        log.info("distributed runtime already initialized; skipping")
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id")
    if init_timeout is None:
        init_timeout = int(os.environ.get(ENV_INIT_TIMEOUT,
                                          DEFAULT_INIT_TIMEOUT))
    if heartbeat_timeout is None:
        heartbeat_timeout = int(os.environ.get(ENV_HEARTBEAT_TIMEOUT,
                                               DEFAULT_HEARTBEAT_TIMEOUT))
    dev = _rank_device(device, int(process_id), local_device_ids)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist = torch.distributed
    wait = datetime.timedelta(seconds=init_timeout)
    try:
        store = _make_store(coordinator_address, int(num_processes),
                            int(process_id), wait)
        # every rank checks in within the rendezvous bound before the group
        # forms (its own connect waits the collective timeout instead)
        store.set(f"mmltpu/joined/{process_id}", "1")
        store.wait([f"mmltpu/joined/{r}" for r in range(int(num_processes))],
                   wait)
        kw = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=store,
            rank=int(process_id), world_size=int(num_processes),
            timeout=datetime.timedelta(seconds=heartbeat_timeout), **kw)
        _host_group = dist.new_group(backend="gloo")
    except Exception as e:   # a missing peer or an unreachable coordinator
        if dist.is_initialized():
            dist.destroy_process_group()
        raise RuntimeError(
            f"distributed rendezvous at {coordinator_address} failed within "
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


# ---- elastic re-rendezvous: item 13b ---------------------------------------

class RendezvousError(RuntimeError):
    """A re-rendezvous attempt failed (the elastic half, item 13b)."""


def _elastic_not_ported(what: str):
    return NotImplementedError(
        f"{what} belongs with resilience/elastic.py, not ported yet "
        f"(ROADMAP.md Queue 1 item 13b)")


def rendezvous_coordinator():
    """Always None: no elastic rendezvous is armed in the port (item 13b)."""
    return None


class LeaderLease:
    def __init__(self, *a, **k):
        raise _elastic_not_ported("LeaderLease")


class RendezvousCoordinator:
    def __init__(self, *a, **k):
        raise _elastic_not_ported("RendezvousCoordinator")


def elastic_initialize(*a, **k):
    raise _elastic_not_ported("elastic_initialize")


def teardown_for_rendezvous(*a, **k):
    raise _elastic_not_ported("teardown_for_rendezvous")
