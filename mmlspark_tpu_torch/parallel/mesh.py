"""Named axes over the ranks of a process group: the port's distributed
substrate (the port of ``mmlspark_tpu/parallel/mesh.py``).

The JAX package is single-controller SPMD: one process drives every local
chip and XLA inserts the collectives from the shardings. PyTorch drives one
device per rank, so the port maps the JAX concepts as follows:

* a device of ``jax.devices()`` is a rank of the default process group
  (its device ``cuda:LOCAL_RANK``, or the CPU under gloo);
* ``effective_process_count()`` is the world size (1 inside
  :class:`local_fit_mode`, and 1 with no process group);
* a ``Mesh`` is a :class:`Mesh` over the world with the same axis names and
  order (``data`` outermost), built on
  ``torch.distributed.device_mesh.init_device_mesh``; each axis has its
  process group, and the ranks sharing a ``data`` coordinate form the
  inner block (tp/sp/ep/pp), whose ranks are consecutive, so they stay on
  one host's NVLink and only the dp all-reduce crosses hosts;
* a sharding is a :class:`Sharding` (a mesh and a :class:`P`); placing an
  array gives THIS rank's slice of it, or the array itself where it is
  replicated, as a tensor on the mesh's device.

Axis conventions are the JAX package's: ``data`` (DP), ``model`` (TP),
``seq`` (SP), ``expert`` (EP), ``pipe`` (PP). A mesh that needs more ranks
than the world has raises the JAX package's ``ValueError`` ("needs N
devices, have M"): one rank with ``tensorParallel=2`` never runs
unsharded.
"""

from __future__ import annotations

import math
import os
import socket
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..resilience import faults

# host->device placement telemetry: every batch or replicated tree placed
# through this module. No-ops unless MMLSPARK_TPU_TELEMETRY=1.
_m_put_bytes = telemetry.registry.counter(
    "mmlspark_mesh_put_bytes",
    "host bytes handed to device placement (shard_batch/put_global_batch)")
_m_put_seconds = telemetry.registry.histogram(
    "mmlspark_mesh_put_seconds",
    "wall time of one device placement call (dispatch side — transfers "
    "may complete asynchronously)")


def _observe_put(t0: float, arrays):
    _m_put_seconds.observe(time.perf_counter() - t0)
    _m_put_bytes.inc(sum(getattr(a, "nbytes", 0) for a in arrays))


# Collectives issued concurrently from several host threads on the same
# groups interleave differently on each rank and deadlock. Any fit that
# runs collectives while other fits may run on other threads (e.g.
# TuneHyperparameters' pool) holds this lock. Reentrant so a stage can span
# several collective phases in one critical section.
collective_fit_lock = threading.RLock()

# ---- local-fit mode -------------------------------------------------------
# A fleet tuner assigns whole trials to processes; each process then fits
# ITS trials with no collectives at all. A module-level counter (not a
# contextvar) because the tuner's worker THREADS must see the flag the
# coordinating thread set.
_local_fit_count = 0
_local_fit_guard = threading.Lock()


class local_fit_mode:
    """Context manager: fits inside run process-locally (no collectives)."""

    def __enter__(self):
        global _local_fit_count
        with _local_fit_guard:
            _local_fit_count += 1
        return self

    def __exit__(self, *exc):
        global _local_fit_count
        with _local_fit_guard:
            _local_fit_count -= 1
        return False


def in_local_fit() -> bool:
    return _local_fit_count > 0


def _dist_ready() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def distributed_active() -> bool:
    """A process group is up and this thread is not in local-fit mode: fits
    and transforms take their collective paths (a world of one rank
    included — every collective still runs)."""
    return _dist_ready() and not in_local_fit()


def effective_process_count() -> int:
    """The world size, except 1 inside local-fit mode or with no process
    group: the switch that steers every collective code path to its
    single-process form."""
    return torch.distributed.get_world_size() if distributed_active() else 1


def process_index() -> int:
    """This rank (0 with no process group or in local-fit mode)."""
    return torch.distributed.get_rank() if distributed_active() else 0


class P(tuple):
    """A partition spec (the port's copy of ``jax.sharding.PartitionSpec``):
    one entry per leading dim, an axis name, a tuple of names, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Sharding(NamedTuple):
    """A mesh and a partition spec: the port's ``NamedSharding``."""
    mesh: "Mesh"
    spec: P


class Mesh:
    """Named axes over ranks, ``data`` outermost (row-major rank layout).

    ``shape`` maps each axis to its size, in order; ``size`` is their
    product; ``device`` is this rank's device. ``group(axis)`` is the
    process group of the ranks that differ only along ``axis`` (None on a
    mesh with no process group), ``axis_index(axis)`` this rank's
    coordinate, and ``inner_group()`` the ranks sharing this rank's
    ``data`` coordinate."""

    def __init__(self, axes: dict, device: torch.device,
                 device_mesh=None, inner=None):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = int(math.prod(self.shape.values()))
        self.device = device
        self._dm = device_mesh
        self._inner = inner

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"

    @property
    def distributed(self) -> bool:
        return self._dm is not None

    def group(self, axis: str):
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}")
        return None if self._dm is None else self._dm.get_group(axis)

    def axis_index(self, axis: str) -> int:
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}")
        return 0 if self._dm is None else int(self._dm.get_local_rank(axis))

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def inner_group(self):
        """The inner block's group (ranks sharing the data coordinate)."""
        return self._inner


# meshes are built collectively (every rank creates every subgroup in the
# same order), so one per axis layout per process group, reused by every
# later fit and transform
_mesh_cache: dict = {}
_mesh_lock = threading.Lock()


def _world_device() -> torch.device:
    from . import distributed
    return distributed.device()


def _build(axes: dict) -> Mesh:
    """The collective Mesh over the whole world for ``axes`` (their product
    equals the world size)."""
    dist = torch.distributed
    from torch.distributed.device_mesh import init_device_mesh
    dev = _world_device()
    key = (tuple(axes.items()), id(dist.group.WORLD))
    with _mesh_lock:
        m = _mesh_cache.get(key)
        if m is not None:
            return m
        dm = init_device_mesh(dev.type, tuple(axes.values()),
                              mesh_dim_names=tuple(axes))
        names = [a for a in axes if a != "data"]
        inner_n = int(math.prod(axes[a] for a in names))
        inner = None
        if inner_n > 1:
            live = [a for a in names if axes[a] > 1]
            if len(live) == 1:
                inner = dm.get_group(live[0])
            else:
                # ranks are row-major with data outermost: each inner block
                # is a consecutive range; every rank creates every block
                world = dist.get_world_size()
                me = dist.get_rank()
                for lo in range(0, world, inner_n):
                    g = dist.new_group(list(range(lo, lo + inner_n)))
                    if lo <= me < lo + inner_n:
                        inner = g
        m = Mesh(axes, dev, device_mesh=dm, inner=inner)
        _mesh_cache[key] = m
        return m


def _clear_cache():
    with _mesh_lock:
        _mesh_cache.clear()


def _local_device() -> torch.device:
    if _dist_ready():
        return _world_device()
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _n_devices(devices) -> int:
    if devices is not None:
        return len(list(devices))
    return effective_process_count()


def _mesh_of(axes: dict, n: int) -> Mesh:
    if n > 1 or distributed_active():
        if int(math.prod(axes.values())) != torch.distributed.get_world_size():
            raise ValueError(
                f"mesh {axes} must cover the world's "
                f"{torch.distributed.get_world_size()} ranks")
        return _build(axes)
    return Mesh(axes, _local_device())


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence] = None,
                axis_names: tuple = ("data", "model")) -> Mesh:
    """A 2-D (data, model) mesh over the world's ranks. With no process
    group (or in local-fit mode) the world is one rank, and a model axis
    above 1 raises: the port never runs a sharded program unsharded.
    ``devices`` (a rank list) only sets the count the checks use."""
    n = 1 if in_local_fit() else _n_devices(devices)
    if data is None:
        if model < 1 or n % model != 0:
            raise ValueError(
                f"model axis ({model}) must divide the device count ({n}) "
                f"— a silently-truncated mesh would train/serve on a "
                f"subset of the chips")
        data = n // model
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model} is empty: {n} devices cannot "
                         f"host a model axis of {model}")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, "
                         f"have {n}")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} leaves ranks idle: the port "
                         f"builds meshes over the whole world ({n})")
    return _mesh_of(dict(zip(axis_names, (data, model))), n)


def make_mesh(axes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """An N-D mesh from {axis_name: size}, axis order = dict order
    (outermost first — put ``data`` outermost so DP collectives cross the
    slowest links and tp/sp/ep ride the NVLink neighbours)."""
    n = 1 if in_local_fit() else _n_devices(devices)
    sizes = list(axes.values())
    if any(s < 1 for s in sizes):
        raise ValueError(f"mesh axes must be >= 1, got {axes}")
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")
    if total < n:
        raise ValueError(f"mesh {axes} leaves ranks idle: the port builds "
                         f"meshes over the whole world ({n})")
    return _mesh_of(dict(axes), n)


def stable_host_id() -> str:
    """This process's stable host identity: its launch rank
    (``MMLTPU_PROCESS_ID``) when the launcher's env contract set one, else
    the current rank."""
    v = os.environ.get("MMLTPU_PROCESS_ID", "")
    if v.isdigit():
        return f"host{int(v)}"
    return f"host{process_index()}"


def host_device_groups(n_groups: int = 0) -> list:
    """Partition the world's ranks into named "host" groups: the failure
    domains elastic training supervises. Default: one group per host
    (ranks sharing a hostname, agreed through one object gather); with
    ``n_groups > 1``, ``n_groups`` contiguous chunks of the ranks (the tail
    rides with the last). Group ids are stable ("host0", "host1", ...)."""
    ranks = list(range(effective_process_count()))
    if n_groups and n_groups > 1:
        if n_groups > len(ranks):
            raise ValueError(f"cannot split {len(ranks)} devices into "
                             f"{n_groups} host groups")
        per = len(ranks) // n_groups
        groups = [(f"host{g}", ranks[g * per:(g + 1) * per])
                  for g in range(n_groups)]
        groups[-1][1].extend(ranks[n_groups * per:])
        return groups
    if len(ranks) == 1:
        return [("host0", ranks)]
    from .dataplane import allgather_pyobj
    names = allgather_pyobj(socket.gethostname())
    order: dict = {}
    for r, h in enumerate(names):
        order.setdefault(h, []).append(r)
    return [(f"host{i}", rs) for i, rs in enumerate(order.values())]


def batch_sharding(mesh: Mesh, batch_axis: str = "data") -> Sharding:
    """Dim 0 (batch) split over the data axis, the rest replicated."""
    return Sharding(mesh, P(batch_axis))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())


def _tensor(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _data_slice(a, mesh: Mesh, batch_axis: str):
    n = mesh.axis_size(batch_axis)
    if n == 1:
        return a
    if len(a) % n:
        raise ValueError(f"batch of {len(a)} rows does not split over the "
                         f"{batch_axis} axis ({n}); pad it first "
                         f"(pad_batch_to_devices)")
    per = len(a) // n
    i = mesh.axis_index(batch_axis)
    return a[i * per:(i + 1) * per]


def shard_batch(arrays, mesh: Mesh, batch_axis: str = "data"):
    """A list (or one array) of GLOBAL host batches -> THIS rank's rows of
    each, along the data axis, as tensors on the mesh's device."""
    single = not isinstance(arrays, (list, tuple))
    seq = [arrays] if single else list(arrays)
    t0 = time.perf_counter()
    out = [_tensor(_data_slice(a, mesh, batch_axis), mesh.device)
           for a in seq]
    if telemetry.enabled():
        _observe_put(t0, seq)
    return out[0] if single else type(arrays)(out)


def _pad_rows_to_multiple(arr: np.ndarray, mult: int):
    n = arr.shape[0]
    rem = (-n) % max(1, mult)
    if rem == 0:
        return arr, n
    pad = np.repeat(arr[-1:], rem, axis=0)
    return np.concatenate([arr, pad], axis=0), n


def pad_batch_to_devices(arr: np.ndarray, mesh: Mesh,
                         batch_axis: str = "data"):
    """Pad dim 0 to a multiple of the data-axis size. Returns (padded,
    original_n)."""
    return _pad_rows_to_multiple(arr, mesh.axis_size(batch_axis))


def pad_batch_to_local_devices(arr: np.ndarray, mesh: Mesh,
                               batch_axis: str = "data"):
    """Multi-rank variant: pad THIS rank's local rows to a multiple of its
    share of the batch axis (one data index a rank: no padding beyond the
    single-rank rule)."""
    share = max(1, mesh.axis_size(batch_axis) // effective_process_count())
    return _pad_rows_to_multiple(arr, share)


def local_rows(t, n: Optional[int] = None) -> np.ndarray:
    """THIS rank's rows of a batch (inverse of put_global_batch) as host
    numpy, optionally the first ``n`` real rows."""
    out = (t.detach().float().cpu().numpy()
           if isinstance(t, torch.Tensor) and t.is_floating_point()
           else (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                 else np.asarray(t)))
    return out[:n] if n is not None else out


def put_global_batch(arr, mesh: Mesh, batch_axis: str = "data"):
    """THIS rank's rows of a batch split over ``batch_axis`` -> a tensor on
    the mesh's device. Multi-rank, ``arr`` is this rank's local rows: the
    global batch is every rank's rows in rank order, as the JAX package
    assembles it from every process's shard."""
    faults.inject("dataplane.put")
    t0 = time.perf_counter()
    out = _tensor(arr, mesh.device)
    if telemetry.enabled():
        _observe_put(t0, [arr])
    return out


def put_replicated(tree: dict, mesh: Mesh) -> dict:
    """A dict of host arrays or tensors -> the same on the mesh's device.
    Every rank must hold identical values (same-seed init guarantees it)."""
    return {k: _tensor(v, mesh.device) for k, v in tree.items()}


#: tensor-parallel placement rules shared by training (TorchLearner) and
#: inference (TorchModel), matched against the JAX package's flax paths:
#: wide Dense kernels shard their OUTPUT columns over ``model``, every
#: other kernel replicates. First match wins (param_specs).
TP_PARAM_RULES = (("Dense", P(None, "model")), ("kernel", P()))

#: expert-parallel rules: the stacked expert weights shard their leading
#: (expert) axis over ``expert``.
EP_PARAM_RULES = (("expert_w", P("expert",)), ("expert_b", P("expert",)))


def _local_device_count() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` when the launcher set it,
    else agreed through one gather of the hostnames."""
    v = os.environ.get("LOCAL_WORLD_SIZE", "")
    if v.isdigit():
        return int(v)
    if effective_process_count() == 1:
        return 1
    from .dataplane import allgather_pyobj
    names = allgather_pyobj(socket.gethostname())
    return names.count(socket.gethostname())


def require_inner_block_local(axes: dict):
    """Multi-host locality rule shared by fit()/fitStream()/transform():
    the inner parallel block (product of the non-data axes) must divide
    the ranks on this host, so every seq/expert/model/pipe collective
    stays on one host's NVLink while only the dp all-reduce crosses
    hosts."""
    inner = int(np.prod([max(1, v) for v in axes.values()]))
    if inner <= 1:
        return
    n_local = _local_device_count()
    if inner > n_local or n_local % inner != 0:
        desc = "*".join(f"{nm}={v}" for nm, v in axes.items() if v > 1)
        raise ValueError(
            f"the inner parallel block ({desc} = {inner}) must divide the "
            f"LOCAL device count ({n_local}) on a multi-host mesh: "
            f"seq/expert/model/pipe axes must ride NVLink within a host "
            f"while dp crosses hosts")


def _divisible(shape, spec: P, mesh: Mesh) -> bool:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        size = int(np.prod([mesh.axis_size(a) for a in axes]))
        if shape[dim] % size != 0:
            return False
    return True


def spec_for(path: str, shape, mesh: Mesh, rules: Sequence = (),
             default: Optional[P] = None) -> P:
    """The partition spec of one flax leaf (``/``-joined path, its shape):
    the first rule whose substring is in the path, whose spec is no longer
    than the leaf's rank and whose axes divide the leaf; else ``default``
    (replicated)."""
    spec = default if default is not None else P()
    for sub, candidate in rules:
        if (sub in path and len(candidate) <= len(shape)
                and _divisible(shape, candidate, mesh)):
            return candidate
    return spec


def _flax_leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_leaves(v, f"{pre}{k}/")
        else:
            yield pre + k, v


def param_specs(params, mesh: Mesh, rules: Sequence = (),
                default: Optional[P] = None, config: Optional[dict] = None
                ) -> dict:
    """Each leaf's partition spec under ``rules``. A flax tree (nested
    dicts, with or without its ``params`` level) maps each ``/``-joined
    path to its spec in the flax layout. A port state_dict needs
    ``config``: each key maps to its spec in the TORCH layout (a Dense
    kernel (in, out) is the weight (out, in), so its column split is a
    split of dim 0), found through ``weights.flax_map``."""
    if any(isinstance(v, dict) for v in params.values()):
        p = params.get("params", params)
        return {path: spec_for(path, np.shape(leaf), mesh, rules, default)
                for path, leaf in _flax_leaves(p)}
    if config is None:
        raise ValueError("param_specs of a state_dict needs its config")
    from ..models.weights import flax_map
    out = {}
    for e in flax_map(config):
        if e.key not in params:
            continue
        shape = tuple(params[e.key].shape)
        if e.kind == "dense":
            fshape = shape[::-1]
            s = spec_for(e.paths[0], fshape, mesh, rules, default)
            out[e.key] = P(*reversed(tuple(s) + (None,) * (2 - len(s))))
        elif e.kind == "copy" and e.paths:
            out[e.key] = spec_for(e.paths[0], shape, mesh, rules, default)
        else:
            out[e.key] = default if default is not None else P()
    return out


def _local_slice(t, spec: P, mesh: Mesh):
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.axis_size(axis)
        per = t.shape[dim] // n
        i = mesh.axis_index(axis)
        t = t.narrow(dim, i * per, per)
    return t


def shard_params_tp(params, mesh: Mesh, rules: Sequence = (),
                    default: Optional[P] = None,
                    config: Optional[dict] = None) -> dict:
    """Apply tensor-parallel placement to params by path substring:
    ``rules`` [(path_substring, P)] — first match wins, unmatched leaves
    replicate. Returns THIS rank's slice of every leaf (a tensor on the
    mesh's device), in the layout it was given: a flax tree stays a flax
    tree, a state_dict (with ``config``) stays a state_dict."""
    specs = param_specs(params, mesh, rules, default, config)
    if any(isinstance(v, dict) for v in params.values()):
        has_top = "params" in params
        p = params.get("params", params)
        out: dict = {}
        for path, leaf in _flax_leaves(p):
            t = _local_slice(torch.as_tensor(np.asarray(leaf)), specs[path],
                             mesh).contiguous().to(mesh.device)
            node = out
            parts = path.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = t
        return {"params": out} if has_top else out
    return {k: _local_slice(torch.as_tensor(v), specs.get(k, P()), mesh)
            .contiguous().to(mesh.device) for k, v in params.items()}
