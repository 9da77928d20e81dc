"""Resilience of the PyTorch port: shared retry and circuit-breaking
policies, deterministic fault injection and checkpoints.

The port of the three jax-free pillars of ``mmlspark_tpu/resilience``:

  * :mod:`policy` — :class:`RetryPolicy` (exponential backoff, full
    jitter, deadline budget, transient-vs-fatal error classification) and
    :class:`CircuitBreaker` (closed/open/half-open, per target);
  * :mod:`faults` — seeded, env-gated fault injection
    (``MMLSPARK_TPU_FAULTS``, the JAX package's variable and grammar) at
    named sites in the real code paths (``trainer.step``, ``ckpt.write``,
    ``ckpt.rename``, ``ckpt.shard``);
  * :mod:`ckpt` — the checkpoint commit protocol (tmp write, fsync,
    atomic rename, manifest last), sharded checkpoints and
    :class:`AsyncCheckpointWriter`, in the JAX package's file format;
  * :mod:`elastic` — elastic training: :class:`HostHeartbeat`,
    :class:`TrainSupervisor` (death, grow and evict verdicts over
    heartbeat files) and :class:`ElasticFitCoordinator` (re-mesh over the
    surviving hosts + consensus-checkpoint resume — a fit survives a
    preempted host).

All report through :mod:`mmlspark_tpu_torch.telemetry` under the JAX
package's metric names. Not ported here: ``autoscale``, ``reconciler``
and ``supervisor``, the serving fleet (ROADMAP.md Queue 1 item 13b,
part 2).
"""

from __future__ import annotations

from . import ckpt, elastic, faults, policy
from .ckpt import AsyncCheckpointWriter
from .elastic import (ElasticFitCoordinator, ElasticFleetLost, HostEvictError,
                      HostHeartbeat, HostLossError, HostRejoinError,
                      TrainSupervisor)
from .faults import InjectedFault
from .policy import BreakerOpen, CircuitBreaker, RetryPolicy

__all__ = ["ckpt", "elastic", "faults", "policy", "AsyncCheckpointWriter",
           "ElasticFitCoordinator", "ElasticFleetLost", "HostEvictError",
           "HostHeartbeat", "HostLossError", "HostRejoinError",
           "TrainSupervisor", "InjectedFault", "BreakerOpen",
           "CircuitBreaker", "RetryPolicy"]
