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
    :class:`AsyncCheckpointWriter`, in the JAX package's file format.

All report through :mod:`mmlspark_tpu_torch.telemetry` under the JAX
package's metric names. Not ported here: ``elastic``, ``autoscale``,
``reconciler`` and ``supervisor`` (ROADMAP.md Queue 1 item 13b).
"""

from __future__ import annotations

from . import ckpt, faults, policy
from .ckpt import AsyncCheckpointWriter
from .faults import InjectedFault
from .policy import BreakerOpen, CircuitBreaker, RetryPolicy

__all__ = ["ckpt", "faults", "policy", "AsyncCheckpointWriter",
           "InjectedFault", "BreakerOpen", "CircuitBreaker", "RetryPolicy"]
