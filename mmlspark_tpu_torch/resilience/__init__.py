"""Resilience of the PyTorch port: shared retry and circuit-breaking
policies and deterministic fault injection.

The port of the two jax-free pillars of ``mmlspark_tpu/resilience``:

  * :mod:`policy` — :class:`RetryPolicy` (exponential backoff, full
    jitter, deadline budget, transient-vs-fatal error classification) and
    :class:`CircuitBreaker` (closed/open/half-open, per target);
  * :mod:`faults` — seeded, env-gated fault injection
    (``MMLSPARK_TPU_FAULTS``, the JAX package's variable and grammar) at
    named sites in the real code paths; the trainer's ``trainer.step``
    site is the first the port threads through.

Both report through :mod:`mmlspark_tpu_torch.telemetry` under the JAX
package's metric names. Not ported here: ``ckpt`` (ROADMAP.md Queue 1
item 4), and ``elastic``, ``autoscale``, ``reconciler`` and
``supervisor`` (item 13b).
"""

from __future__ import annotations

from . import faults, policy
from .faults import InjectedFault
from .policy import BreakerOpen, CircuitBreaker, RetryPolicy

__all__ = ["faults", "policy", "InjectedFault", "BreakerOpen",
           "CircuitBreaker", "RetryPolicy"]
