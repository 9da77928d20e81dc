"""Mixed-precision training state: dynamic loss scaling for bf16 compute.

The port of ``mmlspark_tpu/models/precision.py``, its loss-scale gauge and
skipped-steps counter included. The model
runs its matmuls in bfloat16 over float32 master params (models/modules.py);
``TorchLearner(precision="bf16_mixed")`` adds the dynamic-loss-scale
recurrence:

  * the loss is multiplied by ``scale`` BEFORE the backward pass, so small
    gradients ride up into bf16's well-conditioned range;
  * gradients are unscaled (and optionally global-norm clipped) before the
    optimizer update;
  * a step whose unscaled gradients contain a non-finite value is SKIPPED:
    params and optimizer state keep their old values, ``scale`` backs off by
    ``BACKOFF_FACTOR``, and the skip is counted;
  * after ``GROWTH_INTERVAL`` consecutive finite steps the scale grows by
    ``GROWTH_FACTOR`` (capped).

The recurrence lives in :class:`ScaleState`, three 0-d tensors on the
training device. The skip is a selection made on the device
(``torch.where`` over a 0-d bool), never a host branch, so a step never
waits for the card; the host reads the state only at epoch ends.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import telemetry

#: trainer precision modes (the ``TorchLearner.precision`` param domain)
MODES = ("f32", "bf16", "bf16_mixed")

DEFAULT_INIT_SCALE = 2.0 ** 15
GROWTH_INTERVAL = 2000      # finite steps before the scale doubles
GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5
MIN_SCALE = 1.0
MAX_SCALE = 2.0 ** 24       # leaves f32 headroom above any sane loss

_m_loss_scale = telemetry.registry.gauge(
    "mmlspark_trainer_loss_scale",
    "current dynamic loss scale of a precision='bf16_mixed' fit "
    "(observed at epoch boundaries — the step itself never syncs)")
_m_skipped_steps = telemetry.registry.counter(
    "mmlspark_trainer_skipped_steps",
    "optimizer steps skipped by the dynamic loss scaler because the "
    "unscaled gradients contained a non-finite value (each skip also "
    "backs the scale off)")


class ScaleState(NamedTuple):
    """Dynamic-loss-scale recurrence state: three 0-d device tensors.

    scale:   float32 — current loss multiplier
    growth:  int32 — consecutive finite steps since the last scale move
    skipped: int32 — cumulative skipped steps this fit
    """
    scale: torch.Tensor
    growth: torch.Tensor
    skipped: torch.Tensor


def init_scale_state(init_scale: float = DEFAULT_INIT_SCALE,
                     device="cpu") -> ScaleState:
    return ScaleState(torch.tensor(init_scale, dtype=torch.float32,
                                   device=device),
                      torch.tensor(0, dtype=torch.int32, device=device),
                      torch.tensor(0, dtype=torch.int32, device=device))


def scale_state_to_host(state: ScaleState) -> dict:
    """JSON-able host form (reads the device)."""
    return {"scale": float(state.scale.item()),
            "growth": int(state.growth.item()),
            "skipped": int(state.skipped.item())}


def scale_state_from_host(d: dict, device="cpu") -> ScaleState:
    return ScaleState(torch.tensor(d["scale"], dtype=torch.float32,
                                   device=device),
                      torch.tensor(d["growth"], dtype=torch.int32,
                                   device=device),
                      torch.tensor(d["skipped"], dtype=torch.int32,
                                   device=device))


def all_finite(grads: dict) -> torch.Tensor:
    """0-d bool on the grads' device: every value of every tensor is
    finite."""
    return torch.stack([torch.isfinite(g).all() for g in grads.values()]
                       ).all()


def clip_by_global_norm(grads: dict, max_norm: float, dist=None) -> dict:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm`` (a
    no-op factor of 1 when already under). Runs AFTER unscaling under
    bf16_mixed, so the clip threshold is in true gradient units. With a
    ``dist`` plan (parallel/plan.py) the norm adds the shards' parts."""
    sq = (dist.sq_norm(grads) if dist is not None
          else sum(torch.sum(torch.square(g)) for g in grads.values()))
    norm = torch.sqrt(sq)
    factor = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return {k: g * factor for k, g in grads.items()}


def update_scale(state: ScaleState, finite: torch.Tensor) -> ScaleState:
    """One recurrence step: grow on sustained stability, back off on a
    non-finite step, count the skip."""
    grown = finite & (state.growth + 1 >= GROWTH_INTERVAL)
    new_scale = torch.where(
        finite,
        torch.where(grown,
                    torch.clamp_max(state.scale * GROWTH_FACTOR, MAX_SCALE),
                    state.scale),
        torch.clamp_min(state.scale * BACKOFF_FACTOR, MIN_SCALE))
    zero = torch.zeros_like(state.growth)
    growth = torch.where(finite & ~grown, state.growth + 1, zero)
    skipped = state.skipped + torch.where(finite, zero, zero + 1)
    return ScaleState(new_scale.to(torch.float32), growth.to(torch.int32),
                      skipped.to(torch.int32))


def tree_where(cond: torch.Tensor, new, old):
    """Elementwise ``torch.where(cond, new, old)`` over matching (nested)
    dicts of tensors: the device-side selection of a skipped step."""
    if isinstance(new, dict):
        return {k: tree_where(cond, new[k], old[k]) for k in new}
    return torch.where(cond, new, old)


def value_and_grad(fn, params: dict, *args, scale=None,
                   allow_unused: bool = False):
    """(fn(params, *args), its gradient w.r.t. ``params``) for a scalar
    ``fn`` of a dict of tensors; the gradients come back as a dict of the
    same keys. With ``scale`` the backward starts from ``fn * scale`` (the
    value returned stays unscaled). ``allow_unused``: a parameter the
    forward never touched (another pipeline stage's) gets zeros."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        out = fn(leaves, *args)
        grads = torch.autograd.grad(out if scale is None else out * scale,
                                    list(leaves.values()),
                                    allow_unused=allow_unused,
                                    materialize_grads=allow_unused)
    return out.detach(), dict(zip(leaves, grads))


def make_mixed_step_body(compute_loss, tx, grad_clip: float = 0.0,
                         dist=None):
    """The fused bf16_mixed optimizer step:
    scale -> grad -> unscale -> clip -> update.

    ``compute_loss(params, xb, yb, wb) -> () float32`` is the trainer's loss
    closure (the model casts itself to its compute dtype). Returns a body
    with signature::

        (params, opt_state, scale_state, xb, yb, wb)
            -> (params, opt_state, scale_state, loss)

    where ``loss`` is the UNSCALED value. A non-finite-gradient step
    returns the ORIGINAL params/opt_state values (the update is selected
    away elementwise), so a skipped step costs one wasted backward, never a
    corrupted model.

    ``dist`` (a ``parallel.plan.ParallelPlan`` adapter) sums the gradients
    over the ranks (``sync_grads``) before the unscale, makes the global
    loss (``loss``) and the shared finiteness flag (``all_finite``), and
    takes the clip's norm over the shards.
    """

    def step_body(params, opt_state, scale_state, xb, yb, wb):
        scale = scale_state.scale
        loss, grads = value_and_grad(compute_loss, params, xb, yb, wb,
                                     scale=scale)
        if dist is not None:
            grads = dist.sync_grads(grads)
            loss = dist.loss(loss)
        inv = 1.0 / scale
        grads = {k: g * inv for k, g in grads.items()}
        finite = all_finite(grads)
        if dist is not None:
            finite = dist.all_finite(finite)
        if grad_clip > 0.0:
            grads = clip_by_global_norm(grads, grad_clip, dist)
        # the update runs unconditionally; a skipped step selects the OLD
        # values back on the device (no host branch, no sync)
        safe = {k: torch.where(finite, g, torch.zeros_like(g))
                for k, g in grads.items()}
        updates, new_opt = tx.update(safe, opt_state, params)
        new_params = apply_updates(params, updates)
        return (tree_where(finite, new_params, params),
                tree_where(finite, new_opt, opt_state),
                update_scale(scale_state, finite), loss)

    return step_body


def apply_updates(params: dict, updates: dict) -> dict:
    """``optax.apply_updates``: p + u, in p's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def observe_scale_state(state, prev_skipped: int) -> int:
    """Epoch-boundary telemetry flush: set the loss-scale gauge, count
    newly skipped steps, return the new cumulative skip count. It reads
    the device only while telemetry is on — the per-step loop never
    waits on the scale state."""
    if state is None:
        return prev_skipped
    if telemetry.enabled():
        host = scale_state_to_host(state)
        _m_loss_scale.set(host["scale"])
        if host["skipped"] > prev_skipped:
            _m_skipped_steps.inc(host["skipped"] - prev_skipped)
        return host["skipped"]
    return prev_skipped
