"""TorchLearner: training as an Estimator, on one CUDA device.

The port of ``mmlspark_tpu/models/trainer.py``'s ``TpuLearner`` (the
CNTKLearner analog, reference: cntk-train/.../CNTKLearner.scala:84-175):
a declarative model config, a DataFrame of features and labels, and an
optimizer step per batch. ``fit`` returns a :class:`TorchModel` that
``transform`` serves.

The math follows the JAX package so the two packages train the same way
from the same weights: optax's update rules (not ``torch.optim``'s),
float32 master params under bf16 compute (models/modules.py), the weighted
mean loss, the dynamic loss scaler of ``precision="bf16_mixed"``
(models/precision.py), and the same numpy draws in the same order for
every shuffle. Two paths, as in the JAX package:

* the **scan path** (``_run_epochs_scan``), taken whenever the epoch's data
  fits ``deviceDataCap``: the epoch lives on the device with a bs-row wrap
  margin, and each step slices a window of it. Small datasets re-upload a
  fresh permutation every epoch; larger ones permute once at upload and
  vary each epoch by a rotation plus a random window order. The steps are
  eager, and their state stays on the device;
* the **feed path** (``_run_epochs``), for data larger than the cap: each
  step's rows are gathered on the host, staged in pinned memory and copied
  without blocking, ``prefetchDepth`` steps ahead (parallel/prefetch.py).

Neither path waits for the card inside an epoch: the loss is read on the
host once per epoch, and a skipped bf16_mixed step is selected away on the
device. It runs on ``device`` ("cuda" by default) and raises where there
is no card; the tests ask for "cpu".

Telemetry, under the JAX package's names (nothing is measured while it is
off): the spans ``fit``, ``fit/epoch``, ``fit/step`` (one per dispatch:
a window of ``stepsPerDispatch`` steps on the scan path, one step on the
feed path), ``fit/upload`` and ``fit/prefetch``; the step-time histogram,
rows/s gauge, new-signature counter and transfer-bytes counter; the
loss-scale gauge and skipped-steps counter of bf16_mixed. Each dispatch
runs under ``_STEP_RETRY``, retried once on a transient error, with the
``trainer.step`` fault site as its first statement. ``profile=True``
routes each dispatch through ``telemetry.profiler`` and ``sloConfig``
evaluates SLOs over the fit's step times.

Checkpoints (``checkpointDir``) are the JAX package's files, so a
directory moves between the packages: ``ckpt_EEEEE.msgpack`` marks epoch E
complete, ``ckpt_EEEEE_sSSSSSSS.msgpack`` (``checkpointEverySteps``) step S
of epoch E, each holding ``{"params", "opt", "scale"?}`` in flax msgpack:
the f32 master params in the flax tree layout, the optimizer state in the
layout ``flax.serialization.to_state_dict`` gives optax's, and the
bf16_mixed loss-scale state. Files commit through ``resilience.ckpt``
(manifest last; ``checkpointShards`` splits them, ``asyncCheckpoint``
publishes them from a writer thread). A refit on the same directory
resumes from the newest verified checkpoint, replaying the completed
epochs' shuffle draws, so a killed fit resumed from an epoch checkpoint,
or on the feed path from a step checkpoint, computes the uninterrupted
fit's steps bit for bit. ``fitStream`` trains from a fresh iterator of
batches each epoch (out-of-core: ``io.loader.device_image_batches``,
``io.arrow.arrow_feature_batches`` or any generator).

Fit-side pipeline fusion (core/capture.py): ``Pipeline(...,
fusePipeline=True).fit`` hands the learner a capture plan of its featurize
prefix (``_fit_captured``), and ``fitStreamCaptured`` takes one with a
stream of raw batches. The learner then uploads the RAW wire-dtype columns
(uint8 pixels ship as bytes, not as float32) on every path — scan, feed
(with or without prefetch) and stream — and featurizes each step's batch
on the device through one program per batch signature (one CUDA graph on
a card: ``trainer.featurize``), ahead of the eager training step; each
fused step counts on ``mmlspark_fit_fused_dispatches_total``. Its
checkpoints record the plan's ``featurize_digest`` in the manifest, and a
resume skips a checkpoint written under another plan.

Distributed fits (``parallel/``): under a process group
(``parallel.distributed.initialize``) each rank passes its own shard of
the rows and ``batchSize`` is the global batch, as in the JAX package's
multi-process fit; the ranks take the feed path in lockstep, and
``tensorParallel``, ``sequenceParallel`` (``spMode`` ring|ulysses),
``expertParallel`` (MoE) and ``pipelineParallel`` split the model over a
mesh of the world's ranks with the JAX package's checks and errors
(``_parallel_setup``; one rank with any of them at 2 raises its
``ValueError``). ``parallel/plan.py`` holds the collectives; the
fitted model's params are the whole tree on every rank. With no process
group a fit is the one-device fit. MoE transformers (``num_experts > 0``)
train with their row mask and ``moeAuxWeight``.

Elastic training (``elastic=True``, resilience/elastic.py): heartbeats
and a TrainSupervisor declare a dead host within the grace window, the fit
re-meshes over the survivors and re-enters from the latest ``(epoch,
step)`` consensus checkpoint, losing no committed step; a relaunched host
grows the mesh back, and a sustained straggler is evicted, at a checkpoint
boundary. ``elasticHosts > 1`` in one process makes simulated failure
domains over the process's one device; under ``parallel.distributed
.elastic_initialize`` the ranks re-rendezvous into a new process group. An
elastic fit takes the per-step feed path (the host checks each step), and
each step passes ``check_step`` before its device work and
``step_committed`` after it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.env import resolve_device
from ..core.params import (BooleanParam, DictParam, FloatParam, IntParam,
                           ListParam, StringParam)
from ..core.pipeline import Estimator
from ..core.utils import get_logger
from .. import telemetry
from ..resilience import faults
from ..resilience.policy import RetryPolicy
from . import precision as prec
from .modules import (TOKEN_MODELS, Conv2d, Dense, Embed, FrozenAffine,
                      GroupNorm, LayerNorm, build_model, sized_for)
from .moe import MoEMLP, read_moe_aux_loss
from .torch_model import (TorchModel, _next_pow2, _prep_input,
                          _token_matrix, full_precision_matmuls)
from .weights import from_flax_params, to_flax_params

log = get_logger("trainer")

# runtime telemetry (off-by-default no-ops; MMLSPARK_TPU_TELEMETRY=1)
_m_step_time = telemetry.registry.histogram(
    "mmlspark_trainer_step_seconds",
    "wall time per optimizer dispatch (one step on the feed path, a "
    "stepsPerDispatch window on the scan path)")
_m_rows_per_sec = telemetry.registry.gauge(
    "mmlspark_trainer_rows_per_sec",
    "training throughput over the last epoch (rows == imgs for image fits)")
_m_recompiles = telemetry.registry.counter(
    "mmlspark_trainer_recompiles",
    "train-step dispatches whose abstract (shape, dtype) signature was "
    "not seen before in this process")
_m_transfer_bytes = telemetry.registry.counter(
    "mmlspark_trainer_transfer_bytes",
    "host->device bytes shipped by the trainer (epoch uploads + per-step "
    "batch feeds)")

#: abstract-shape signatures already dispatched (new-signature detection)
_seen_step_sigs: set = set()

#: retry-once-on-transient around each dispatched optimizer step (injected
#: ``trainer.step`` faults, transient device or transport errors). The
#: injection site fires BEFORE the step, and the step computes its new
#: params and optimizer state out of place, so a retried attempt starts
#: from the unchanged old ones; a fatal error (bad model code) classifies
#: non-transient and raises at once.
_STEP_RETRY = RetryPolicy(name="trainer.step", max_attempts=2,
                          base_delay=0.05, max_delay=0.25)


def _params_digest(params, cfg: Optional[dict] = None) -> str:
    """sha256 over the bytes of every leaf of a flax-layout params tree, in
    jax's leaf order (sorted keys): the elastic coordinator's bit-exact
    resume evidence, equal to the JAX package's digest of the same values.
    ``params`` is that tree (a checkpoint's ``"params"``), or the port's
    state_dict with its sized ``cfg``."""
    import hashlib
    h = hashlib.sha256()

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            h.update(np.ascontiguousarray(node, np.float32).tobytes())
    walk(to_flax_params(params, cfg) if cfg is not None else params)
    return h.hexdigest()


def _note_step_signature(tag: str, *arrays):
    """Count a new signature when this (tag, shapes, dtypes) is unseen —
    the key a compiled step would be cached on, observed host-side."""
    sig = (tag,) + tuple((tuple(np.shape(a)), str(getattr(a, "dtype",
                                                          type(a))))
                         for a in arrays)
    if sig not in _seen_step_sigs:
        _seen_step_sigs.add(sig)
        _m_recompiles.inc()


# ---------------------------------------------------------------- optimizers

class Optimizer(NamedTuple):
    """optax's GradientTransformation shape over dicts of tensors:
    ``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``; apply the updates with ``precision.apply_updates``.
    Updates are computed out of place, so a skipped step can select the
    old values back."""
    init: Callable
    update: Callable


def _zeros_like(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _scale_by_lr(lr: float, updates: dict) -> dict:
    """optax.scale_by_learning_rate: u * -lr."""
    return {k: u * -lr for k, u in updates.items()}


def _sgd(lr: float) -> Optimizer:
    return Optimizer(lambda params: {},
                     lambda g, state, params=None: (_scale_by_lr(lr, g),
                                                    state))


def _momentum(lr: float, mu: float) -> Optimizer:
    """optax.sgd(lr, momentum=mu): trace t = g + mu * t, then -lr * t (no
    dampening, no Nesterov)."""
    def update(g, state, params=None):
        trace = {k: g[k] + mu * state["trace"][k] for k in g}
        return _scale_by_lr(lr, trace), {"trace": trace}
    return Optimizer(lambda params: {"trace": _zeros_like(params)}, update)


def _adam_direction(g: dict, state: dict, b1=0.9, b2=0.999, eps=1e-8):
    """optax.scale_by_adam (eps outside the sqrt, eps_root 0): the moments,
    bias-corrected by the 1-based step count, and m_hat / (sqrt(v_hat) +
    eps)."""
    mu = {k: (1 - b1) * g[k] + b1 * state["mu"][k] for k in g}
    nu = {k: (1 - b2) * (g[k] * g[k]) + b2 * state["nu"][k] for k in g}
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=c.device), c)
    u = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) for k in g}
    return u, {"count": count, "mu": mu, "nu": nu}


def _adam_init(params: dict) -> dict:
    dev = next(iter(params.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": _zeros_like(params), "nu": _zeros_like(params)}


def _adam(lr: float) -> Optimizer:
    def update(g, state, params=None):
        u, state = _adam_direction(g, state)
        return _scale_by_lr(lr, u), state
    return Optimizer(_adam_init, update)


def _adamw(lr: float, wd: float) -> Optimizer:
    """optax.adamw: the adam direction plus wd * p (the old params), times
    -lr."""
    def update(g, state, params):
        u, state = _adam_direction(g, state)
        return _scale_by_lr(lr, {k: u[k] + wd * params[k] for k in u}), state
    return Optimizer(_adam_init, update)


def _with_decayed_weights(wd: float, tx: Optimizer) -> Optimizer:
    """optax.chain(add_decayed_weights(wd), tx): g + wd * p first."""
    def update(g, state, params):
        return tx.update({k: g[k] + wd * params[k] for k in g}, state,
                         params)
    return Optimizer(tx.init, update)


def make_optimizer(name: str, lr: float, momentum: float = 0.9,
                   weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        tx = _sgd(lr)
    elif name == "momentum":
        tx = _momentum(lr, momentum)
    elif name == "adam":
        tx = _adam(lr)
    elif name == "adamw":
        tx = _adamw(lr, weight_decay)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if weight_decay and name != "adamw":
        tx = _with_decayed_weights(weight_decay, tx)
    return tx


def make_loss(name: str, per_example: bool = False):
    """Loss on (preds, labels); per_example=True returns the (n,) vector so
    callers can weight out padding rows."""
    if name == "cross_entropy":
        def vec(logits, labels):
            picked = logits.gather(-1, labels.long().unsqueeze(-1))
            return torch.logsumexp(logits, dim=-1) - picked.squeeze(-1)
    elif name == "mse":
        def vec(preds, labels):
            if preds.dim() > labels.dim():
                preds = preds.squeeze(-1)
            return (preds - labels.to(preds.dtype)) ** 2
    else:
        raise ValueError(f"unknown loss {name!r}")
    if per_example:
        return vec
    return lambda p, l: vec(p, l).mean()


# ------------------------------------------------------------ step bodies

def _bind(module, params: dict):
    """Point the module's parameter slots at ``params``. They stay bound
    after the call returns: a checkpointed block recomputes its forward
    during the backward and must read the same tensors."""
    for name, t in params.items():
        owner, _, attr = name.rpartition(".")
        module.get_submodule(owner)._parameters[attr] = t


def _make_loss_compute(module, loss_fn, is_moe: bool = False,
                       moe_aux: float = 0.0, plan=None, forward=None):
    """The weighted scalar loss of one batch: the one forward every
    precision mode and path shares. The model casts itself to its compute
    dtype; the loss reduction stays f32, and rows of weight 0 carry no
    gradient. MoE routing sees the row weights too (padding claims no
    expert capacity), and ``moe_aux > 0`` adds the blocks' aux losses.

    With a ``plan`` (a distributed fit) the denominator is the GLOBAL
    weight sum, so summing the ranks' gradients gives the global mean's;
    each call leaves its ``(main, aux)`` parts in ``compute.last`` for the
    global loss. ``forward(params, xb)`` replaces the module's forward
    (the pipeline)."""

    def compute(params, xb, yb, wb):
        _bind(module, params)
        aux = [] if moe_aux > 0.0 else None
        if forward is not None:
            preds = forward(params, xb)
        elif is_moe:
            preds = module(xb, row_mask=wb, moe_aux=aux)
        else:
            preds = module(xb)
        losses = loss_fn(preds, yb)
        denom = torch.sum(wb) if plan is None else plan.denominator(wb)
        main = torch.sum(losses * wb) / torch.clamp_min(denom, 1.0)
        a = None if not aux else moe_aux * read_moe_aux_loss(aux)
        compute.last = (main, a)
        return main if a is None else main + a

    return compute


class _StepDist:
    """The step bodies' view of a distributed fit's plan: gradient sums,
    the global loss from the last forward's parts, the shared finiteness
    flag and the sharded norm."""

    def __init__(self, plan, compute):
        self.plan, self.compute = plan, compute
        self.sync_grads = plan.sync_grads
        self.all_finite = plan.all_finite
        self.sq_norm = plan.sq_norm

    def loss(self, _local):
        return self.plan.reduce_loss(*self.compute.last)


def _make_step_body(module, tx, loss_fn, grad_clip: float = 0.0,
                    is_moe: bool = False, moe_aux: float = 0.0, plan=None,
                    forward=None):
    """One optimizer step: loss -> grads -> (sum over the ranks) -> (clip)
    -> update, returning ``(params, opt_state, loss)``."""
    compute = _make_loss_compute(module, loss_fn, is_moe, moe_aux, plan,
                                 forward)
    dist = None if plan is None else _StepDist(plan, compute)
    pipelined = forward is not None

    def step_body(params, opt_state, xb, yb, wb):
        loss, grads = prec.value_and_grad(compute, params, xb, yb, wb,
                                          allow_unused=pipelined)
        if dist is not None:
            grads = dist.sync_grads(grads)
            loss = dist.loss(loss)
        # the pipeline step clips nothing, as the JAX package's pp body
        if grad_clip > 0.0 and not pipelined:
            grads = prec.clip_by_global_norm(grads, grad_clip, dist)
        updates, opt2 = tx.update(grads, opt_state, params)
        return prec.apply_updates(params, updates), opt2, loss

    return step_body


def _make_mixed_step_body(module, tx, loss_fn, grad_clip: float = 0.0,
                          is_moe: bool = False, moe_aux: float = 0.0,
                          plan=None):
    """bf16_mixed twin of _make_step_body, threading a ScaleState:
    ``(params, opt_state, scale_state, xb, yb, wb) ->
    (params, opt_state, scale_state, loss)``."""
    compute = _make_loss_compute(module, loss_fn, is_moe, moe_aux, plan)
    return prec.make_mixed_step_body(
        compute, tx, grad_clip,
        None if plan is None else _StepDist(plan, compute))


# ----------------------------------------------------------------- init

# truncated-normal stddev correction for a (-2, 2) truncation (flax's
# variance_scaling "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, fan_in: int, gen) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at +-2 sigma, std
    sqrt(1/fan_in) / .8796."""
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w * ((1.0 / fan_in) ** 0.5 / _TRUNC_STD)


def init_params(cfg: dict, seed: int) -> dict:
    """A fresh state_dict (CPU float32) for ``cfg``, drawn from a
    ``torch.Generator`` seeded with ``seed`` with the distributions of the
    flax initializers: Dense and conv kernels lecun_normal (fan_in the
    input width, times kh·kw for a conv), biases 0, embeddings
    variance_scaling(1, "fan_in", "normal", out_axis=0) (std
    sqrt(1/d_model)), LayerNorm, GroupNorm and frozen-affine scale 1 and
    bias 0; an LSTM's input kernels lecun_normal, its recurrent kernels
    orthogonal for each gate's (H, H) matrix, its biases 0. The draws are
    not flax's bits; the parity tests carry the JAX init across instead."""
    with torch.device("meta"):
        module = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for mname, mod in module.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, Dense):
            d_out, d_in = mod.weight.shape
            sd[pre + "weight"] = _lecun_normal((d_out, d_in), d_in, gen)
            if mod.bias is not None:
                sd[pre + "bias"] = torch.zeros(d_out)
        elif isinstance(mod, Conv2d):
            c_out, c_in, kh, kw = mod.weight.shape
            sd[pre + "weight"] = _lecun_normal(mod.weight.shape,
                                               c_in * kh * kw, gen)
            if mod.bias is not None:
                sd[pre + "bias"] = torch.zeros(c_out)
        elif isinstance(mod, Embed):
            n, d = mod.weight.shape
            sd[pre + "weight"] = (torch.randn((n, d), generator=gen)
                                  * (1.0 / d) ** 0.5)
        elif isinstance(mod, (LayerNorm, GroupNorm, FrozenAffine)):
            d = mod.weight.shape[0]
            sd[pre + "weight"] = torch.ones(d)
            sd[pre + "bias"] = torch.zeros(d)
        elif isinstance(mod, MoEMLP):
            # flax's lecun_normal over a stacked (E, in, out) param counts
            # the leading axis in the fan-in (receptive field E)
            d, E = mod.gate.shape
            h = mod.expert_w1.shape[2]
            sd[pre + "gate"] = _lecun_normal((d, E), d, gen)
            sd[pre + "expert_w1"] = _lecun_normal((E, d, h), d * E, gen)
            sd[pre + "expert_b1"] = torch.zeros(E, h)
            sd[pre + "expert_w2"] = _lecun_normal((E, h, d), h * E, gen)
            sd[pre + "expert_b2"] = torch.zeros(E, d)
        elif isinstance(mod, torch.nn.LSTM):
            for name, p in mod.named_parameters():
                four_h = p.shape[0]
                if name.startswith("weight_ih"):
                    w = _lecun_normal(p.shape, p.shape[1], gen)
                elif name.startswith("weight_hh"):
                    w = torch.cat([torch.nn.init.orthogonal_(
                        torch.empty(four_h // 4, four_h // 4), generator=gen)
                        for _ in range(4)])
                else:
                    w = torch.zeros(four_h)
                sd[pre + name] = w
    return sd


# ----------------------------------------------------------- data helpers

# fit() keeps the epoch data device-resident (one upload, windowed batches)
# up to this many bytes; past it, the per-step host-feed path takes over.
# Derived from the card's memory (half of it leaves room for params and
# activations); the fallback is for the CPU. Overridable per fit via
# TorchLearner.deviceDataCap.
_DEVICE_DATA_CAP_FALLBACK = 8 << 30

# below this size the scan path re-uploads a freshly permuted epoch every
# epoch; above it, shuffling is upload-permutation + per-epoch rotation and
# window order. Overridable via TorchLearner.epochReshuffleCap.
_EPOCH_RESHUFFLE_CAP = 32 << 20


def _device_data_cap(dev: torch.device) -> int:
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1] // 2
    return _DEVICE_DATA_CAP_FALLBACK


def _wrap_rows(arr: np.ndarray, n_pad: int) -> np.ndarray:
    """Extend dim 0 to exactly ``n_pad`` rows by wrapping from the start
    (the pad rows are weighted out by the caller)."""
    if len(arr) == n_pad:
        return arr
    reps = -(-n_pad // max(1, len(arr)))
    return np.concatenate([arr] * reps, axis=0)[:n_pad]


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host rows -> ``dev``; to a card through pinned memory, without
    blocking the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


# ----------------------------------------------------------- stream batches

def _stream_batch(b, cfg: dict, loss_name: str):
    """One ``(features, labels)`` item of a ``fitStream`` generator, host
    numpy or tensors (a device feed's), normalised: token models take int32
    ids (range-checked, as ``fit`` does: a CUDA embedding lookup past the
    table faults the device), uint8 image batches stay uint8 (the device
    cast is free and bytes are 4x less host->device traffic), anything
    else float32; labels follow the loss dtype."""
    x, y = b
    token = cfg.get("type") in TOKEN_MODELS
    if isinstance(x, torch.Tensor):
        if token:
            x = x.to(torch.int32)
        elif x.dtype != torch.uint8:
            x = x.to(torch.float32)
    else:
        x = np.asarray(x)
        if token:
            x = x.astype(np.int32)
        elif x.dtype != np.uint8:
            x = x.astype(np.float32)
    ydt = ("int32" if loss_name == "cross_entropy" else "float32")
    y = (y.to(getattr(torch, ydt)) if isinstance(y, torch.Tensor)
         else np.asarray(y).astype(ydt))
    if len(x) != len(y):
        raise ValueError(f"batch features/labels length mismatch: "
                         f"{len(x)} vs {len(y)}")
    if token and len(x):
        vocab = cfg.get("vocab_size", 10000)
        lo, hi = int(x.min()), int(x.max())
        if lo < 0 or hi >= vocab:
            raise ValueError(f"token ids must lie in [0, {vocab}); got "
                             f"[{lo}, {hi}]")
    return x, y


def _np_dtype(name: str):
    """A numpy dtype from its str() (an agreed batch signature)."""
    return np.dtype(name.replace("torch.", ""))


def _pad_rows(a, rows: int):
    """Extend dim 0 to ``rows`` with zeros (pad rows carry weight 0; id 0
    lies in every vocabulary)."""
    n = len(a)
    if n == rows:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((rows - n,) + tuple(a.shape[1:]))])
    return np.concatenate([a, np.zeros((rows - n,) + a.shape[1:], a.dtype)])


def _placed(a, dev: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dev, non_blocking=True)
    return _to_device(a, dev)


# -------------------------------------------------------------- checkpoints

def _fmt_pos(pos: Optional[tuple]) -> str:
    """Human form of a checkpoint position tuple for error messages."""
    if pos is None:
        return "none"
    epoch, step = pos
    return (f"epoch {epoch}" if step is None
            else f"epoch {epoch} step {step}")


def _opt_state_dict(opt: dict, name: str, weight_decay: float,
                    cfg: dict) -> dict:
    """The port's optimizer state (CPU tensors) in the layout
    ``flax.serialization.to_state_dict`` gives optax's state of the same
    optimizer: a chain's members by index, ``EmptyState`` as ``{}``, the
    moments as flax param trees."""
    if name == "sgd":
        inner = {}
    elif name == "momentum":
        inner = {"trace": to_flax_params(opt["trace"], cfg)}
    else:
        inner = {"count": np.asarray(int(opt["count"]), np.int32),
                 "mu": to_flax_params(opt["mu"], cfg),
                 "nu": to_flax_params(opt["nu"], cfg)}
    st = {"0": inner, "1": {}}
    if name == "adamw":                     # scale_by_adam, wd, lr
        st["2"] = {}
    elif weight_decay:                      # chain(add_decayed_weights, tx)
        st = {"0": {}, "1": st}
    return st


def _opt_from_state_dict(st: dict, name: str, weight_decay: float,
                         cfg: dict, dev: torch.device) -> dict:
    """Inverse of :func:`_opt_state_dict`, onto ``dev``."""
    if weight_decay and name != "adamw":
        st = st["1"]
    inner = st["0"]

    def tensors(tree):
        return {k: v.to(dev) for k, v in from_flax_params(tree, cfg).items()}
    if name == "sgd":
        return {}
    if name == "momentum":
        return {"trace": tensors(inner["trace"])}
    return {"count": torch.tensor(int(np.asarray(inner["count"])),
                                  dtype=torch.int32, device=dev),
            "mu": tensors(inner["mu"]), "nu": tensors(inner["nu"])}


def _tensors_of(tree) -> list:
    """The tensors of a nest of dicts and tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors_of(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


def _rebuilt(tree, it):
    """``tree`` with its tensors replaced, in :func:`_tensors_of` order,
    by the items of ``it``."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuilt(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_rebuilt(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


class _Snapshot:
    """The training state ``(params, opt_state, scale_state)`` copied to
    host memory for a checkpoint.

    On a card the copy is enqueued on a side stream (``stream``) after an
    event recorded on the producing stream, so it starts once the step
    that made the tensors is done, without waiting for the card; it lands
    in pinned memory, and ``record_stream`` keeps the caching allocator
    from handing the source blocks to a later step before the copy has
    read them. Nothing overwrites them meanwhile: every step computes new
    tensors out of place (a skipped bf16_mixed step selects the old values
    into new tensors). :meth:`host` waits for the copy's own event. On the
    CPU the tensors themselves are the snapshot."""

    def __init__(self, state: tuple, stream=None):
        self._state = state
        tensors = _tensors_of(state)
        self._done = None
        if stream is None:
            self._host = [t.detach() for t in tensors]
            return
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(stream.device))
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
            self._done = torch.cuda.Event()
            self._done.record(stream)

    def host(self) -> tuple:
        """The state with host tensors in place of the device ones."""
        if self._done is not None:
            self._done.synchronize()
        return _rebuilt(self._state, iter(self._host))


class TorchLearner(Estimator):
    """Neural-net training (the port of ``TpuLearner``) on one device, or on
    every rank of a process group.

    Params mirror the JAX package's; ``device`` is the port's own (under a
    process group: the kind of the ranks' devices)."""

    featuresCol = StringParam("features column (token ids for the "
                              "transformer)", default="features")
    labelCol = StringParam("label column", default="label")
    modelConfig = DictParam("declarative model config", default=None)
    inputShape = ListParam("CHW shape for flat-vector features", default=())
    optimizer = StringParam("sgd|momentum|adam|adamw", default="momentum",
                            choices=("sgd", "momentum", "adam", "adamw"))
    learningRate = FloatParam("learning rate", default=0.01, min=0.0)
    momentum = FloatParam("momentum coefficient", default=0.9)
    weightDecay = FloatParam("weight decay", default=0.0)
    batchSize = IntParam("global batch size", default=256, min=1)
    epochs = IntParam("training epochs", default=5, min=1)
    loss = StringParam("cross_entropy|mse", default="cross_entropy",
                       choices=("cross_entropy", "mse"))
    seed = IntParam("seed of the init and of every shuffle", default=0)
    shuffle = BooleanParam("shuffle each epoch", default=True)
    checkpointDir = StringParam(
        "per-epoch checkpoint directory ('' = off); a refit on the same "
        "directory resumes from its newest verified checkpoint",
        default="")
    checkpointEverySteps = IntParam(
        "also checkpoint every N optimizer steps WITHIN an epoch (0 = "
        "epoch boundaries only). A killed fit resumes from the last step "
        "interval instead of the last epoch. Applies to the per-step "
        "feed and stream paths; the scan path resumes at epoch "
        "boundaries. Requires checkpointDir", default=0, min=0)
    asyncCheckpoint = BooleanParam(
        "publish checkpoints from a background writer thread "
        "(resilience/ckpt.py): the step loop only enqueues the copy of "
        "the state to pinned host memory; the wait for it, serialization, "
        "fsync, the atomic rename and the manifest commit overlap with the "
        "next steps (depth-1 queue, newest-wins coalescing, a barrier at "
        "each epoch end and at fit exit)", default=False)
    checkpointKeepSteps = IntParam(
        "step checkpoints retained per epoch (keep-last-K pruning as new "
        "ones commit; the epoch-final save clears the rest). The "
        "checkpoint the fit resumed from is never pruned", default=3,
        min=1)
    checkpointShards = IntParam(
        "split each checkpoint into this many byte-balanced shard files "
        "(0/1 = one msgpack), committed with a head file and the manifest "
        "last; a torn shard disqualifies the whole checkpoint and resume "
        "falls back to the previous one", default=0, min=0)
    tensorParallel = IntParam("size of the model (TP) mesh axis", default=1,
                              min=1)
    sequenceParallel = IntParam("size of the sequence (SP) mesh axis "
                                "(transformer only)", default=1, min=1)
    spMode = StringParam("sequence-parallel collective form", default="ring",
                         choices=("ring", "ulysses"))
    expertParallel = IntParam("size of the expert (EP) mesh axis (MoE "
                              "transformer only)", default=1, min=1)
    pipelineParallel = IntParam(
        "size of the pipeline (PP) mesh axis: the transformer's blocks "
        "split into this many GPipe stages", default=1, min=1)
    moeAuxWeight = FloatParam("weight of the MoE load-balancing aux loss",
                              default=0.01, min=0.0)
    precision = StringParam(
        "compute precision of the train step: 'bf16' (default) = bf16 "
        "activations/grads over f32 master weights; 'f32' = full-precision "
        "compute (TF32 off); 'bf16_mixed' = bf16 compute plus dynamic loss "
        "scaling — the loss is scaled before the backward, the grads "
        "unscaled (and optionally clipped), a step with non-finite grads is "
        "skipped on the device and backs the scale off, and the scale grows "
        "on sustained stability", default="bf16", choices=prec.MODES)
    gradClipNorm = FloatParam(
        "global-L2-norm gradient clip in the step (0 = off); under "
        "bf16_mixed it runs after unscaling", default=0.0, min=0.0)
    lossScaleInit = FloatParam(
        "initial dynamic loss scale for precision='bf16_mixed'",
        default=float(prec.DEFAULT_INIT_SCALE), min=1.0)
    haltOnNonFinite = BooleanParam(
        "raise when the epoch loss goes NaN/inf instead of training on "
        "garbage", default=True)
    stepsPerDispatch = IntParam(
        "optimizer steps per dispatch on the scan path (0 = whole epoch): "
        "the unit of the fit/step span, the step-time histogram, the "
        "retry and the profiler. The port's steps are eager launches, so "
        "every value trains alike", default=0, min=0)
    deviceDataCap = IntParam(
        "bytes of epoch data kept device-resident before the per-step "
        "host-feed path takes over; 0 = half the card's memory (8 GiB on "
        "the CPU)", default=0, min=0)
    epochReshuffleCap = IntParam(
        "datasets up to this many bytes re-upload a fresh permutation "
        "every epoch on the scan path; larger ones rotate + window-permute "
        "a once-permuted upload; 0 = the 32 MiB default", default=0, min=0)
    prefetchDepth = IntParam(
        "host batches prepared and copied ahead of the step consuming them "
        "(feed path). 2 = double buffering; 0 = synchronous. The loss "
        "trajectory is bit-identical either way", default=2, min=0)
    profile = BooleanParam(
        "device-profile this fit: FLOPs and bytes per dispatch (counted "
        "once for each new signature), achieved-FLOP/s and roofline "
        "gauges, and device memory sampling (telemetry.profiler). Enables "
        "telemetry and waits for each dispatch's stream — measurement "
        "mode, not the production default", default=False)
    elastic = BooleanParam(
        "run fit through the elastic training runtime "
        "(resilience/elastic.py): host heartbeats + a TrainSupervisor "
        "declare a dead/preempted host within the grace window, the fit "
        "re-meshes over the surviving hosts and resumes from the latest "
        "(epoch, step) consensus checkpoint — zero committed steps lost. "
        "Requires checkpointDir; forces the per-step feed path; composes "
        "with data(+tensor) parallelism only", default=False)
    elasticHosts = IntParam(
        "failure domains for elastic training: 0 = one host per process "
        "(the real host boundary); >1 in one process = this many "
        "simulated hosts over the process's device (chaos testing, "
        "rehearsal of the multi-host recovery path)", default=0, min=0)
    elasticMinHosts = IntParam(
        "survivors needed to keep training in-job after a host loss; "
        "below it the fit raises ElasticFleetLost (relaunch the fleet "
        "against the same checkpointDir to resume)", default=1, min=1)
    elasticGraceSeconds = FloatParam(
        "heartbeat age that turns silence into a death verdict; 0 = "
        "MMLSPARK_TPU_ELASTIC_GRACE or 2.0", default=0.0, min=0.0)
    elasticMaxFailures = IntParam(
        "transient fit failures tolerated WITHOUT a host verdict before "
        "the elastic loop gives up (failures attributed to a dead host "
        "re-mesh instead and do not burn this budget)", default=5, min=1)
    elasticMaxHosts = IntParam(
        "ceiling for in-job GROW: a relaunched host whose joining "
        "heartbeat earns a grow verdict re-enters the mesh at the next "
        "checkpoint boundary only while the pool is below this many "
        "hosts (0 = the launch fleet size). Shrink is unaffected",
        default=0, min=0)
    stragglerEvictAfter = IntParam(
        "promote a straggler verdict (rolling-MAD step-time anomaly, "
        "advisory by default) into a proactive EVICT after this many "
        "consecutive flagged supervisor passes: the slow host is "
        "dropped at the next committed checkpoint boundary — the same "
        "unwind path as a host loss, fired BEFORE the slow-then-dead "
        "host actually dies — and rejoins through the grow path once "
        "recovered. Floors: survivors must satisfy elasticMinHosts and "
        "the coordinator host is never evicted. 0 = advisory only",
        default=0, min=0)
    sloConfig = DictParam(
        "declarative SLO config evaluated DURING this fit "
        "(telemetry.slo): either a full {'objectives': [...], "
        "'interval': s} document, or the {'stepTimeBudget': seconds, "
        "'windows': [fast_s, slow_s]} shorthand for a mean-step-time "
        "objective over mmlspark_trainer_step_seconds. Enables telemetry "
        "and a time-series sampler for the fit; the final per-objective "
        "state lands on the learner as _last_slo_report", default=None)
    device = StringParam(
        "torch device to train on: 'cuda' (default), 'cuda:N' or 'cpu'. "
        "Asking for CUDA where there is none raises; nothing falls back",
        default="cuda")

    # ---- set-up ----
    def _elastic_coordinator(self):
        from ..resilience.elastic import ElasticFitCoordinator
        return ElasticFitCoordinator(
            self, n_hosts=self.getElasticHosts(),
            min_hosts=self.getElasticMinHosts(),
            grace=self.getElasticGraceSeconds() or None,
            max_failures=self.getElasticMaxFailures(),
            max_hosts=self.getElasticMaxHosts(),
            evict_after=self.getStragglerEvictAfter())

    def _elastic_setup(self, elastic_ctx):
        """Per-attempt elastic state: rendezvous-armed fleets route every
        checkpoint through the writer thread and bound its wait
        (_save_checkpoint, _ckpt_barrier); an elastic fit composes with
        data(+tensor) parallelism only."""
        self._elastic_multiproc = bool(
            elastic_ctx is not None
            and getattr(elastic_ctx._coord, "_multiproc", False))
        if elastic_ctx is not None and (self.getSequenceParallel() > 1
                                        or self.getExpertParallel() > 1
                                        or self.getPipelineParallel() > 1):
            raise ValueError(
                "elastic fit composes with data(+tensor) parallelism only "
                "(a seq/expert/pipe axis cannot shrink mid-run); run "
                "sp/ep/pp fits without elastic")

    def _report_resume(self, elastic_ctx, params):
        """Hand the coordinator the resumed position and the digest of the
        restored params (None on a fresh start): the bit-exact resume
        evidence. A distributed fit gathers the whole tree first (every
        rank resumes at the same point)."""
        if elastic_ctx is None:
            return
        pos = getattr(self, "_ckpt_floor", None)
        digest = None
        if pos is not None:
            if getattr(self, "_plan", None) is not None:
                params = self._plan.gather(params)
            digest = _params_digest(params, self._ckpt_cfg)
        elastic_ctx.resumed(pos, digest)

    def _fit_guard(self, par):
        """The collective-fit lock of a distributed fit. Elastic
        multi-process attempts run on abandonable threads: an orphaned
        attempt (pinned in a dead collective) may still hold the
        reentrant lock and can never issue a collective on the new group,
        so they skip it."""
        if par is None or getattr(self, "_elastic_multiproc", False):
            return contextlib.nullcontext()
        from ..parallel import mesh as meshlib
        return meshlib.collective_fit_lock

    def _parallel_setup(self, cfg: dict, seq_len: Optional[int],
                        dev: torch.device):
        """The JAX package's parallelism checks, in its order and with its
        errors, with the world size in the device count's place; then the
        mesh. Returns ``(mesh, attn_fn)``, or None with no process group
        (the one-device path). The ranks' device must be the fit's kind: a
        CUDA fit never runs through a gloo group."""
        from ..parallel import mesh as meshlib
        from ..parallel import sequence
        tp = self.getTensorParallel()
        sp = self.getSequenceParallel()
        ep = self.getExpertParallel()
        pp = self.getPipelineParallel()
        if self.getPrecision() == "bf16_mixed" and pp > 1:
            raise ValueError(
                "precision='bf16_mixed' composes with data/tensor/seq/"
                "expert parallelism; the pipeline step body does not "
                "thread the loss-scale state — run pipelineParallel fits "
                "with precision='bf16' or 'f32'")
        if sp > 1 and ep > 1:
            raise ValueError("sequenceParallel and expertParallel cannot both "
                             "exceed 1 (compose dp x sp or dp x ep meshes)")
        if pp > 1 and (sp > 1 or ep > 1 or tp > 1):
            raise ValueError("pipelineParallel currently composes with data "
                             "parallelism only (dp x pp mesh); run tp/sp/ep "
                             "without pp")
        n_dev = meshlib.effective_process_count()
        attn_fn = None
        if sp > 1:
            if cfg.get("type") != "transformer":
                raise ValueError("sequenceParallel>1 requires a transformer "
                                 f"model, got {cfg.get('type')!r}")
            if n_dev % (sp * tp) != 0 or sp * tp > n_dev:
                raise ValueError(
                    f"sequenceParallel*tensorParallel = {sp}*{tp} must divide "
                    f"the device count ({n_dev})")
            if seq_len % sp != 0:
                raise ValueError(
                    f"sequence length {seq_len} must be divisible by "
                    f"sequenceParallel ({sp})")
            mesh = meshlib.make_mesh({"data": n_dev // (sp * tp),
                                      "seq": sp, "model": tp})
            attn_fn = sequence.make_sp_attention(
                mesh, axis_name="seq", mode=self.getSpMode(),
                causal=cfg.get("causal", False))
        elif ep > 1:
            if cfg.get("type") != "transformer" or not cfg.get("num_experts"):
                raise ValueError("expertParallel>1 requires a transformer "
                                 "model with num_experts set")
            if cfg["num_experts"] % ep != 0:
                raise ValueError(f"num_experts ({cfg['num_experts']}) must be "
                                 f"divisible by expertParallel ({ep})")
            if n_dev % (ep * tp) != 0 or ep * tp > n_dev:
                raise ValueError(
                    f"expertParallel*tensorParallel = {ep}*{tp} must divide "
                    f"the device count ({n_dev})")
            mesh = meshlib.make_mesh({"data": n_dev // (ep * tp),
                                      "expert": ep, "model": tp})
        elif pp > 1:
            if cfg.get("type") != "transformer":
                raise ValueError("pipelineParallel>1 requires a transformer "
                                 f"model, got {cfg.get('type')!r}")
            if cfg.get("num_experts", 0) > 0:
                raise ValueError("pipelineParallel with MoE blocks is not "
                                 "supported (expert routing state does not "
                                 "pipeline); use expertParallel instead")
            if cfg.get("layers", 2) % pp != 0:
                raise ValueError(f"layers ({cfg.get('layers', 2)}) must be "
                                 f"divisible by pipelineParallel ({pp})")
            if n_dev % pp != 0:
                raise ValueError(f"pipelineParallel ({pp}) must divide the "
                                 f"device count ({n_dev})")
            if n_dev > 1:
                meshlib.require_inner_block_local({"pipelineParallel": pp})
            mesh = meshlib.make_mesh({"data": n_dev // pp, "pipe": pp})
        else:
            mesh = meshlib.create_mesh(model=tp)
        if n_dev > 1:
            meshlib.require_inner_block_local({"sequenceParallel": sp,
                                               "expertParallel": ep,
                                               "tensorParallel": tp})
        if not mesh.distributed:
            return None
        if mesh.device.type != dev.type:
            raise ValueError(
                f"the process group's ranks run on {mesh.device.type} but "
                f"this fit asks for device={self.getDevice()!r}: a "
                f"distributed fit runs on the group's devices")
        return mesh, attn_fn

    # ---- checkpointing ----
    # Two granularities, as in the JAX package: ``ckpt_EEEEE.msgpack``
    # marks epoch E COMPLETE; ``ckpt_EEEEE_sSSSSSSS.msgpack``
    # (checkpointEverySteps > 0) marks step S within epoch E done.
    def _ckpt_path(self, epoch: int, step: Optional[int] = None) -> str:
        name = (f"ckpt_{epoch:05d}.msgpack" if step is None
                else f"ckpt_{epoch:05d}_s{step:07d}.msgpack")
        return os.path.join(self.getCheckpointDir(), name)

    @staticmethod
    def _parse_ckpt_name(fname: str) -> Optional[tuple]:
        """'ckpt_00002.msgpack' -> (2, None); 'ckpt_00002_s0000005.msgpack'
        -> (2, 5); anything else (a shard, a tmp file) -> None."""
        if not (fname.startswith("ckpt_") and fname.endswith(".msgpack")):
            return None
        stem = fname[len("ckpt_"):-len(".msgpack")]
        try:
            if "_s" in stem:
                e, s = stem.split("_s", 1)
                return int(e), int(s)
            return int(stem), None
        except ValueError:
            return None

    def _ckpt_candidates(self) -> list:
        """Every on-disk checkpoint as ``((epoch, step), filename)``, best
        first (epoch desc; an epoch-final outranks any step checkpoint of
        its epoch; later steps outrank earlier)."""
        d = self.getCheckpointDir()
        if not d or not os.path.isdir(d):
            return []
        found = [(p, f) for f in os.listdir(d)
                 if (p := self._parse_ckpt_name(f)) is not None]
        found.sort(key=lambda pf: (pf[0][0], pf[0][1] is None,
                                   -1 if pf[0][1] is None else pf[0][1]),
                   reverse=True)
        return found

    def _latest_checkpoint(self) -> Optional[tuple]:
        """The newest manifest-verified position on disk as ``(epoch,
        step)`` (``step`` None: the epoch completed). A file the manifest
        does not vouch for (a torn write) is skipped, counted on
        ``mmlspark_ckpt_corrupt_total``, and the previous one becomes the
        candidate."""
        from ..resilience import ckpt as ckptlib
        d = self.getCheckpointDir()
        for pos, fname in self._ckpt_candidates():
            if ckptlib.verify(d, fname):
                return pos
        return None

    def _ckpt_writer(self):
        """The learner's background checkpoint publisher (made on the first
        async save, closed at fit exit)."""
        w = getattr(self, "_ckpt_writer_inst", None)
        if w is None:
            from ..resilience.ckpt import AsyncCheckpointWriter
            w = self._ckpt_writer_inst = AsyncCheckpointWriter("trainer")
        return w

    def _ckpt_barrier(self, close: bool = False):
        """Async-checkpoint barrier: returns once no write is pending or in
        flight (a no-op when asyncCheckpoint never armed); ``close`` also
        stops the writer. A writer-thread error re-raises here, unless
        another exception is already unwinding (a step fault must not be
        masked by a failed background write; it is logged instead).
        Elastic multi-process fits bound the wait: a writer snapshotting
        the output of a collective whose peer died may never finish, so
        past the bound it is orphaned (a daemon thread) and recovery
        proceeds — the manifest-last protocol keeps its partial write from
        ever becoming a resume candidate. An orphaned elastic attempt
        thread never touches the live writer."""
        import threading
        active = getattr(self, "_active_fit_thread", None)
        if active is not None and active is not threading.current_thread():
            return
        w = getattr(self, "_ckpt_writer_inst", None)
        if w is None:
            return
        if close:
            self._ckpt_writer_inst = None
        unwinding = sys.exc_info()[0] is not None
        try:
            if getattr(self, "_elastic_multiproc", False):
                if not w.wait(timeout=10.0):
                    log.warning("async checkpoint writer stalled past 10 s "
                                "(a dead-collective snapshot?); abandoning "
                                "it — uncommitted writes never become "
                                "resume candidates")
                    self._ckpt_writer_inst = None
                    return
            (w.close if close else w.wait)()
        except Exception as e:
            if not unwinding:
                raise
            log.warning("async checkpoint failure surfaced while another "
                        "error unwinds (kept secondary): %s", e)

    def _prune_step_checkpoints(self, epoch: int, keep: Optional[int]):
        """Drop this epoch's step checkpoints beyond the newest ``keep``
        (None = drop them all: the epoch-final save supersedes them). The
        checkpoint this fit resumed from is never pruned."""
        from ..resilience import ckpt as ckptlib
        floor = getattr(self, "_ckpt_floor", None)
        steps = sorted(p[1] for p, _f in self._ckpt_candidates()
                       if p[0] == epoch and p[1] is not None)
        drop = steps if keep is None else \
            (steps[:-keep] if len(steps) > keep else [])
        ckptlib.prune(self.getCheckpointDir(),
                      [f"ckpt_{epoch:05d}_s{s:07d}.msgpack" for s in drop
                       if floor is None or (epoch, s) != tuple(floor)])

    def _ckpt_state(self, params, opt_state, scale_state) -> dict:
        """The checkpoint's state dict from host tensors: the f32 master
        params (every precision mode: bf16 compute casts inside the step
        and never writes back), the optimizer state and, under bf16_mixed,
        the loss-scale recurrence, so a resumed fit continues bit-exact."""
        cfg = self._ckpt_cfg
        st = {"params": to_flax_params(params, cfg),
              "opt": _opt_state_dict(opt_state, self.getOptimizer(),
                                     self.getWeightDecay(), cfg)}
        if scale_state is not None:
            st["scale"] = prec.scale_state_to_host(scale_state)
        return st

    def _ckpt_stream(self, dev: torch.device):
        """The side stream checkpoint copies run on (None on the CPU)."""
        if dev.type != "cuda":
            return None
        s = getattr(self, "_ckpt_stream_inst", None)
        if s is None or s.device != dev:
            s = self._ckpt_stream_inst = torch.cuda.Stream(dev)
        return s

    def _save_checkpoint(self, epoch: int, state: tuple, dev,
                         step: Optional[int] = None, elastic_ctx=None):
        from ..resilience import ckpt as ckptlib
        from .downloader import write_flax_msgpack
        plan = getattr(self, "_plan", None)
        if plan is not None:
            # a distributed fit's checkpoint is the whole tree: every rank
            # joins the gather of the shards, rank 0 writes every file
            # (the JAX package's non-elastic multi-process rule, with the
            # shard files written by rank 0 too)
            state = (plan.gather(state[0]), plan.gather(state[1]), state[2])
            from ..parallel import mesh as meshlib
            if meshlib.process_index() != 0:
                return
        os.makedirs(self.getCheckpointDir(), exist_ok=True)
        snap = _Snapshot(state, self._ckpt_stream(dev))
        path = self._ckpt_path(epoch, step)
        keep = self.getCheckpointKeepSteps()
        n_shards = self.getCheckpointShards()
        # fused fits store LEARNER state only — featurize params are fit
        # constants, recorded by digest so resume rejects a checkpoint
        # written under a different featurize plan
        plan = getattr(self, "_featurize_plan", None)
        extra = ({"featurize_digest": plan.digest()}
                 if plan is not None else None)

        def on_commit():
            # strictly after the rename + manifest commit: pruning and the
            # elastic checkpoint-boundary hook only ever see durable state
            self._ckpt_floor = (epoch, step)
            self._prune_step_checkpoints(epoch,
                                         None if step is None else keep)
            if elastic_ctx is not None:
                elastic_ctx.checkpoint_saved(epoch, step)

        if n_shards > 1:
            def payload():
                flat = ckptlib.flatten_state(self._ckpt_state(*snap.host()))
                keys = sorted(flat)
                parts = ckptlib.partition_leaves(
                    [getattr(flat[k], "nbytes", 64) for k in keys], n_shards)
                return [write_flax_msgpack({keys[i]: flat[keys[i]]
                                            for i in idxs})
                        for idxs in parts]
            publish = functools.partial(ckptlib.publish_sharded, extra=extra)
        else:
            def payload():
                return write_flax_msgpack(self._ckpt_state(*snap.host()))
            publish = functools.partial(ckptlib.publish, extra=extra)
        # elastic multi-process fits route EVERY save through the writer:
        # a snapshot waited for on the fit thread would block it forever
        # behind a collective whose peer died; on the writer thread the
        # stall is bounded and abandoned by _ckpt_barrier
        if self.getAsyncCheckpoint() or getattr(self, "_elastic_multiproc",
                                                False):
            self._ckpt_writer().submit(path, payload, on_commit=on_commit,
                                       publish_fn=publish)
            if step is None:
                self._ckpt_barrier()      # epoch boundaries stay ordered
        else:
            publish(path, payload())
            on_commit()

    def _restore_checkpoint(self, pos: tuple) -> dict:
        """The host state dict of checkpoint ``pos``. Raises
        :class:`~..resilience.ckpt.CorruptCheckpoint` when the bytes fail
        the manifest digest or do not decode; the resume falls back to the
        previous checkpoint."""
        from ..resilience import ckpt as ckptlib
        from .downloader import read_flax_msgpack
        path = self._ckpt_path(*pos)
        d, name = os.path.split(path)
        with open(path, "rb") as f:
            blob = f.read()
        if not ckptlib.verify_bytes(d, name, blob):
            raise ckptlib.CorruptCheckpoint(name)
        shards = ckptlib.parse_head(blob)
        try:
            if shards is not None:
                flat: dict = {}
                for sblob in ckptlib.read_shards(d, shards):
                    flat.update(read_flax_msgpack(sblob))
                return ckptlib.unflatten_state(flat)
            return read_flax_msgpack(blob)
        except ckptlib.CorruptCheckpoint:
            raise
        except ValueError as e:
            ckptlib.note_corrupt(name, f"undecodable: {e}")
            raise ckptlib.CorruptCheckpoint(name) from e

    def _resume_training_state(self, state: tuple, dev):
        """Restore ``(params, opt_state, scale_state)`` from the newest
        checkpoint that verifies and decodes (:meth:`_resume_local`). A
        multi-rank fit's ranks each read the shared directory and must
        agree on the position, or the fit raises."""
        out = self._resume_local(state, dev)
        from ..parallel import mesh as meshlib
        if (getattr(self, "_plan", None) is not None
                and self.getCheckpointDir()
                and meshlib.effective_process_count() > 1):
            from ..parallel.dataplane import allgather_pyobj
            seen = allgather_pyobj(tuple(out[1:]))
            if len(set(seen)) != 1:
                raise RuntimeError(
                    f"the ranks resume from different checkpoint positions "
                    f"{seen}: is {self.getCheckpointDir()!r} on storage "
                    f"every rank shares?")
        return out

    def _resume_local(self, state: tuple, dev):
        """Restore from the newest checkpoint that verifies and decodes,
        falling back candidate by candidate. Returns ``(state,
        start_epoch, start_step)``: a fresh start is ``(state, 0, 0)``."""
        from ..resilience import ckpt as ckptlib
        d = self.getCheckpointDir()
        self._ckpt_floor = None
        if not d:
            return state, 0, 0
        self._ckpt_barrier()   # an earlier fit's write lands first
        cfg = self._ckpt_cfg
        params, opt_state, scale_state = state
        # a fused fit records its featurize plan by digest: a candidate
        # committed under a DIFFERENT plan trained on different features,
        # so it is skipped (no digest = a staged fit's: allowed)
        plan = getattr(self, "_featurize_plan", None)
        fdig = plan.digest() if plan is not None else None
        manifest = ckptlib.load_manifest(d) or {}
        for pos, fname in self._ckpt_candidates():
            if not ckptlib.verify(d, fname):
                continue
            rec = (manifest.get(fname) or {}).get("featurize_digest")
            if rec is not None and fdig is not None and rec != fdig:
                log.warning("checkpoint %s was written under a different "
                            "featurize plan — skipping it as a resume "
                            "candidate", fname)
                continue
            try:
                st = self._restore_checkpoint(pos)
                new_params = {k: v.to(dev) for k, v in from_flax_params(
                    st["params"], cfg).items()}
                new_opt = _opt_from_state_dict(
                    st["opt"], self.getOptimizer(), self.getWeightDecay(),
                    cfg, dev)
                if getattr(self, "_plan", None) is not None:
                    new_params = self._plan.shard(new_params)
                    new_opt = self._plan.shard(new_opt)
            except (ckptlib.CorruptCheckpoint, OSError, KeyError) as e:
                log.warning("restore of checkpoint %s failed (%s); trying "
                            "the previous checkpoint", _fmt_pos(pos), e)
                continue
            if scale_state is not None and st.get("scale") is not None:
                scale_state = prec.scale_state_from_host(st["scale"], dev)
            self._ckpt_floor = pos    # never pruned while this fit runs
            epoch, step = pos
            log.info("resumed from checkpoint %s", _fmt_pos(pos))
            return ((new_params, new_opt, scale_state),
                    epoch + (step is None),
                    0 if step is None else step + 1)
        return state, 0, 0

    def _device(self) -> torch.device:
        return resolve_device(self.getDevice(), "TorchLearner")

    def _cfg_with_precision(self, cfg: dict) -> dict:
        """Reflect ``precision`` into the model's compute dtype: 'bf16'
        leaves the config as it is (the model defaults to bf16); 'f32' and
        'bf16_mixed' pin the dtype unless the config names one."""
        mode = self.getPrecision()
        if mode != "bf16" and "dtype" not in cfg:
            cfg["dtype"] = "float32" if mode == "f32" else "bfloat16"
        return cfg

    def _precision_setup(self, dev):
        """(mixed, grad_clip, scale_state) for this fit."""
        mixed = self.getPrecision() == "bf16_mixed"
        scale_state = (prec.init_scale_state(self.getLossScaleInit(), dev)
                       if mixed else None)
        return mixed, self.getGradClipNorm(), scale_state

    def _prepare_data(self, df: DataFrame, cfg: dict):
        """(x, y) host arrays: int32 token ids (range-checked here, since a
        CUDA embedding lookup past the table faults the device) or float32
        features, and int32 or float32 labels."""
        if cfg.get("type") in TOKEN_MODELS:
            x = _token_matrix(df, self.getFeaturesCol())
            vocab = cfg.get("vocab_size", 10000)
            if x.size and (x.min() < 0 or x.max() >= vocab):
                raise ValueError(f"token ids must lie in [0, {vocab}); got "
                                 f"[{x.min()}, {x.max()}]")
        else:
            x = _prep_input(df, self.getFeaturesCol(),
                            tuple(self.getInputShape()))
        y = np.asarray(df.col(self.getLabelCol()))
        y = (y.astype(np.int32) if self.getLoss() == "cross_entropy"
             else y.astype(np.float32))
        return x, y

    def _slo_session(self):
        """Fit-scoped SLO evaluation (the ``sloConfig`` param): a private
        time-series sampler and SLOEngine run for the duration of the fit,
        and the final per-objective verdicts land on
        ``self._last_slo_report``. A context manager yielding the engine
        (None when the param is unset)."""
        import contextlib

        @contextlib.contextmanager
        def session():
            cfg = self.getSloConfig()
            if not cfg:
                yield None
                return
            from ..telemetry.slo import SLOEngine
            from ..telemetry.timeseries import TimeSeriesSampler
            cfg = dict(cfg)
            if "objectives" not in cfg:
                # shorthand: a mean-step-time budget over the trainer's
                # step histogram
                budget = float(cfg.get("stepTimeBudget", 0) or 0)
                if budget <= 0:
                    raise ValueError(
                        "sloConfig needs an 'objectives' list or a "
                        "positive 'stepTimeBudget'")
                cfg = {"objectives": [{
                    "name": "fit-step-time", "kind": "step_time",
                    "hist": "mmlspark_trainer_step_seconds",
                    "budget_s": budget,
                    "windows": cfg.get("windows", [5.0, 30.0]),
                    "burn_threshold": cfg.get("burnThreshold", 1.0)}],
                    "interval": cfg.get("interval", 0.25)}
            interval = float(cfg.get("interval") or 0.25)
            sampler = TimeSeriesSampler(interval=interval)
            engine = SLOEngine.from_config(cfg, sampler=sampler)
            sampler.start(interval)   # also enables telemetry
            engine.start()
            try:
                yield engine
            finally:
                engine.stop()
                sampler.stop()
                sampler.tick()        # final sample + verdict pass
                final = engine.evaluate()
                breached = sorted(engine.breached_ever())
                self._last_slo_report = {"objectives": final,
                                         "breached": breached}
                if breached:
                    telemetry.flight.note("slo/fit_summary",
                                          breached=",".join(breached))
                    log.warning("fit SLO summary: objective(s) %s "
                                "breached their budget", breached)

        return session()

    # ---- training ----
    def fit(self, df: DataFrame) -> TorchModel:
        with self._slo_session():
            if self.getElastic():
                return self._elastic_coordinator().fit(df)
            return self._fit(df)

    def _training_setup(self, cfg: dict, x_shape, dev, par=None):
        """``(step, state)`` of a fit whose batches have ``x_shape``: the
        step body of the precision mode, and the fresh ``(params,
        opt_state, scale_state)`` on ``dev``. The sizes flax infers from
        the first batch come from the data (``self._ckpt_cfg``, which the
        checkpoint layout reads too); the step reads the weights it is
        handed, and the module itself holds none (meta), so it costs no
        memory and no init.

        ``par`` (``_parallel_setup``'s mesh and attention) makes the fit
        distributed: ``self._plan`` splits the params and optimizer state
        (TP columns, EP experts), the module's layers get their groups, the
        step first gathers the inner block's rows into the data slice, and
        a pipeline fit runs ``transformer_pp_forward``."""
        sized = self._ckpt_cfg = sized_for(cfg, x_shape)
        mesh, attn_fn = par if par is not None else (None, None)
        with torch.device("meta"):
            module = build_model(sized, attn_fn=attn_fn)
        mixed, grad_clip, scale_state = self._precision_setup(dev)
        full = init_params(sized, self.getSeed())
        plan = forward = None
        if mesh is not None:
            from ..parallel.plan import ParallelPlan
            pp = self.getPipelineParallel()
            plan = ParallelPlan(mesh, sized, full, tp=self.getTensorParallel(),
                                ep=self.getExpertParallel(), pp=pp)
            plan.configure(module)
            full = plan.shard(full)
            if pp > 1:
                from ..parallel.pipeline_parallel import \
                    transformer_pp_forward

                def forward(p, xb):
                    return transformer_pp_forward(sized, p, xb, mesh,
                                                  n_microbatches=pp,
                                                  module=module)
        self._plan = plan
        params = {k: v.to(device=dev, dtype=torch.float32)
                  for k, v in full.items()}
        tx = make_optimizer(self.getOptimizer(), self.getLearningRate(),
                            self.getMomentum(), self.getWeightDecay())
        loss_fn = make_loss(self.getLoss(), per_example=True)
        # only the transformer family reads num_experts; other configs
        # carrying the key get no row_mask
        is_moe = (sized.get("type") == "transformer"
                  and sized.get("num_experts", 0) > 0)
        moe_aux = self.getMoeAuxWeight() if is_moe else 0.0
        if mixed:
            body = _make_mixed_step_body(module, tx, loss_fn, grad_clip,
                                         is_moe, moe_aux, plan)
        else:
            plain = _make_step_body(module, tx, loss_fn, grad_clip, is_moe,
                                    moe_aux, plan, forward)

            def body(p, o, ss, xb, yb, wb):
                p, o, loss = plain(p, o, xb, yb, wb)
                return p, o, None, loss
        if plan is None or plan.inner_group is None:
            step = body
        else:
            def step(p, o, ss, xb, yb, wb):
                return body(p, o, ss, *plan.rows(xb, yb, wb))
        return step, (params, tx.init(params), scale_state)

    def _fit(self, df: DataFrame, elastic_ctx=None) -> TorchModel:
        """One fit attempt. ``elastic_ctx`` (the elastic coordinator's)
        threads the per-step host-loss check and the committed-step and
        resume journal through the step loop; the fit runs on every rank
        of the world, and in one process on its one device, whatever the
        surviving hosts."""
        self._elastic_setup(elastic_ctx)
        dev = self._device()
        cfg = self._cfg_with_precision(dict(self.getModelConfig()))
        # fit-side pipeline fusion: when Pipeline.fit composed the
        # featurize prefix into a capture plan (_fit_captured), training
        # consumes RAW wire-dtype columns and featurizes each step's batch
        # on the device — the staged (x, y) materialization is skipped
        plan = getattr(self, "_featurize_plan", None)
        feat = raws = None
        if plan is not None:
            raws = plan.encode(df)
            if raws is None:
                from ..core import capture as capturelib
                capturelib._m_fit_fallbacks.inc()
                log.warning("fused fit fell back to staged featurization:"
                            " a raw input column is not device-encodable")
                df = plan.apply_staged(df)
                plan = None
        if plan is None:
            x, y = self._prepare_data(df, cfg)
            data, n, x_shape = (x, y), len(x), x.shape
        else:
            feat = self._featurize_fn(plan, dev)
            data, n = tuple(raws), len(raws[0])
            x_shape = (n,) + self._featurized_shape(plan, raws)
        if n == 0:
            raise ValueError("fit on an empty DataFrame")
        par = self._parallel_setup(
            cfg, x_shape[1] if len(x_shape) > 1 else None, dev)
        # multi-rank: this rank's df is its LOCAL shard and batchSize the
        # GLOBAL batch; every rank contributes exactly bs rows a step (a
        # short shard wraps its rows), and the step count derives from the
        # global row count, so every rank runs the same steps
        from ..parallel import mesh as meshlib
        world = meshlib.effective_process_count() if par else 1
        if par is not None:
            dev = par[0].device
        n_global = n
        if world > 1:
            from ..parallel.dataplane import allgather_pyobj
            n_global = int(sum(allgather_pyobj(int(n))))
        step, state = self._training_setup(cfg, x_shape, dev, par)
        state, start_epoch, start_step = self._resume_training_state(state,
                                                                     dev)
        self._report_resume(elastic_ctx, state[0])
        bs_global = max(1, min(self.getBatchSize(), n_global))
        bs = max(1, bs_global // world)
        steps = max(1, n_global // (bs * world))
        data_cap = self.getDeviceDataCap() or _device_data_cap(dev)
        # ranks feeding distinct data slices draw distinct orders
        rng_np = np.random.default_rng(self.getSeed()
                                       + meshlib.process_index())
        # an elastic fit stays on the per-step feed path: step-interval
        # checkpoints and the per-step host-loss check both need the host
        # between steps (a mid-epoch loss on the scan path would cost the
        # epoch)
        scan = (world == 1 and elastic_ctx is None
                and sum(a.nbytes for a in data) <= data_cap)
        run = self._run_epochs_scan if scan else self._run_epochs
        profile = self.getProfile()
        if profile:
            telemetry.profiler.enable()
        path = "scan" if scan else "feed"
        # concurrent fits on a thread pool must not interleave collectives
        guard = self._fit_guard(par)
        extra = {} if scan else {"elastic_ctx": elastic_ctx}
        try:
            with guard, full_precision_matmuls(
                    self.getPrecision() == "f32"), \
                    telemetry.trace.span("fit", model=cfg.get("type"),
                                         rows=n, path=path,
                                         fused=plan is not None):
                state, stats = run(data, n, bs, steps, order_rng=rng_np,
                                   dev=dev, step=step, state=state,
                                   start_epoch=start_epoch,
                                   start_step=start_step, profile=profile,
                                   feat=feat, **extra)
        finally:
            # an async checkpoint still in flight lands before the caller
            # (or a refit) reads the directory
            self._ckpt_barrier(close=True)
        if profile:
            # the fit's device memory peak, read after its last step
            telemetry.profiler.sample_live_buffers(dev, state)
        stats["path"] = path
        stats.pop("skipped_seen", None)   # _finish_epoch's telemetry cursor
        if state[2] is not None:
            stats["scale_state"] = prec.scale_state_to_host(state[2])
        return self._package_model(cfg, state[0], stats)

    def _package_model(self, cfg, params, stats) -> TorchModel:
        if getattr(self, "_plan", None) is not None:
            # the whole flax-layout tree on every rank, from the shards
            params = self._plan.gather(params)
        model = (TorchModel()
                 .setInputCol(self.getFeaturesCol())
                 .setModelConfig(cfg)
                 .setModelParams({k: v.detach().to("cpu", torch.float32)
                                  for k, v in params.items()})
                 .setInputShape(tuple(self.getInputShape()))
                 .setDevice(self.getDevice()))
        losses = stats["epoch_losses"]
        model._final_loss = losses[-1] if losses else None
        model._fit_stats = stats
        return model

    def fitStream(self, batches_fn) -> TorchModel:
        """Out-of-core training: ``batches_fn()`` returns a FRESH iterator
        of ``(features, labels)`` batches for every epoch — host numpy
        arrays, or tensors already on the card, e.g. from
        ``io.arrow.arrow_feature_batches`` or a wrapper of
        ``io.loader.device_image_batches`` over a file corpus.

        The model is sized from the first batch. Ragged batches bucket to
        powers of two (at least 8 rows), the pad rows zero and weighted
        out, so batch-size drift makes no new step signature. Each epoch's
        batch preparation and copy run ``prefetchDepth`` batches ahead on
        the prefetch thread. Checkpoints, resume and the divergence halt
        work as in ``fit()``, except that a step checkpoint restarts its
        epoch (a generator cannot seek: the optimizer state is the
        checkpoint's, some batches are seen again).

        ``elastic=True`` routes the stream fit through the same
        :class:`~..resilience.elastic.ElasticFitCoordinator` as fit(): a
        host loss mid-stream re-meshes over the survivors and re-enters
        from the checkpointed optimizer state (the epoch restarts)."""
        with self._slo_session():
            if self.getElastic():
                return self._elastic_coordinator().fit_stream(batches_fn)
            return self._fit_stream(batches_fn)

    def _fit_stream(self, batches_fn, elastic_ctx=None) -> TorchModel:
        from ..core import capture as capturelib
        self._elastic_setup(elastic_ctx)
        dev = self._device()
        cfg = self._cfg_with_precision(dict(self.getModelConfig()))
        # fitStreamCaptured: batches are RAW wire-dtype columns, featurized
        # on the device ahead of each step
        plan = getattr(self, "_featurize_plan", None)
        feat = self._featurize_fn(plan, dev) if plan is not None else None
        if (self.getSequenceParallel() > 1 or self.getExpertParallel() > 1
                or self.getPipelineParallel() > 1):
            raise ValueError(
                "fitStream is data(+tensor)-parallel; use fit() for "
                "sequence/expert/pipeline parallelism")
        par = self._parallel_setup(cfg, None, dev)
        if par is not None:
            dev = par[0].device
        from ..parallel import mesh as meshlib
        world = meshlib.effective_process_count() if par else 1
        first_iter = iter(batches_fn())
        first = next(first_iter, None)
        x0 = y0 = None
        if first is not None and plan is None:
            x0, y0 = _stream_batch(first, cfg, self.getLoss())
        if world > 1:
            # a rank whose stream is EMPTY from the start must still join
            # every collective: the ranks agree the batch signature so it
            # sizes the same model and feeds zero-weight dummies while the
            # others drain
            from ..parallel.dataplane import allgather_pyobj
            sig = (None if x0 is None else
                   (tuple(x0.shape[1:]), str(x0.dtype), str(y0.dtype)))
            sigs = [g for g in allgather_pyobj(sig) if g is not None]
            if not sigs:
                raise ValueError("batches_fn() yielded no batches on any "
                                 "process")
            if x0 is None:
                xsh, xdt, ydt = sigs[0]
                x0 = np.zeros((0,) + tuple(xsh), _np_dtype(xdt))
                y0 = np.zeros((0,), _np_dtype(ydt))
        elif first is None:
            raise ValueError("batches_fn() yielded no batches")
        if plan is None:
            x_shape = tuple(x0.shape)
        else:
            raw0 = self._stream_raw_batch(first, plan)
            x_shape = (len(raw0[0]),) + self._featurized_shape(plan, raw0)
        self._stream_x0 = (x0[:0], y0[:0]) if x0 is not None else None
        step, state = self._training_setup(cfg, x_shape, dev, par)
        state, start_epoch, start_step = self._resume_training_state(state,
                                                                     dev)
        self._report_resume(elastic_ctx, state[0])
        if start_step:
            log.warning("step checkpoint (epoch %d, step %d) resumes at the "
                        "epoch start on the stream path", start_epoch,
                        start_step - 1)
        profile = self.getProfile()
        if profile:
            telemetry.profiler.enable()
            step = telemetry.profiler.wrap(step, "trainer.step")
        from ..parallel.prefetch import prefetched
        ckpt_every = (self.getCheckpointEverySteps()
                      if self.getCheckpointDir() else 0)
        stats = {"epoch_losses": [], "epoch_seconds": [],
                 "stream_batches": [], "path": "stream"}
        guard = self._fit_guard(par)
        try:
            with guard, full_precision_matmuls(
                    self.getPrecision() == "f32"), \
                    telemetry.trace.span("fit", model=cfg.get("type"),
                                         path="stream"):
                for epoch in range(start_epoch, self.getEpochs()):
                    stream = ((itertools.chain([first], first_iter)
                               if first is not None else first_iter)
                              if epoch == start_epoch
                              else iter(batches_fn()))
                    t0 = time.perf_counter()
                    steps_it = prefetched(
                        lambda s=stream: self._stream_epoch_steps(
                            s, cfg, dev, plan),
                        depth=self.getPrefetchDepth(), name="fit-stream",
                        span="fit/prefetch")
                    steps_run = rows = 0
                    try:
                        for n, xb, yb, wb in steps_it:
                            t_step = time.perf_counter()
                            with telemetry.trace.span(
                                    "fit/step", epoch=epoch,
                                    step=steps_run) as sp:
                                def dispatch(_a, st=state, xb=xb, yb=yb,
                                             wb=wb):
                                    if elastic_ctx is not None:
                                        # host-loss check + elastic.step
                                        # fault site; a verdict raises
                                        # non-transient, skipping the
                                        # retry, out to the re-mesh
                                        elastic_ctx.check_step()
                                    faults.inject("trainer.step")
                                    if feat is not None:
                                        # xb is the placed raw columns
                                        xb, yb = feat(*xb)
                                    return step(*st, xb, yb, wb)
                                *new, loss = _STEP_RETRY.run(dispatch)
                                state = tuple(new)
                                sp.set_sync(loss)
                            if feat is not None:
                                capturelib._m_fit_fused.inc()
                            _m_step_time.observe(time.perf_counter()
                                                 - t_step)
                            steps_run += 1
                            rows += n
                            if elastic_ctx is not None:
                                elastic_ctx.step_committed(epoch,
                                                           steps_run - 1)
                            if ckpt_every and steps_run % ckpt_every == 0:
                                self._save_checkpoint(
                                    epoch, state, dev, step=steps_run - 1,
                                    elastic_ctx=elastic_ctx)
                    finally:
                        steps_it.close()
                    if steps_run == 0:
                        raise ValueError(f"batches_fn() yielded no batches "
                                         f"in epoch {epoch}")

                    stats["stream_batches"].append(steps_run)
                    self._finish_epoch(epoch, loss, stats, t0, rows,
                                       state[2])
                    if self.getCheckpointDir():
                        self._save_checkpoint(epoch, state, dev,
                                              elastic_ctx=elastic_ctx)
        finally:
            self._ckpt_barrier(close=True)
        stats.pop("skipped_seen", None)
        if state[2] is not None:
            stats["scale_state"] = prec.scale_state_to_host(state[2])
        return self._package_model(cfg, state[0], stats)

    def _stream_epoch_steps(self, stream, cfg, dev, plan=None):
        """One epoch of fitStream's per-batch host work as a generator:
        normalise -> pow2 bucket -> zero pad -> weight mask -> copy to the
        device. Yields ``(n_real, xb, yb, wb)`` with the batch on its way
        to the device, so the consuming loop (the prefetch thread running
        this ahead of it) only dispatches steps.

        With a fit-side capture ``plan`` (fitStreamCaptured) the batch
        stays RAW: each wire-dtype column buckets and pads on its own, and
        ``xb`` is the tuple of placed columns (``yb`` None) —
        featurization happens on the device, ahead of the step."""
        from ..core import capture as capturelib
        while plan is not None:
            b = next(stream, None)
            if b is None:
                return
            raws = self._stream_raw_batch(b, plan)
            n = len(raws[0])
            target = _next_pow2(n)
            raws = [_pad_rows(r, target) for r in raws]
            wb = np.zeros(target, dtype=np.float32)
            wb[:n] = 1.0
            nbytes = int(sum(r.nbytes for r in raws))
            if telemetry.enabled():
                _note_step_signature("stream_fused", *raws, wb)
                _m_transfer_bytes.inc(nbytes + wb.nbytes)
            capturelib.count_fit_transfer("in", nbytes)
            yield (n, tuple(_to_device(r, dev) for r in raws), None,
                   _to_device(wb, dev))
        from ..parallel import mesh as meshlib
        world = meshlib.effective_process_count()
        if getattr(self, "_plan", None) is None:
            world = 1
        while True:
            b = next(stream, None)
            if b is None:
                xb = yb = None
                n = local_target = 0
            else:
                xb, yb = _stream_batch(b, cfg, self.getLoss())
                n = len(xb)
                local_target = _next_pow2(n)
            target = local_target
            if world > 1:
                # host-side lockstep: the ranks agree on the bucket every
                # step; a drained stream reports 0 and feeds zero-weight
                # dummies until the longest stream finishes
                from ..parallel.dataplane import allgather_pyobj
                target = max(allgather_pyobj(local_target))
            if target == 0:
                return
            if xb is None:
                xb, yb = self._stream_x0
            wb = np.zeros(target, dtype=np.float32)
            wb[:n] = 1.0
            xb, yb = _pad_rows(xb, target), _pad_rows(yb, target)
            if telemetry.enabled():
                _note_step_signature("stream", xb, yb, wb)
                _m_transfer_bytes.inc(sum(
                    a.nbytes for a in (xb, yb, wb)
                    if isinstance(a, np.ndarray)))
            yield n, _placed(xb, dev), _placed(yb, dev), _to_device(wb, dev)

    def fitStreamCaptured(self, batches_fn, plan) -> TorchModel:
        """:meth:`fitStream` with a fit-side capture plan
        (``core.capture.compose_fit_capture``): every item ``batches_fn()``
        yields is a DataFrame holding ``plan.in_names`` or a tuple of RAW
        column arrays aligned with them (wire dtypes; featurization runs
        on the device ahead of each step). Single-process only."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise ValueError("fitStreamCaptured is single-process; "
                             "multi-process streams run staged fitStream")
        cfg = dict(self.getModelConfig() or {})
        if cfg.get("type") in TOKEN_MODELS:
            raise ValueError("fused stream fit needs a featurized-vector "
                             "model family, not a token model")
        self._featurize_plan = plan
        try:
            return self.fitStream(batches_fn)
        finally:
            self._featurize_plan = None

    # ---- fit-side pipeline fusion (core/capture.py) ----
    def _fit_captured(self, df: DataFrame, plan) -> Optional[TorchModel]:
        """The fused-fit hook ``Pipeline.fit(fusePipeline=True)`` calls:
        train with ``plan`` (a :class:`~..core.capture.FitCapturePlan`)
        featurizing each step's raw batch on the device, or return None
        to decline (the pipeline then falls back to the staged fit).
        Declines the model families whose input is not a featurized
        vector batch (token models) and the mesh axes the fused feed does
        not thread (seq/expert/pipe)."""
        cfg = dict(self.getModelConfig() or {})
        if (cfg.get("type") in TOKEN_MODELS
                or self.getSequenceParallel() > 1
                or self.getExpertParallel() > 1
                or self.getPipelineParallel() > 1):
            return None
        self._featurize_plan = plan
        try:
            return self.fit(df)
        finally:
            self._featurize_plan = None

    def _stream_raw_batch(self, b, plan) -> list:
        """A fitStreamCaptured batch as raw column arrays in
        ``plan.in_names`` order, in device dtypes — either a DataFrame
        carrying those columns, or an already-aligned tuple/list of
        arrays."""
        from ..core import capture as capturelib
        if isinstance(b, DataFrame):
            raws = plan.encode(b)
            if raws is None:
                raise ValueError(
                    "fitStreamCaptured batch is missing (or cannot encode) "
                    f"one of the captured input columns {plan.in_names}")
            return raws
        arrs = [capturelib.wire_array(
            a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
            for a in b]
        if len(arrs) != len(plan.in_names):
            raise ValueError(
                f"fitStreamCaptured batch has {len(arrs)} arrays; the "
                f"capture plan needs {len(plan.in_names)} "
                f"({plan.in_names})")
        return arrs

    def _featurize_body(self, plan, dev):
        """The featurize adapter of a fused fit: ``plan.body`` plus the
        staged path's input conventions (float32 features, a 1-D column
        as (n, 1), the inputShape CHW -> NHWC reshape made contiguous as
        the staged upload is, loss-dtype labels), so fused and staged fits
        see identical ``(xb, yb)``."""
        shape = tuple(self.getInputShape())
        ce = self.getLoss() == "cross_entropy"
        fp = plan.device_params(dev)

        def feat(*raw):
            with torch.no_grad():
                xb, yb = plan.body(fp, raw)
                xb = xb.to(torch.float32)
                if xb.ndim == 1:
                    xb = xb[:, None]
                if shape:
                    c, h, w = shape
                    xb = xb.reshape(-1, c, h, w).permute(0, 2, 3, 1) \
                        .contiguous()
                yb = yb.to(torch.int32 if ce else torch.float32)
            return xb, yb
        return feat

    def _featurize_fn(self, plan, dev):
        """The featurize program of a fused fit on ``dev``: one CUDA graph
        per raw batch signature on a card (the profiler's AOT cache,
        ``trainer.featurize``), the function itself on the CPU; the
        training step after it stays eager, as the staged fit's does.
        Cached ON THE LEARNER, keyed on the plan, the learner's params and
        the device: a kill-and-resume re-enters fit() on the same
        instance, and reusing the same ProfiledFunction is what makes
        "zero new captures across a resume" assertable."""
        cache = self.__dict__.setdefault("_fused_programs", {})
        key = (plan.key(), repr(sorted(self._jsonParams().items())),
               str(dev))
        pf = cache.get(key)
        if pf is None:
            pf = cache[key] = telemetry.profiler.wrap(
                self._featurize_body(plan, dev), "trainer.featurize",
                aot=True)
        return pf

    def _featurized_shape(self, plan, raws) -> tuple:
        """The per-row shape ``(xb.shape[1:])`` the featurize adapter gives
        ``raws``: a run on the meta device (shapes only, no data moves),
        what sizes the model as the staged batch would."""
        from ..core.capture import meta_batch
        body = self._featurize_body(plan, torch.device("meta"))
        return tuple(body(*meta_batch(raws))[0].shape[1:])

    def _finish_epoch(self, epoch: int, loss, stats: dict, t0: float,
                      rows: int, scale_state):
        """Epoch end: the one host read of the loss, the epoch's telemetry
        (rows/s, the loss scaler's state) and the divergence halt."""
        last = float(loss)
        seconds = time.perf_counter() - t0
        stats["epoch_losses"].append(last)
        stats["epoch_seconds"].append(seconds)
        _m_rows_per_sec.set(rows / max(seconds, 1e-9))
        stats["skipped_seen"] = prec.observe_scale_state(
            scale_state, stats.get("skipped_seen", 0))
        log.info("epoch %d loss %.4f", epoch, last)
        if self.getHaltOnNonFinite() and not np.isfinite(last):
            last_good = (self._latest_checkpoint()
                         if self.getCheckpointDir() else None)
            raise RuntimeError(
                f"training diverged: epoch {epoch} loss is {last} "
                f"(lr={self.getLearningRate()}). "
                + (f"Last good checkpoint: {_fmt_pos(last_good)} in "
                   f"{self.getCheckpointDir()!r}; refit resumes there."
                   if last_good is not None
                   else "Set checkpointDir to make divergence resumable."))

    def _run_epochs(self, data, n, bs, steps, *, order_rng, dev, step,
                    state, start_epoch=0, start_step=0, profile=False,
                    feat=None, elastic_ctx=None):
        """The per-step feed path: one permutation per epoch, bs rows per
        step with cyclic wrap, staged ``prefetchDepth`` steps ahead. A step
        checkpoint re-enters its epoch at the next step. ``data`` is
        ``(x, y)``, or with ``feat`` (a fused fit) the raw columns that
        ``feat`` turns into the step's ``(x, y)`` on the device."""
        from ..core import capture as capturelib
        from ..parallel.prefetch import prefetched
        wb = torch.ones(bs, dtype=torch.float32, device=dev)  # every row real
        if profile:
            step = telemetry.profiler.wrap(step, "trainer.step")
        # replay the completed epochs' permutation draws (before the
        # prefetch thread draws), so a resumed fit sees the uninterrupted
        # fit's orders
        if self.getShuffle():
            for _ in range(start_epoch):
                order_rng.permutation(n)

        def produce():
            for epoch in range(start_epoch, self.getEpochs()):
                order = (order_rng.permutation(n) if self.getShuffle()
                         else np.arange(n))
                s0 = start_step if epoch == start_epoch else 0
                for s in range(s0, steps):
                    idx = order[(s * bs + np.arange(bs)) % n]
                    cols = [a[idx] for a in data]
                    nbytes = sum(c.nbytes for c in cols)
                    if telemetry.enabled():
                        _note_step_signature(
                            "feed" if feat is None else "feed_fused", *cols)
                        _m_transfer_bytes.inc(nbytes)
                    if feat is not None:
                        capturelib.count_fit_transfer("in", nbytes)
                    yield (epoch, s,
                           tuple(_to_device(c, dev) for c in cols))

        stats = {"epoch_losses": [], "epoch_seconds": [],
                 "steps_per_epoch": steps, "batch_rows": bs}
        ckpt_every = (self.getCheckpointEverySteps()
                      if self.getCheckpointDir() else 0)
        it = prefetched(produce, depth=self.getPrefetchDepth(),
                        name="fit-feed", span="fit/prefetch")
        t0 = time.perf_counter()
        epoch_steps = 0
        try:
            for epoch, s, cols in it:
                t_step = time.perf_counter()
                with telemetry.trace.span("fit/step", epoch=epoch,
                                          step=s) as sp:
                    def dispatch(_a, st=state, cols=cols):
                        if elastic_ctx is not None:
                            # host-loss check + elastic.step fault site; a
                            # verdict raises non-transient, skipping the
                            # retry, out to the re-mesh
                            elastic_ctx.check_step()
                        faults.inject("trainer.step")
                        xb, yb = cols if feat is None else feat(*cols)
                        return step(*st, xb, yb, wb)
                    *new, loss = _STEP_RETRY.run(dispatch)
                    state = tuple(new)
                    sp.set_sync(loss)
                if feat is not None:
                    capturelib._m_fit_fused.inc()
                _m_step_time.observe(time.perf_counter() - t_step)
                epoch_steps += 1
                if elastic_ctx is not None:
                    elastic_ctx.step_committed(epoch, s)
                if s < steps - 1:
                    if ckpt_every and (s + 1) % ckpt_every == 0:
                        self._save_checkpoint(epoch, state, dev, step=s,
                                              elastic_ctx=elastic_ctx)
                    continue
                self._finish_epoch(epoch, loss, stats, t0, epoch_steps * bs,
                                   state[2])
                if self.getCheckpointDir():
                    self._save_checkpoint(epoch, state, dev,
                                          elastic_ctx=elastic_ctx)
                t0 = time.perf_counter()
                epoch_steps = 0
        finally:
            it.close()
        return state, stats

    def _run_epochs_scan(self, data, n, bs, steps, *, order_rng, dev, step,
                         state, start_epoch=0, start_step=0, profile=False,
                         feat=None):
        """The device-resident path: the epoch (padded to ``steps * bs``
        rows, pad rows weight 0, plus a bs-row wrap margin) lives on the
        device, and each step is a window of it. Checkpoints are taken at
        epoch ends; a step checkpoint restarts its epoch. ``data`` is
        ``(x, y)``, or with ``feat`` (a fused fit) the raw columns, which
        stay raw on the device; ``feat`` featurizes each window."""
        from ..core import capture as capturelib
        if start_step:
            # the windows of an epoch are drawn together; restart the
            # epoch — the params already hold the checkpointed steps
            log.warning("step checkpoint (epoch %d, step %d) resumes at the "
                        "epoch start on the scan path", start_epoch,
                        start_step - 1)
        # one device: the data axis is 1, so the batch needs no rounding;
        # ceil instead of the feed path's floor, so windows cover every row
        steps = max(1, -(-n // bs))
        n_pad = steps * bs
        # windows slice the RESIDENT order, so it must be random: small
        # datasets get a fresh permutation per epoch, big ones permute once
        # at upload and vary by rotation + window order
        reshuffle = (self.getShuffle()
                     and sum(a.nbytes for a in data)
                     <= (self.getEpochReshuffleCap() or _EPOCH_RESHUFFLE_CAP))
        if self.getShuffle() and not reshuffle:
            perm0 = order_rng.permutation(n)
            data = tuple(a[perm0] for a in data)
        w_all = np.zeros(n_pad, dtype=np.float32)
        w_all[:n] = 1.0

        def margin(a):
            ap = _wrap_rows(a, n_pad)
            return _to_device(np.concatenate([ap, ap[:bs]], axis=0), dev)

        def upload(host_arrs):
            nbytes = int(sum(a.nbytes for a in host_arrs))
            if telemetry.enabled():
                _m_transfer_bytes.inc(nbytes)
            if feat is not None:
                capturelib.count_fit_transfer("in", nbytes)
            with telemetry.trace.span("fit/upload", bytes=nbytes):
                return tuple(margin(a) for a in host_arrs)

        def run_window(p, o, ss, data_dev, w_dev, window):
            """One dispatch: eager steps over windows of the resident
            epoch, the state never leaving the device."""
            loss = None
            for s0 in window:
                cols = tuple(a[s0:s0 + bs] for a in data_dev)
                xb, yb = cols if feat is None else feat(*cols)
                p, o, ss, loss = step(p, o, ss, xb, yb, w_dev[s0:s0 + bs])
            return p, o, ss, loss

        if profile:
            run_window = telemetry.profiler.wrap(run_window,
                                                 "trainer.scan_epoch")
        if not reshuffle:
            data_dev = upload(data)
        w_dev = margin(w_all)
        kpd = self.getStepsPerDispatch() or steps
        base = np.arange(steps, dtype=np.int32) * bs
        # replay the completed epochs' draws, so a resumed fit sees the
        # uninterrupted fit's orders
        for _ in range(start_epoch):
            if reshuffle:
                order_rng.permutation(n)
            elif self.getShuffle():
                order_rng.permutation(steps)
                order_rng.integers(0, n_pad)
        stats = {"epoch_losses": [], "epoch_seconds": [],
                 "steps_per_epoch": steps, "batch_rows": bs}
        for epoch in range(start_epoch, self.getEpochs()):
            t0 = time.perf_counter()
            if reshuffle:
                perm = order_rng.permutation(n)
                data_dev = upload([a[perm] for a in data])
                starts = base
            elif self.getShuffle():
                starts = ((base[order_rng.permutation(steps)]
                           + order_rng.integers(0, n_pad)) % n_pad) \
                    .astype(np.int32)
            else:
                starts = base
            starts = starts.tolist()
            with telemetry.trace.span("fit/epoch", epoch=epoch,
                                      path="scan") as ep_sp:
                for lo in range(0, steps, kpd):
                    t_disp = time.perf_counter()
                    with telemetry.trace.span(
                            "fit/step", epoch=epoch, first_step=lo,
                            steps=min(kpd, steps - lo)) as sp:
                        def dispatch(_a, st=state, lo=lo):
                            faults.inject("trainer.step")
                            return run_window(*st, data_dev, w_dev,
                                              starts[lo:lo + kpd])
                        *new, loss = _STEP_RETRY.run(dispatch)
                        state = tuple(new)
                        sp.set_sync(loss)
                    if feat is not None:
                        capturelib._m_fit_fused.inc(min(kpd, steps - lo))
                    _m_step_time.observe(time.perf_counter() - t_disp)
                ep_sp.set_sync(loss)
            self._finish_epoch(epoch, loss, stats, t0, steps * bs, state[2])
            if self.getCheckpointDir():
                self._save_checkpoint(epoch, state, dev)
        return state, stats
