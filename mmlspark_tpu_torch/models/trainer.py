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

Not ported yet, and raising NotImplementedError naming their ROADMAP.md
item when set away from their defaults: tensor/sequence/expert/pipeline
parallelism, elastic training, checkpoints (``checkpointDir``), SLO
sessions (``sloConfig``) and the device profiler (``profile``); also
``fitStream`` and ``fitStreamCaptured``.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.dataframe import DataFrame
from ..core.env import resolve_device
from ..core.params import (BooleanParam, DictParam, FloatParam, IntParam,
                           ListParam, StringParam)
from ..core.pipeline import Estimator
from ..core.utils import get_logger
from . import precision as prec
from .modules import (TOKEN_MODELS, Conv2d, Dense, Embed, FrozenAffine,
                      GroupNorm, LayerNorm, build_model, sized_for)
from .torch_model import (TorchModel, _prep_input, _token_matrix,
                          full_precision_matmuls)

log = get_logger("trainer")


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


def _make_loss_compute(module, loss_fn):
    """The weighted scalar loss of one batch: the one forward every
    precision mode and path shares. The model casts itself to its compute
    dtype; the loss reduction stays f32, and rows of weight 0 carry no
    gradient."""

    def compute(params, xb, yb, wb):
        _bind(module, params)
        losses = loss_fn(module(xb), yb)
        return torch.sum(losses * wb) / torch.clamp_min(torch.sum(wb), 1.0)

    return compute


def _make_step_body(module, tx, loss_fn, grad_clip: float = 0.0):
    """One optimizer step: loss -> grads -> (clip) -> update, returning
    ``(params, opt_state, loss)``."""
    compute = _make_loss_compute(module, loss_fn)

    def step_body(params, opt_state, xb, yb, wb):
        loss, grads = prec.value_and_grad(compute, params, xb, yb, wb)
        if grad_clip > 0.0:
            grads = prec.clip_by_global_norm(grads, grad_clip)
        updates, opt2 = tx.update(grads, opt_state, params)
        return prec.apply_updates(params, updates), opt2, loss

    return step_body


def _make_mixed_step_body(module, tx, loss_fn, grad_clip: float = 0.0):
    """bf16_mixed twin of _make_step_body, threading a ScaleState:
    ``(params, opt_state, scale_state, xb, yb, wb) ->
    (params, opt_state, scale_state, loss)``."""
    return prec.make_mixed_step_body(_make_loss_compute(module, loss_fn), tx,
                                     grad_clip)


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


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


class TorchLearner(Estimator):
    """Neural-net training on one device (the port of ``TpuLearner``).

    Params mirror the JAX package's; ``device`` is the port's own. The
    parallelism, elastic, checkpoint, SLO and profiler Params are kept so a
    saved stage round-trips, and raise at fit time away from their
    defaults."""

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
        "per-epoch checkpoint directory ('' = off); not ported yet",
        default="")
    checkpointEverySteps = IntParam(
        "also checkpoint every N steps within an epoch (needs "
        "checkpointDir)", default=0, min=0)
    asyncCheckpoint = BooleanParam(
        "publish checkpoints from a background writer (needs "
        "checkpointDir)", default=False)
    checkpointKeepSteps = IntParam(
        "step checkpoints kept per epoch (needs checkpointDir)", default=3,
        min=1)
    checkpointShards = IntParam(
        "shard files per checkpoint (needs checkpointDir)", default=0,
        min=0)
    tensorParallel = IntParam("size of the model (TP) mesh axis; only 1 is "
                              "ported", default=1, min=1)
    sequenceParallel = IntParam("size of the sequence (SP) mesh axis; only "
                                "1 is ported", default=1, min=1)
    spMode = StringParam("sequence-parallel collective form", default="ring",
                         choices=("ring", "ulysses"))
    expertParallel = IntParam("size of the expert (EP) mesh axis; only 1 "
                              "is ported", default=1, min=1)
    pipelineParallel = IntParam("size of the pipeline (PP) mesh axis; only "
                                "1 is ported", default=1, min=1)
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
        "optimizer steps per dispatch on the scan path (0 = whole epoch); "
        "kept so a saved stage round-trips. The port's steps are eager "
        "launches, so every value trains alike until the scan path is "
        "captured as a CUDA graph", default=0, min=0)
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
    profile = BooleanParam("device-profile this fit; not ported yet",
                           default=False)
    elastic = BooleanParam("run fit through the elastic training runtime; "
                           "not ported yet", default=False)
    elasticHosts = IntParam("elastic failure domains (needs elastic)",
                            default=0, min=0)
    elasticMinHosts = IntParam("elastic survivors to keep training (needs "
                               "elastic)", default=1, min=1)
    elasticGraceSeconds = FloatParam("elastic heartbeat grace (needs "
                                     "elastic)", default=0.0, min=0.0)
    elasticMaxFailures = IntParam("elastic transient failures tolerated "
                                  "(needs elastic)", default=5, min=1)
    elasticMaxHosts = IntParam("elastic grow ceiling (needs elastic)",
                               default=0, min=0)
    stragglerEvictAfter = IntParam("elastic straggler eviction (needs "
                                   "elastic)", default=0, min=0)
    sloConfig = DictParam("SLO config evaluated during the fit; not ported "
                          "yet", default=None)
    device = StringParam(
        "torch device to train on: 'cuda' (default), 'cuda:N' or 'cpu'. "
        "Asking for CUDA where there is none raises; nothing falls back",
        default="cuda")

    # ---- set-up ----
    def _refuse_unported(self):
        for p in ("tensorParallel", "sequenceParallel", "expertParallel",
                  "pipelineParallel"):
            if self.getOrDefault(p) > 1:
                raise _not_ported(f"{p} > 1 (the port's parallel/ slice)", 12)
        if self.getElastic():
            raise _not_ported("elastic training", 13)
        if self.getCheckpointDir():
            raise _not_ported("checkpoints and bit-exact resume "
                              "(checkpointDir)", 4)
        if self.getSloConfig() is not None:
            raise _not_ported("SLO sessions (sloConfig)", 13)
        if self.getProfile():
            raise _not_ported("the device profiler (profile)", 13)

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

    # ---- training ----
    def fit(self, df: DataFrame) -> TorchModel:
        self._refuse_unported()
        dev = self._device()
        cfg = self._cfg_with_precision(dict(self.getModelConfig()))
        x, y = self._prepare_data(df, cfg)
        n = len(x)
        if n == 0:
            raise ValueError("fit on an empty DataFrame")
        # the sizes flax infers from the first batch, from the data; the
        # step reads the weights it is handed, and the module itself holds
        # none (meta), so it costs no memory and no init
        sized = sized_for(cfg, x.shape)
        with torch.device("meta"):
            module = build_model(sized)
        mixed, grad_clip, scale_state = self._precision_setup(dev)
        params = {k: v.to(device=dev, dtype=torch.float32)
                  for k, v in init_params(sized, self.getSeed()).items()}
        tx = make_optimizer(self.getOptimizer(), self.getLearningRate(),
                            self.getMomentum(), self.getWeightDecay())
        opt_state = tx.init(params)
        loss_fn = make_loss(self.getLoss(), per_example=True)
        if mixed:
            step = _make_mixed_step_body(module, tx, loss_fn, grad_clip)
        else:
            plain = _make_step_body(module, tx, loss_fn, grad_clip)

            def step(p, o, ss, xb, yb, wb):
                p, o, loss = plain(p, o, xb, yb, wb)
                return p, o, None, loss

        bs = max(1, min(self.getBatchSize(), n))
        steps = max(1, n // bs)
        data_cap = self.getDeviceDataCap() or _device_data_cap(dev)
        rng_np = np.random.default_rng(self.getSeed())
        state = (params, opt_state, scale_state)
        scan = x.nbytes + y.nbytes <= data_cap
        run = self._run_epochs_scan if scan else self._run_epochs
        with full_precision_matmuls(self.getPrecision() == "f32"):
            state, stats = run(x, y, n, bs, steps, order_rng=rng_np,
                               dev=dev, step=step, state=state)
        stats["path"] = "scan" if scan else "feed"
        if mixed:
            stats["scale_state"] = prec.scale_state_to_host(state[2])
        return self._package_model(cfg, state[0], stats)

    def _package_model(self, cfg, params, stats) -> TorchModel:
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
        raise _not_ported("fitStream (out-of-core training)", 4)

    def fitStreamCaptured(self, batches_fn, plan) -> TorchModel:
        raise _not_ported("fitStreamCaptured (fit-side capture)", 11)

    def _finish_epoch(self, epoch: int, loss, stats: dict, t0: float):
        """Epoch end: the one host read of the loss, and the divergence
        halt."""
        last = float(loss)
        stats["epoch_losses"].append(last)
        stats["epoch_seconds"].append(time.perf_counter() - t0)
        log.info("epoch %d loss %.4f", epoch, last)
        if self.getHaltOnNonFinite() and not np.isfinite(last):
            raise RuntimeError(
                f"training diverged: epoch {epoch} loss is {last} "
                f"(lr={self.getLearningRate()})")

    def _run_epochs(self, x, y, n, bs, steps, *, order_rng, dev, step,
                    state):
        """The per-step feed path: one permutation per epoch, bs rows per
        step with cyclic wrap, staged ``prefetchDepth`` steps ahead."""
        from ..parallel.prefetch import prefetched
        wb = torch.ones(bs, dtype=torch.float32, device=dev)  # every row real

        def produce():
            for epoch in range(self.getEpochs()):
                order = (order_rng.permutation(n) if self.getShuffle()
                         else np.arange(n))
                for s in range(steps):
                    idx = order[(s * bs + np.arange(bs)) % n]
                    yield (epoch, s, _to_device(x[idx], dev),
                           _to_device(y[idx], dev))

        stats = {"epoch_losses": [], "epoch_seconds": [],
                 "steps_per_epoch": steps, "batch_rows": bs}
        params, opt_state, scale_state = state
        it = prefetched(produce, depth=self.getPrefetchDepth(),
                        name="fit-feed")
        t0 = time.perf_counter()
        try:
            for epoch, s, xb, yb in it:
                params, opt_state, scale_state, loss = step(
                    params, opt_state, scale_state, xb, yb, wb)
                if s == steps - 1:
                    self._finish_epoch(epoch, loss, stats, t0)
                    t0 = time.perf_counter()
        finally:
            it.close()
        return (params, opt_state, scale_state), stats

    def _run_epochs_scan(self, x, y, n, bs, steps, *, order_rng, dev, step,
                         state):
        """The device-resident path: the epoch (padded to ``steps * bs``
        rows, pad rows weight 0, plus a bs-row wrap margin) lives on the
        device, and each step is a window of it."""
        # one device: the data axis is 1, so the batch needs no rounding;
        # ceil instead of the feed path's floor, so windows cover every row
        steps = max(1, -(-n // bs))
        n_pad = steps * bs
        # windows slice the RESIDENT order, so it must be random: small
        # datasets get a fresh permutation per epoch, big ones permute once
        # at upload and vary by rotation + window order
        reshuffle = (self.getShuffle()
                     and x.nbytes + y.nbytes <= (self.getEpochReshuffleCap()
                                                 or _EPOCH_RESHUFFLE_CAP))
        if self.getShuffle() and not reshuffle:
            perm0 = order_rng.permutation(n)
            x, y = x[perm0], y[perm0]
        w_all = np.zeros(n_pad, dtype=np.float32)
        w_all[:n] = 1.0

        def upload(a):
            ap = _wrap_rows(a, n_pad)
            return _to_device(np.concatenate([ap, ap[:bs]], axis=0), dev)

        if not reshuffle:
            x_dev, y_dev = upload(x), upload(y)
        w_dev = upload(w_all)
        base = np.arange(steps, dtype=np.int32) * bs
        stats = {"epoch_losses": [], "epoch_seconds": [],
                 "steps_per_epoch": steps, "batch_rows": bs}
        params, opt_state, scale_state = state
        for epoch in range(self.getEpochs()):
            t0 = time.perf_counter()
            if reshuffle:
                perm = order_rng.permutation(n)
                x_dev, y_dev = upload(x[perm]), upload(y[perm])
                starts = base
            elif self.getShuffle():
                starts = ((base[order_rng.permutation(steps)]
                           + order_rng.integers(0, n_pad)) % n_pad) \
                    .astype(np.int32)
            else:
                starts = base
            # eager steps over windows of the resident epoch, the state
            # never leaving the device
            for o in starts.tolist():
                params, opt_state, scale_state, loss = step(
                    params, opt_state, scale_state, x_dev[o:o + bs],
                    y_dev[o:o + bs], w_dev[o:o + bs])
            self._finish_epoch(epoch, loss, stats, t0)
        return (params, opt_state, scale_state), stats
