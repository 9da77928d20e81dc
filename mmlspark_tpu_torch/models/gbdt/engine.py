"""Gradient-boosted decision trees in PyTorch: the port of
``mmlspark_tpu/models/gbdt/engine.py``'s level-wise serial engine.

The LightGBM replacement (reference: src/lightgbm — the
LGBM_BoosterUpdateOneIter loop at TrainUtils.scala:63-77). As in the JAX
engine:

  * features are quantile-binned once to uint8 bins (maxBin=255); the bin
    matrix stays uint8 on the device, and is transposed once per fit for
    the histogram kernel;
  * trees grow LEVEL-WISE to a fixed depth — every level is one histogram
    build over all of the level's nodes plus a vectorized split-gain
    argmax;
  * multiclass trains K trees per iteration, one per class gradient.

Trees are stored heap-ordered in dense arrays (node i -> children 2i+1 and
2i+2), so prediction is ``depth`` gathers per tree, or one launch of the
quantized predict kernel for the whole ensemble.

Everything runs eagerly on the fit's device: "cuda" by default, "cpu" when
the caller asks. On CUDA the histograms run in the hand-written kernels of
``ops/gbdt_kernels.py``, and binning runs on the card; on the CPU the
kernels' plain versions run and binning runs in numpy. Randomness (bagging,
feature masks, the early-stopping holdout) comes from seeded numpy
generators in the JAX engine's order, so the draws match it.

Not ported yet, each raising NotImplementedError: leaf-wise growth
(``num_leaves > 0``, with categorical splits: ROADMAP slice 4), a mesh or
a multi-process fit (ROADMAP item 12), ``fit_gbdt_elastic`` and the
telemetry gauges and spans (item 13), and ``traced_raw_levelwise`` (item
11).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import gbdt_kernels as gk

_SLICE_4 = ("leaf-wise growth (num_leaves > 0, categorical set splits, EFB "
            "bundles) is not ported yet: ROADMAP.md slice 4 (Queue 1 item 7)")


class GBDTParams(NamedTuple):
    num_iterations: int = 100
    learning_rate: float = 0.1
    max_depth: int = 5              # numLeaves ~ 2^max_depth (level-wise)
    max_bin: int = 255
    lambda_l2: float = 1.0
    lambda_l1: float = 0.0
    min_child_weight: float = 1e-3
    min_split_gain: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    objective: str = "binary"       # binary|regression|quantile|mae|multiclass
    alpha: float = 0.9              # quantile level
    num_class: int = 1
    seed: int = 0
    early_stopping_round: int = 0
    boosting_type: str = "gbdt"     # gbdt | rf (bagged trees, LightGBM rf mode)
    hist_impl: str = "auto"   # auto | mxu | compare | segment | pallas
                              # (auto = the node-histogram kernel on CUDA,
                              # the compare hybrid on the CPU)
    # LightGBM tree_learner: on one card every fit is serial (the
    # distributed learners wait for the parallel/ port, ROADMAP item 12)
    tree_learner: str = "data"      # data | feature | auto | serial
    num_leaves: int = 0             # > 0: leaf-wise growth (slice 4)
    categorical_feature: tuple = ()
    cat_smooth: float = 10.0


class TreeEnsemble(NamedTuple):
    """All trees of a fitted booster, dense heap layout.

    feature:  (T, K, 2^depth-1) int32 tensor — split feature per node
    threshold:(T, K, 2^depth-1) int32 tensor — split bin (right if bin > thr)
    leaf:     (T, K, 2^depth)   f32 tensor   — leaf values (lr applied)
    bin_edges:(d, max_bin-1)    f32 ndarray  — quantile edges for new data
    base:     (K,)              f32 ndarray  — initial raw score
    objective: str
    """
    feature: torch.Tensor
    threshold: torch.Tensor
    leaf: torch.Tensor
    bin_edges: np.ndarray
    base: np.ndarray
    objective: str


def torch_device(name) -> torch.device:
    """The device an entry point runs on: cuda (which must exist) or cpu."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(name)!r} but torch sees no CUDA "
                           f"device; set device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"GBDT runs on cuda or cpu, not {dev}")
    return dev


# ------------------------------------------------------------------ binning

def compute_bin_edges(x: np.ndarray, max_bin: int,
                      sample_cap: int = 200_000, seed: int = 0) -> np.ndarray:
    """Per-feature quantile edges, shape (d, max_bin-1). NaNs ignored. Above
    ``sample_cap`` rows the edges come from a seeded row sample, as LightGBM
    does (bin_construct_sample_cnt=200k)."""
    if x.shape[0] > sample_cap:
        idx = np.random.default_rng(seed).choice(x.shape[0], sample_cap,
                                                 replace=False)
        x = x[idx]
    qs = np.linspace(0, 1, max_bin + 1)[1:-1]
    edges = np.nanquantile(x.astype(np.float64), qs, axis=0).T  # (d, B-1)
    return np.ascontiguousarray(edges.astype(np.float32))


def bin_data(x: np.ndarray, edges: np.ndarray,
             cat_features: Optional[np.ndarray] = None,
             max_bin: int = 256) -> np.ndarray:
    """(n, d) floats -> (n, d) uint8 bin ids in [0, max_bin) on the host.
    NaN -> bin 0; ties take the lower bin (searchsorted side='left').
    Categorical columns (``cat_features`` (d,) bool) bin by identity,
    clipped to the bin range."""
    n, d = x.shape
    out = np.empty((n, d), dtype=np.uint8)
    xf = x.astype(np.float32)
    for j in range(d):
        if cat_features is not None and cat_features[j]:
            with np.errstate(invalid="ignore"):
                out[:, j] = np.clip(np.nan_to_num(xf[:, j]), 0,
                                    max_bin - 1).astype(np.uint8)
        else:
            out[:, j] = np.searchsorted(edges[j], xf[:, j], side="left")
    out[np.isnan(xf)] = 0
    return out


#: rows per device binning slab (~112 MB of f32 at d=28)
_BIN_SLAB = 1 << 20


def bin_data_device(x: np.ndarray, edges: np.ndarray,
                    cat_features: Optional[np.ndarray] = None,
                    max_bin: int = 256, device="cuda",
                    slab: int = _BIN_SLAB) -> torch.Tensor:
    """``bin_data`` computed on ``device`` with ``torch.searchsorted``
    (side='left' per feature, NaN -> 0, categorical identity), in slabs of
    rows, bit for bit. Returns the (n, d) uint8 tensor on the device; only
    the f32 rows go up, nothing comes back."""
    dev = torch.device(device)
    n, d = x.shape
    edges_t = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(dev)
    # a NaN edge (nanquantile over infinities) sorts last in numpy; +inf
    # takes its place exactly in a side='left' search
    edges_t = torch.where(torch.isnan(edges_t), torch.inf, edges_t)
    cat = torch.from_numpy(np.asarray(
        cat_features if cat_features is not None else np.zeros(d, bool),
        dtype=bool)).to(dev)
    out = torch.empty((n, d), dtype=torch.uint8, device=dev)
    for start in range(0, n, slab):
        xs = torch.from_numpy(np.ascontiguousarray(
            x[start:start + slab], dtype=np.float32)).to(dev)
        ids = torch.searchsorted(edges_t, xs.T.contiguous(), side="left").T
        catv = torch.nan_to_num(xs).clamp(0, max_bin - 1).to(torch.uint8)
        b = torch.where(cat[None, :], catv, ids.to(torch.uint8))
        out[start:start + len(xs)] = torch.where(torch.isnan(xs), 0, b)
    return out


def bin_data_auto(x: np.ndarray, edges: np.ndarray,
                  cat_features: Optional[np.ndarray] = None,
                  max_bin: int = 256, device="cuda") -> torch.Tensor:
    """The (n, d) uint8 bin matrix as a tensor on ``device``: binned on the
    card when the device is CUDA, in numpy on the CPU.
    ``MMLTPU_GBDT_BINNING=host|device`` overrides (device binning on a CPU
    device runs torch.searchsorted on the CPU)."""
    mode = os.environ.get("MMLTPU_GBDT_BINNING", "auto")
    if mode not in ("auto", "host", "device"):
        raise ValueError(f"MMLTPU_GBDT_BINNING must be auto|host|device, "
                         f"got {mode!r}")
    dev = torch.device(device)
    if mode == "device" or (mode == "auto" and dev.type == "cuda"):
        return bin_data_device(x, edges, cat_features, max_bin, dev)
    return torch.from_numpy(bin_data(x, edges, cat_features, max_bin)).to(dev)


# ------------------------------------------------------------- tree builder

def _histograms(bins, bins_t, g, h, node, n_nodes: int, n_bins: int,
                hist_impl: str):
    """(node, feature, bin) grad/hess histograms, (n_nodes, d, n_bins):

    * ``mxu``: the node-histogram kernel over ``bins_t`` (d, n) uint8, up
      to 64 nodes (deeper levels fall back to the segment scatter, as in
      the JAX engine);
    * ``segment``: one flat scatter-add over combined node*n_bins + bin ids;
    * ``compare``: per-bin masked sums for id spaces of at most 256 ids;
    * ``pallas``: the v1 fused-histogram kernel over the combined ids."""
    d = bins.shape[1]
    if hist_impl == "mxu" and n_nodes <= 64:
        return gk.mxu_node_histogram(bins_t, node, g, h, n_nodes=n_nodes,
                                     n_bins=n_bins)
    comb = node[:, None] * n_bins + bins.to(torch.int32)
    if hist_impl == "pallas":
        build = gk.histogram_fused
    elif hist_impl == "compare" and n_nodes * n_bins <= 256:
        build = gk.compare_reduce_histogram
    else:
        build = gk.segment_histogram
    hg, hh = build(comb, g, h, n_bins=n_nodes * n_bins)
    return (hg.reshape(d, n_nodes, n_bins).transpose(0, 1),
            hh.reshape(d, n_nodes, n_bins).transpose(0, 1))


def _soft(gsum, lambda_l1):
    """sign(g) * max(|g| - l1, 0): the L1-regularized gradient sum."""
    return torch.sign(gsum) * torch.clamp(gsum.abs() - lambda_l1, min=0.0)


def _best_splits(hg, hh, feat_mask, n_bins: int, lambda_l2, lambda_l1,
                 min_child_weight):
    """Vectorized split-gain argmax over (node, feature, bin) histograms.
    hg/hh (n_nodes, d, n_bins); feat_mask (d,). Returns (best_gain,
    best_feat, best_bin), each (n_nodes,). Ties and NaN take the first
    index, as jnp.argmax does; a node with no valid split gets -inf at
    index 0."""
    n_nodes, d, _ = hg.shape
    gl = torch.cumsum(hg, dim=2)
    hl = torch.cumsum(hh, dim=2)
    gt = gl[:, :, -1:]
    ht = hl[:, :, -1:]
    gr = gt - gl
    hr = ht - hl

    def score(gsum, hsum):
        gs = _soft(gsum, lambda_l1)
        return gs * gs / (hsum + lambda_l2)

    gain = score(gl, hl) + score(gr, hr) - score(gt, ht)
    valid = ((hl >= min_child_weight) & (hr >= min_child_weight)
             & (feat_mask[None, :, None] > 0))
    gain = torch.where(valid, gain, -torch.inf)
    flat = gain.reshape(n_nodes, d * n_bins)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    return (best_gain, (best // n_bins).to(torch.int32),
            (best % n_bins).to(torch.int32))


def _grow_tree(bins, bins_t, g, h, feat_mask, depth: int, n_bins: int,
               lambda_l2, lambda_l1, min_child_weight, min_split_gain,
               hist_impl: str):
    """One level-wise tree. Returns (feature (2^depth-1,), threshold
    (2^depth-1,) with n_bins marking "no split", leaf (2^depth,), node (n,)
    — each training row's leaf, so the boosting loop's raw update is a
    table gather)."""
    n = bins.shape[0]
    dev = bins.device
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    feat_arr = torch.zeros(2 ** depth - 1, dtype=torch.int32, device=dev)
    thr_arr = torch.full((2 ** depth - 1,), n_bins, dtype=torch.int32,
                         device=dev)
    for level in range(depth):
        n_nodes = 2 ** level
        hg, hh = _histograms(bins, bins_t, g, h, node, n_nodes, n_bins,
                             hist_impl)
        best_gain, bf, bb = _best_splits(hg, hh, feat_mask, n_bins,
                                         lambda_l2, lambda_l1,
                                         min_child_weight)
        # nodes with no usable split route everything left (thr = n_bins)
        use = best_gain > min_split_gain
        bf = torch.where(use, bf, 0)
        bb = torch.where(use, bb, n_bins)
        off = 2 ** level - 1
        feat_arr[off:off + n_nodes] = bf
        thr_arr[off:off + n_nodes] = bb
        nl = node.long()
        vals = bins.gather(1, bf.long()[nl][:, None])[:, 0]
        go_right = vals.to(torch.int32) > bb[nl]
        node = node * 2 + go_right.to(torch.int32)
    lg, lh = gk.node_sums(node, g, h, 2 ** depth, impl=hist_impl)
    leaf = -_soft(lg, lambda_l1) / (lh + lambda_l2)
    return feat_arr, thr_arr, leaf, node


def _build_tree_impl(bins, bins_t, grad, hess, row_mask, feat_mask,
                     depth: int, n_bins: int, lambda_l2, lambda_l1,
                     min_child_weight, min_split_gain,
                     hist_impl: str = "segment"):
    """One level-wise tree for one output class; bagging through
    ``row_mask`` (n,), feature fraction through ``feat_mask`` (d,)."""
    return _grow_tree(bins, bins_t, grad * row_mask, hess * row_mask,
                      feat_mask, depth, n_bins, lambda_l2, lambda_l1,
                      min_child_weight, min_split_gain, hist_impl)


def _build_tree_multi(bins, bins_t, grad, hess, row_mask, feat_mask, *,
                      depth: int, n_bins: int, lambda_l2, lambda_l1,
                      min_child_weight, min_split_gain,
                      hist_impl: str = "segment"):
    """K trees per boosting iteration over the class axis of grad/hess,
    stacked: (feature (K, .), threshold, leaf, node (K, n))."""
    builds = [_build_tree_impl(bins, bins_t, grad[:, k], hess[:, k],
                               row_mask, feat_mask, depth, n_bins, lambda_l2,
                               lambda_l1, min_child_weight, min_split_gain,
                               hist_impl)
              for k in range(grad.shape[1])]
    return tuple(torch.stack(parts) for parts in zip(*builds))


def _gather_tree_contrib(lv, node):
    """(K, L) leaf tables + (K, n) per-row leaf ids -> (n, K) raw-score
    contributions (the training-raw update)."""
    return torch.stack([lv[k][node[k].long()] for k in range(lv.shape[0])],
                       dim=1)


def _boost_step_level(bins, bins_t, raw, y, row_mask, feat_mask, lr, alpha,
                      *, depth: int, n_bins: int, lambda_l2, lambda_l1,
                      min_child_weight, min_split_gain, hist_impl: str,
                      objective: str, num_class: int, update_raw: bool):
    """One serial boosting iteration: gradients, the tree build and the
    training-raw update (``update_raw=False``, rf mode, keeps raw fixed)."""
    g, h = _grad_hess(raw, y, objective, num_class, alpha)
    f, t, lv, node = _build_tree_multi(
        bins, bins_t, g, h, row_mask, feat_mask, depth=depth, n_bins=n_bins,
        lambda_l2=lambda_l2, lambda_l1=lambda_l1,
        min_child_weight=min_child_weight, min_split_gain=min_split_gain,
        hist_impl=hist_impl)
    lv = lv * lr
    if update_raw:
        raw = raw + _gather_tree_contrib(lv, node)
    return raw, f, t, lv, node


def _predict_tree_t(bins_t, feature, threshold, leaf, depth: int):
    """One level-wise tree over the transposed bin matrix (d, n) -> (n,)
    leaf values: per level, each row's node test (bin > threshold, int32
    compares, so the n_bins "no split" sentinel routes left)."""
    n = bins_t.shape[1]
    feature = feature.long()
    pos = torch.zeros(n, dtype=torch.long, device=bins_t.device)
    for level in range(depth):
        node = 2 ** level - 1 + pos
        vals = bins_t.gather(0, feature[node][None, :])[0]
        pos = pos * 2 + (vals.to(torch.int32) > threshold[node]).long()
    return leaf[pos]


def _predict_tree(bins, feature, threshold, leaf, depth: int):
    """bins (n, d); tree arrays for one class -> (n,) leaf values."""
    return _predict_tree_t(bins.T, feature, threshold, leaf, depth)


# ------------------------------------------------------------- objectives

def _init_score(y: np.ndarray, p: GBDTParams) -> np.ndarray:
    if p.objective == "binary":
        pos = np.clip(y.mean(), 1e-6, 1 - 1e-6)
        return np.array([np.log(pos / (1 - pos))], dtype=np.float32)
    if p.objective == "multiclass":
        return np.zeros(p.num_class, dtype=np.float32)
    if p.objective == "quantile":
        return np.array([np.quantile(y, p.alpha)], dtype=np.float32)
    if p.objective == "mae":
        return np.array([np.median(y)], dtype=np.float32)
    return np.array([y.mean()], dtype=np.float32)  # regression l2


def _f32(value):
    """A float32 0-d tensor, so 1 - alpha is taken in float32 as JAX takes
    it for a traced float argument. It stays on the host: a 0-d CPU tensor
    combines with device tensors without a copy to the card."""
    return torch.tensor(value, dtype=torch.float32)


def _grad_hess(raw, y, objective: str, num_class: int, alpha):
    """raw (n, K), y (n,) -> grad/hess (n, K) float32."""
    if objective == "binary":
        prob = torch.sigmoid(raw[:, 0])
        g = (prob - y)[:, None]
        h = (prob * (1 - prob))[:, None]
    elif objective == "multiclass":
        prob = torch.softmax(raw, dim=1)
        onehot = torch.nn.functional.one_hot(y.long(), num_class).to(
            raw.dtype)
        g = prob - onehot
        h = prob * (1 - prob)
    elif objective == "quantile":
        a = _f32(alpha)
        err = y - raw[:, 0]
        g = torch.where(err >= 0, -a, 1.0 - a)[:, None]
        h = torch.ones_like(g)
    elif objective == "mae":
        g = torch.sign(raw[:, 0] - y)[:, None]
        h = torch.ones_like(g)
    else:  # regression (l2)
        g = (raw[:, 0] - y)[:, None]
        h = torch.ones_like(g)
    return g.float(), h.float()


def _loss(raw, y, objective: str, alpha):
    """Mean training loss (a 0-d tensor)."""
    if objective == "binary":
        z = raw[:, 0]
        return torch.mean(torch.logaddexp(torch.zeros_like(z), z) - y * z)
    if objective == "multiclass":
        logp = torch.log_softmax(raw, dim=1)
        return -torch.mean(logp.gather(1, y.long()[:, None]))
    if objective == "quantile":
        a = _f32(alpha)
        err = y - raw[:, 0]
        return torch.mean(torch.maximum(a * err, (a - 1) * err))
    if objective == "mae":
        return torch.mean((raw[:, 0] - y).abs())
    return 0.5 * torch.mean((raw[:, 0] - y) ** 2)


# ------------------------------------------------------------------ fitting

def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host-side wait: a copy from
    pageable memory synchronises the stream before it starts, one from
    pinned memory is queued behind the card's work."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def fit_gbdt(x: np.ndarray, y: np.ndarray, params: GBDTParams,
             mesh=None, sample_weight: Optional[np.ndarray] = None,
             eval_set: Optional[tuple] = None, elastic_ctx=None,
             binned: Optional[tuple] = None,
             device="cuda") -> TreeEnsemble:
    """Train a level-wise boosted ensemble on one device (cuda unless the
    caller asks for "cpu").

    ``sample_weight`` (n,) masks or weights rows (weight 0 rows neither
    train nor enter the bin edges and the init score); ``eval_set=(x, y)``
    is the early-stopping holdout, else ``early_stopping_round > 0`` holds
    out a seeded fifth of the rows; ``binned=(bins, edges)`` supplies an
    already-binned (n, d) uint8 matrix (numpy or tensor) and its edges
    (pass x=None). A ``mesh``, ``elastic_ctx`` or ``num_leaves > 0`` raise
    NotImplementedError naming the ROADMAP item that ports them."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded GBDT fits (tree_learner data/feature/auto over "
            "several devices) wait for the parallel/ port: ROADMAP.md "
            "Queue 1 item 12")
    if elastic_ctx is not None:
        raise NotImplementedError(
            "elastic boosted fits wait for the resilience/ port: ROADMAP.md "
            "Queue 1 item 13")
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process GBDT fits wait for the parallel/ port: ROADMAP.md "
            "Queue 1 item 12")
    return _fit_gbdt_impl(x, y, params, sample_weight=sample_weight,
                          eval_set=eval_set, binned=binned,
                          device=torch_device(device))


def fit_gbdt_elastic(*args, **kwargs):
    raise NotImplementedError(
        "fit_gbdt_elastic waits for the resilience/ port: ROADMAP.md Queue 1 "
        "item 13")


def _fit_gbdt_impl(x, y, params: GBDTParams, *, sample_weight, eval_set,
                   binned, device: torch.device) -> TreeEnsemble:
    p = params
    if binned is not None:
        if eval_set is not None:
            raise ValueError(
                "binned fits draw their early-stopping holdout from the "
                "binned matrix itself; a raw-feature eval_set would need "
                "the skipped binner — pass eval_set=None")
        bins_in, edges = binned[0], np.asarray(binned[1])
        n, d = bins_in.shape
    else:
        n, d = x.shape
    if p.tree_learner not in ("serial", "data", "feature", "auto"):
        raise ValueError(f"unknown tree_learner {p.tree_learner!r}; expected "
                         "serial|data|feature|auto")
    if p.hist_impl not in ("auto", "mxu", "compare", "segment", "pallas"):
        raise ValueError(f"unknown hist_impl {p.hist_impl!r}; expected "
                         "auto|mxu|compare|segment|pallas")
    if not 2 <= p.max_bin <= 256:
        raise ValueError(f"max_bin must be in [2, 256] (uint8 bin ids; "
                         f"LightGBM's own ceiling is 255), got {p.max_bin}")
    if p.num_leaves > 0:
        raise NotImplementedError(_SLICE_4)
    if p.categorical_feature:
        raise ValueError("categorical_feature requires leaf-wise growth "
                         "(set num_leaves > 0)")
    K = p.num_class if p.objective == "multiclass" else 1
    is_rf = p.boosting_type == "rf"
    if is_rf and not ((p.bagging_fraction < 1.0 and p.bagging_freq > 0)
                      or p.feature_fraction < 1.0):
        raise ValueError("boosting_type='rf' without bagging or feature "
                         "subsampling trains identical trees; set "
                         "bagging_fraction<1 + bagging_freq>=1 (LightGBM "
                         "rejects this combination too)")
    # auto: the node-histogram kernel on CUDA, the compare hybrid on the CPU
    hist_impl = p.hist_impl
    if hist_impl == "auto":
        hist_impl = "mxu" if device.type == "cuda" else "compare"
    # global statistics (bin edges, init score) come from real rows only
    real = slice(None) if sample_weight is None else sample_weight > 0
    if binned is None:
        edges = compute_bin_edges(x[real], p.max_bin)
        bins = bin_data_auto(x, edges, None, p.max_bin, device)
    else:
        bins = torch.as_tensor(np.asarray(bins_in) if not isinstance(
            bins_in, torch.Tensor) else bins_in).to(device, torch.uint8)
    bins_t = bins.T.contiguous()              # once per fit, for the kernel
    base = _init_score(y[real], p)
    raw = torch.from_numpy(np.broadcast_to(base[None, :], (n, K)).astype(
        np.float32)).to(device)
    yj = torch.from_numpy(np.asarray(y, np.float32)).to(device)

    # per-row randomness (bagging, holdout) and the feature mask draw from
    # separate streams, seeded as in the JAX engine
    rng = np.random.default_rng(p.seed)
    feat_rng = np.random.default_rng(p.seed ^ 0x5EED)
    feats, thrs, leaves = [], [], []
    best_loss, since_best, best_iter = np.inf, 0, None
    if is_rf:
        # rf averages a fixed-size forest: early stopping does not apply
        p = p._replace(early_stopping_round=0)
    if p.early_stopping_round > 0 and eval_set is None:
        candidates = (np.arange(n) if sample_weight is None
                      else np.flatnonzero(sample_weight > 0))
        idx = rng.permutation(candidates)
        n_val = max(1, len(candidates) // 5)
        hold = torch.from_numpy(idx[:n_val]).to(device)
        eval_set = (bins[hold] if binned is not None else x[idx[:n_val]],
                    y[idx[:n_val]])
        holdout = np.ones(n, dtype=np.float32)
        holdout[idx[:n_val]] = 0.0
        sample_weight = (holdout if sample_weight is None
                         else sample_weight * holdout)
    if eval_set is not None:
        bins_val = (eval_set[0] if binned is not None else bin_data_auto(
            np.asarray(eval_set[0], dtype=np.float32), edges, None,
            p.max_bin, device))
        bins_val_t = bins_val.T.contiguous()
        y_val = torch.from_numpy(np.asarray(eval_set[1], np.float32)).to(
            device)
        raw_val = torch.from_numpy(np.broadcast_to(
            base[None, :], (bins_val.shape[0], K)).astype(np.float32)).to(
                device)

    bagging = p.bagging_fraction < 1.0 and p.bagging_freq > 0
    # the row and feature masks live on the device and are shipped only
    # when they change, without waiting for the card (_to_device), so the
    # host queues the next iteration while the card runs this one
    rm = None
    fm = (None if p.feature_fraction < 1.0
          else _to_device(np.ones(d, dtype=np.float32), device))
    lr_eff = 1.0 if is_rf else p.learning_rate
    for it in range(p.num_iterations):
        if bagging:
            if it % p.bagging_freq == 0:
                bag_mask = (rng.random(n) < p.bagging_fraction).astype(
                    np.float32)
                row_mask = (bag_mask if sample_weight is None
                            else bag_mask * sample_weight.astype(np.float32))
                rm = _to_device(row_mask, device)
        elif rm is None:
            row_mask = (np.ones(n, dtype=np.float32) if sample_weight is None
                        else sample_weight.astype(np.float32))
            rm = _to_device(row_mask, device)
        if p.feature_fraction < 1.0:
            keep = feat_rng.random(d) < p.feature_fraction
            if not keep.any():
                keep[feat_rng.integers(0, d)] = True
            fm = _to_device(keep.astype(np.float32), device)
        raw, f, t, lv, _ = _boost_step_level(
            bins, bins_t, raw, yj, rm, fm,
            lr_eff, p.alpha, depth=p.max_depth, n_bins=p.max_bin,
            lambda_l2=p.lambda_l2, lambda_l1=p.lambda_l1,
            min_child_weight=p.min_child_weight,
            min_split_gain=p.min_split_gain, hist_impl=hist_impl,
            objective=p.objective, num_class=K, update_raw=not is_rf)
        feats.append(f)
        thrs.append(t)
        leaves.append(lv)
        if p.early_stopping_round > 0:
            raw_val = raw_val + torch.stack(
                [_predict_tree_t(bins_val_t, f[k], t[k], lv[k], p.max_depth)
                 for k in range(K)], dim=1)
            cur = float(_loss(raw_val, y_val, p.objective, p.alpha))
            if cur < best_loss - 1e-9:
                best_loss, since_best, best_iter = cur, 0, it + 1
            else:
                since_best += 1
                if since_best >= p.early_stopping_round:
                    break

    if best_iter is not None:
        feats, thrs, leaves = (feats[:best_iter], thrs[:best_iter],
                               leaves[:best_iter])
    if is_rf:
        leaves = [lv / len(leaves) for lv in leaves]
    return TreeEnsemble(
        feature=torch.stack(feats), threshold=torch.stack(thrs),
        leaf=torch.stack(leaves), bin_edges=edges, base=base,
        objective=p.objective)


# ------------------------------------------------------------------ predict

#: rows per scoring chunk keep the staging under this many bytes per row
#: class (1 byte per node test per row on the dense path; the bin row plus
#: the float32 output on the quantized path)
_PREDICT_TABLE_BYTES_CAP = 256 << 20


def _predict_chunk_rows(n: int, table_nodes: int) -> int:
    """Rows per scoring chunk keeping the staging under the byte cap;
    small calls stay one chunk."""
    cap = max(4096, _PREDICT_TABLE_BYTES_CAP // max(1, table_nodes))
    return n if n <= cap else cap


def _predict_chunked(bins_t, score_chunk, table_nodes: int) -> torch.Tensor:
    """Score (d, n) rows in chunks of :func:`_predict_chunk_rows`."""
    n = bins_t.shape[1]
    chunk = _predict_chunk_rows(n, table_nodes)
    if n <= chunk:
        return score_chunk(bins_t)
    return torch.cat([score_chunk(bins_t[:, lo:lo + chunk].contiguous())
                      for lo in range(0, n, chunk)], dim=0)


def quantize_leaves_int8(leaf: np.ndarray):
    """f32 leaf table (T, K, L) -> per-(tree, class) symmetric int8:
    ``(q int8 (T,K,L), scale f32 (T,K,1))`` with ``q * scale ~= leaf``."""
    leaf = np.asarray(leaf, np.float32)
    amax = np.abs(leaf).max(axis=2, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.rint(leaf / scale).astype(np.int8)
    return q, scale


def dequant_leaf(leaf) -> torch.Tensor:
    """Widen a stored leaf table to the float32 the predict kernel takes:
    bf16 tables widen exactly; ``(int8, scale)`` pairs dequantize."""
    if isinstance(leaf, tuple):
        q, scale = leaf
        return torch.as_tensor(q).float() * torch.as_tensor(scale)
    return torch.as_tensor(leaf).float()


def quantize_ensemble(ens: TreeEnsemble, num_iteration: Optional[int] = None,
                      leaf_dtype: str = "bf16"):
    """Level-wise ensemble -> ``(feature uint8 (T,K,N), threshold uint8
    (T,K,N), leaf)``, leaf a bf16 (T,K,L) tensor (``'bf16'``) or a
    per-tree-scaled numpy ``(int8 (T,K,L), f32 scale (T,K,1))`` pair
    (``'int8'``). Thresholds clamp to 255: against uint8 bins both the
    n_bins "no split" sentinel and 255 route nothing right. The leaf
    round is the one lossy step."""
    if leaf_dtype not in ("bf16", "int8"):
        raise ValueError(f"leaf_dtype must be bf16|int8, got {leaf_dtype!r}")
    T = ens.feature.shape[0]
    T = min(T, num_iteration) if num_iteration else T
    d = ens.bin_edges.shape[0]
    if d > 256:
        raise ValueError(f"quantized predict tables need <= 256 features "
                         f"(uint8 feature ids), got {d}")
    feat = torch.as_tensor(ens.feature[:T]).to(torch.uint8)
    thr = torch.as_tensor(ens.threshold[:T]).clamp(max=255).to(torch.uint8)
    if leaf_dtype == "int8":
        leaf = quantize_leaves_int8(
            torch.as_tensor(ens.leaf[:T]).cpu().numpy())
    else:
        leaf = torch.as_tensor(ens.leaf[:T]).to(torch.bfloat16)
    return feat, thr, leaf


def _resolve_predict_impl(requested: str, eligible: bool, why: str,
                          device: torch.device) -> str:
    """auto|dense|pallas|pallas_int8 -> the impl that will run. "pallas"
    names the quantized predict kernel (the CUDA kernel here, its plain
    version on the CPU). 'auto' takes it only on CUDA and only for an
    eligible ensemble; an explicit request on an ineligible one raises."""
    if requested not in ("auto", "dense", "pallas", "pallas_int8"):
        raise ValueError(f"predict_impl must be auto|dense|pallas|"
                         f"pallas_int8, got {requested!r}")
    if requested == "dense":
        return "dense"
    if requested in ("pallas", "pallas_int8"):
        if not eligible:
            raise ValueError(f"predict_impl={requested!r} unavailable: "
                             f"{why}")
        return requested
    return "pallas" if eligible and device.type == "cuda" else "dense"


def _quant_eligible_levelwise(ens: TreeEnsemble, depth: int):
    d = ens.bin_edges.shape[0]
    if d > 256:
        return False, f"{d} features exceed the uint8 feature-id space"
    if 2 ** depth - 1 > gk.PREDICT_QUANT_MAX_NODES \
            or 2 ** depth > gk.PREDICT_QUANT_MAX_LEAVES:
        return False, (f"depth {depth} exceeds the kernel's unroll cap "
                       f"({gk.PREDICT_QUANT_MAX_NODES} nodes)")
    return True, ""


def _predict_quant_levelwise(ens: TreeEnsemble, bins_t, T: int, depth: int,
                             leaf_dtype: str = "bf16") -> torch.Tensor:
    """The quantized scoring path: uint8 tables and bf16 or int8 leaves
    (widened to float32) walked by the predict kernel in one launch per
    chunk, plus the base score."""
    dev = bins_t.device
    feat, thr, leaf = quantize_ensemble(ens, T, leaf_dtype=leaf_dtype)
    feat, thr = feat.to(dev), thr.to(dev)
    leaf_f32 = dequant_leaf(leaf).to(dev)
    K = feat.shape[1]
    base = torch.from_numpy(np.asarray(ens.base, np.float32)).to(dev)[None]

    def score(part):
        return gk.gbdt_predict_quant_levelwise(part, feat, thr, leaf_f32,
                                               depth=depth) + base
    return _predict_chunked(bins_t, score, bins_t.shape[0] + 4 * K)


def _ens_device(ens, device) -> torch.device:
    if device is not None:
        return torch_device(device)
    if isinstance(ens.feature, torch.Tensor):
        return ens.feature.device
    return torch_device("cuda")


def predict_raw(ens: TreeEnsemble, x: np.ndarray,
                num_iteration: Optional[int] = None,
                predict_impl: str = "auto", device=None) -> np.ndarray:
    """Raw ensemble scores (n, K) float32. ``device`` defaults to the
    ensemble's own (cuda for host arrays). ``predict_impl``: 'dense' walks
    the int32/f32 trees tree by tree; 'pallas' runs the quantized predict
    kernel (uint8 tables, bf16 leaves); 'pallas_int8' the same with
    per-tree-scaled int8 leaves; 'auto' the kernel on CUDA when the
    ensemble fits its caps, else dense."""
    if not isinstance(ens, TreeEnsemble):
        raise NotImplementedError(_SLICE_4)
    dev = _ens_device(ens, device)
    bins_t = bin_data_auto(x, ens.bin_edges, device=dev).T.contiguous()
    T, K, _ = ens.feature.shape
    depth = int(np.log2(ens.leaf.shape[2]))
    T = min(T, num_iteration) if num_iteration else T
    eligible, why = _quant_eligible_levelwise(ens, depth)
    resolved = _resolve_predict_impl(predict_impl, eligible, why, dev)
    if resolved in ("pallas", "pallas_int8"):
        return _predict_quant_levelwise(
            ens, bins_t, T, depth,
            leaf_dtype="int8" if resolved == "pallas_int8" else "bf16"
        ).cpu().numpy()
    feature = torch.as_tensor(ens.feature[:T]).to(dev)
    threshold = torch.as_tensor(ens.threshold[:T]).to(dev)
    leaf = torch.as_tensor(ens.leaf[:T]).to(dev)
    base = torch.from_numpy(np.asarray(ens.base, np.float32)).to(dev)

    def score(part):
        raw = base[None, :].expand(part.shape[1], K).clone()
        for t in range(T):
            raw = raw + torch.stack(
                [_predict_tree_t(part, feature[t, k], threshold[t, k],
                                 leaf[t, k], depth) for k in range(K)], dim=1)
        return raw
    nodes = 2 ** depth - 1
    return _predict_chunked(bins_t, score, max(nodes, 1)).cpu().numpy()


def traced_raw_levelwise(params: dict, x, depth: int, K: int):
    raise NotImplementedError(
        "traced_raw_levelwise is the pipeline-capture body; it waits for "
        "the core/capture.py port: ROADMAP.md Queue 1 item 11")


def prob_from_raw(objective: str, raw: np.ndarray) -> np.ndarray:
    """Raw margins -> probabilities (classification) or values (regression)."""
    if objective == "binary":
        p1 = 1.0 / (1.0 + np.exp(-raw[:, 0]))
        return np.stack([1 - p1, p1], axis=1)
    if objective == "multiclass":
        e = np.exp(raw - raw.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
    return raw[:, 0]


def predict(ens: TreeEnsemble, x: np.ndarray, predict_impl: str = "auto",
            device=None) -> np.ndarray:
    """Probabilities for classification, values for regression."""
    return prob_from_raw(ens.objective,
                         predict_raw(ens, x, predict_impl=predict_impl,
                                     device=device))

