"""Gradient-boosted decision trees in PyTorch: the port of
``mmlspark_tpu/models/gbdt/engine.py``'s serial engine.

The LightGBM replacement (reference: src/lightgbm — the
LGBM_BoosterUpdateOneIter loop at TrainUtils.scala:63-77). As in the JAX
engine:

  * features are quantile-binned once to uint8 bins (maxBin=255); the bin
    matrix stays uint8 on the device, and is transposed once per fit for
    the histogram kernel;
  * trees grow LEVEL-WISE to a fixed depth — every level is one histogram
    build over all of the level's nodes plus a vectorized split-gain
    argmax — or, with ``num_leaves > 0``, LEAF-WISE (best-first, with
    categorical set splits: ``leafwise.py``);
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

Telemetry, under the JAX package's names (nothing is measured while it is
off): the spans ``gbdt/fit``, ``gbdt/bin``, ``gbdt/iter/step`` (one per
iteration of a serial fit: gradients, the K trees and the raw update as
one step, as the JAX engine's serial path does), ``gbdt/iter/{grad,build,
apply}`` (one each per iteration of a sharded fit, the collectives inside
``build``) and ``gbdt/eval``; the iteration, iteration-time, eval-time and
bin-time metrics; the predict gauges; ``profiler.wrap(...,
"gbdt.predict_quant")`` around the quantized predicts; and a device memory
sample per iteration and per predict while the profiler is on.

``traced_raw_levelwise`` is the dense level-wise scoring body as a
sync-free function of device tensors, binning included: a fused pipeline
segment (core/capture.py) runs it inside its one program.

Distributed fits (``fit_gbdt(mesh=...)``) run eagerly on the mesh's device
with explicit ``torch.distributed`` collectives over its ``data`` group:
``tree_learner="data"`` (and "auto") all-reduces each rank's histograms
and leaf sums through an :class:`AllReduce`, level-wise and leaf-wise;
``tree_learner="feature"`` (``make_feature_builder``)
all-gathers each rank's best split of its feature slice (level-wise). The
histograms are the same kernels as a serial fit's. Unlike the JAX engine,
ranks may hold different numbers of rows: the learners sum histograms,
never one global row array, so no rank pads its shard.

Elastic boosted fits (``fit_gbdt(elastic_ctx=...)``, ``fit_gbdt_elastic``)
run the same loop body under resilience/elastic.py's coordinator: each
iteration passes ``check_step`` first, and a one-process fit hands the
coordinator a snapshot of its boosting state after every iteration (the
trees, the training margins, the bagging row mask, both RNG states and the
early-stopping state), from which a re-meshed attempt continues bit for bit.
"""

from __future__ import annotations

import functools
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ... import telemetry
from ...core.utils import get_logger
from ...ops import gbdt_kernels as gk
from ...telemetry.tracer import _NOOP_SPAN

# boosting-loop telemetry (no-ops unless MMLSPARK_TPU_TELEMETRY=1); the
# spans wait for the step's result, so enabled traces show device time
_m_iters = telemetry.registry.counter(
    "mmlspark_gbdt_iterations", "boosting iterations dispatched")
_m_iter_time = telemetry.registry.histogram(
    "mmlspark_gbdt_iter_seconds",
    "wall time per boosting iteration (excl. early-stop eval)")
_m_eval_time = telemetry.registry.histogram(
    "mmlspark_gbdt_eval_seconds",
    "wall time per early-stopping validation eval")
_m_bin_time = telemetry.registry.histogram(
    "mmlspark_gbdt_bin_seconds", "feature binning wall time per fit")
_m_predict_table_bytes = telemetry.registry.gauge(
    "mmlspark_gbdt_predict_table_bytes",
    "estimated peak bytes of the per-chunk node-test table during the "
    "last ensemble predict")
_m_auto_depthwise = telemetry.registry.counter(
    "mmlspark_gbdt_auto_depthwise_reroutes",
    "fits the growthPolicy='auto' heuristic rerouted to depthwise growth")
_m_predict_bytes_per_row = telemetry.registry.gauge(
    "mmlspark_gbdt_predict_bytes_per_row",
    "estimated device-traffic bytes per scored row of the last ensemble "
    "predict (uint8 bin row + staged node tests + amortized tree "
    "tables); the quantized kernel path drops the test-table term and "
    "shrinks the tables to uint8/bf16")


class GBDTParams(NamedTuple):
    num_iterations: int = 100
    learning_rate: float = 0.1
    max_depth: int = 5              # numLeaves ~ 2^max_depth (level-wise);
                                    # leaf-wise: a depth cap, 0 = none
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
    # LightGBM tree_learner, used with a mesh (no mesh: serial); auto
    # runs the data learner
    tree_learner: str = "data"      # data | feature | auto | serial
    num_leaves: int = 0             # > 0: leaf-wise growth (leafwise.py)
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
    edges_t, cat = _slab_tables(edges, cat_features, dev)
    out = torch.empty((n, d), dtype=torch.uint8, device=dev)
    for start in range(0, n, slab):
        xs = torch.from_numpy(np.ascontiguousarray(
            x[start:start + slab], dtype=np.float32)).to(dev)
        out[start:start + len(xs)] = _bin_slab_device(xs, edges_t, cat,
                                                      max_bin)
    return out


def _slab_tables(edges: np.ndarray, cat_features, device):
    """The binner's device tables: the (d, B-1) float32 edges, a NaN edge
    (nanquantile over infinities) replaced by +inf — numpy sorts NaN last,
    and +inf takes its place exactly in a side='left' search — and the (d,)
    categorical mask."""
    edges_t = torch.from_numpy(np.ascontiguousarray(edges, np.float32)) \
        .to(device)
    edges_t = torch.where(torch.isnan(edges_t), torch.inf, edges_t)
    d = edges_t.shape[0]
    cat = torch.from_numpy(np.asarray(
        cat_features if cat_features is not None else np.zeros(d, bool),
        dtype=bool)).to(device)
    return edges_t, cat


def _bin_slab_device(xs, edges_t, cat, max_bin: int):
    """(m, d) float32 rows -> (m, d) uint8 bins, a sync-free function of
    device tensors (``bin_data``'s contract: side='left' per feature,
    NaN -> 0, categorical identity clipped to the bin range). Shared by
    ``bin_data_device`` and the fused featurize -> bin slabs of a
    pipeline fit."""
    ids = torch.searchsorted(edges_t, xs.T.contiguous(), side="left").T
    catv = torch.nan_to_num(xs).clamp(0, max_bin - 1).to(torch.uint8)
    b = torch.where(cat[None, :], catv, ids.to(torch.uint8))
    return torch.where(torch.isnan(xs), 0, b)


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
    # the kernel's layout: CUDA reductions and scans over the bin axis sum
    # in an order that depends on the layout, and near-tied gains (leaves
    # the label already separates) follow that order's last bit
    return (hg.reshape(d, n_nodes, n_bins).transpose(0, 1).contiguous(),
            hh.reshape(d, n_nodes, n_bins).transpose(0, 1).contiguous())


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


class AllReduce:
    """The data-parallel learner's collective: the elementwise sum of
    same-shaped float32 tensors over ``group`` (the mesh's ``data`` axis),
    each rank's partial in, the same sum out on every rank. The tensors go
    as one stacked buffer, so a call is one ``all_reduce``. The sum stays
    on the device; under NCCL it runs on the collective stream, which the
    call orders after the current stream's work (the histogram kernels)
    and the current stream after it. A group of one rank still runs it
    (the identity)."""

    def __init__(self, group):
        self.group = group

    def __call__(self, *ts):
        buf = torch.stack(ts)
        torch.distributed.all_reduce(buf, group=self.group)
        return tuple(buf.unbind(0))


def _grow_tree(bins, g, h, depth: int, n_bins: int, candidates,
               lambda_l2, lambda_l1, min_split_gain, hist_impl: str,
               leaf_reduce=None):
    """One level-wise tree, the scaffolding every tree_learner shares.
    ``bins`` (n, d) is what this rank routes its rows with (every feature);
    ``candidates(node, n_nodes) -> (best_gain, bf, bb)`` builds each
    node's split candidates (each learner's histograms and collective
    live there); ``leaf_reduce`` sums the leaf grad/hess over the ranks
    when rows are sharded. Returns (feature (2^depth-1,), threshold
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
        best_gain, bf, bb = candidates(node, n_nodes)
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
    if leaf_reduce is not None:
        lg, lh = leaf_reduce(lg, lh)
    leaf = -_soft(lg, lambda_l1) / (lh + lambda_l2)
    return feat_arr, thr_arr, leaf, node


def _build_tree_impl(bins, bins_t, grad, hess, row_mask, feat_mask,
                     depth: int, n_bins: int, lambda_l2, lambda_l1,
                     min_child_weight, min_split_gain,
                     hist_impl: str = "segment", reduce=None):
    """One level-wise tree for one output class; bagging through
    ``row_mask`` (n,), feature fraction through ``feat_mask`` (d,). With
    ``reduce`` (an :class:`AllReduce` over the data axis: rows sharded)
    every rank's histograms and leaf sums are summed over the ranks —
    LightGBM's ``tree_learner=data`` allreduce ring
    (TrainUtils.scala:141) — and split selection runs alike on every
    rank."""
    g = grad * row_mask
    h = hess * row_mask

    def candidates(node, n_nodes):
        hg, hh = _histograms(bins, bins_t, g, h, node, n_nodes, n_bins,
                             hist_impl)
        if reduce is not None:
            hg, hh = reduce(hg, hh)
        return _best_splits(hg, hh, feat_mask, n_bins, lambda_l2,
                            lambda_l1, min_child_weight)

    return _grow_tree(bins, g, h, depth, n_bins, candidates, lambda_l2,
                      lambda_l1, min_split_gain, hist_impl,
                      leaf_reduce=reduce)


def _build_tree_fp(bins, bins_t, grad, hess, row_mask, feat_mask, *,
                   depth: int, n_bins: int, d_local: int, rank: int,
                   n_dev: int, group, lambda_l2, lambda_l1,
                   min_child_weight, min_split_gain,
                   hist_impl: str = "segment"):
    """Feature-parallel tree build (LightGBM ``tree_learner=feature``).

    Every rank holds the whole row set (as LightGBM's feature-parallel
    workers each keep the whole dataset) but builds histograms only for
    its own slice of ``d_local`` features; the per-node best splits are
    all-gathered as (gain, feature, bin) triples and the winner is picked
    alike everywhere (ties to the lowest rank, as ``jnp.argmax`` picks),
    so only the triples cross ranks. Routing and the leaf sums are local:
    every rank has every row and feature.

    bins (n, d_pad) and bins_t (d_pad, n); feat_mask (d_pad,) with the
    padding zeroed."""
    off = rank * d_local
    lbins = bins[:, off:off + d_local]
    lbins_t = bins_t[off:off + d_local]
    lfm = feat_mask[off:off + d_local]
    g = grad * row_mask
    h = hess * row_mask

    def candidates(node, n_nodes):
        hg, hh = _histograms(lbins, lbins_t, g, h, node, n_nodes, n_bins,
                             hist_impl)
        lgain, lbf, lbb = _best_splits(hg, hh, lfm, n_bins, lambda_l2,
                                       lambda_l1, min_child_weight)
        # local slice index -> global feature id; float32 holds the ids
        # and bins exactly
        mine = torch.stack([lgain, (lbf + off).float(), lbb.float()])
        parts = [mine]
        if group is not None:
            parts = [torch.empty_like(mine) for _ in range(n_dev)]
            torch.distributed.all_gather(parts, mine, group=group)
        table = torch.stack(parts)              # (n_dev, 3, n_nodes)
        win = torch.argmax(table[:, 0], dim=0)  # ties -> lowest rank
        best = table.gather(0, win[None, None, :].expand(1, 3, n_nodes))[0]
        return (best[0], best[1].to(torch.int32), best[2].to(torch.int32))

    return _grow_tree(bins, g, h, depth, n_bins, candidates, lambda_l2,
                      lambda_l1, min_split_gain, hist_impl)


def _per_class(one, grad, hess):
    """``one(g, h)`` for each class column of grad/hess (K = 1 except
    multiclass), each output stacked over the class axis."""
    builds = [one(grad[:, k], hess[:, k]) for k in range(grad.shape[1])]
    return tuple(torch.stack(parts) for parts in zip(*builds))


def _build_tree_multi(bins, bins_t, grad, hess, row_mask, feat_mask, *,
                      depth: int, n_bins: int, lambda_l2, lambda_l1,
                      min_child_weight, min_split_gain,
                      hist_impl: str = "segment", reduce=None):
    """K level-wise trees per boosting iteration over the class axis of
    grad/hess, stacked: (feature (K, .), threshold, leaf, node (K, n)).
    ``reduce`` (a data-parallel fit's :class:`AllReduce`) runs inside each
    class's build."""
    return _per_class(
        lambda g, h: _build_tree_impl(
            bins, bins_t, g, h, row_mask, feat_mask, depth, n_bins,
            lambda_l2, lambda_l1, min_child_weight, min_split_gain,
            hist_impl, reduce=reduce), grad, hess)


def make_feature_builder(mesh, *, depth: int, n_bins: int, d_pad: int,
                         lambda_l2=1.0, lambda_l1=0.0, min_child_weight=1e-3,
                         min_split_gain=0.0, hist_impl: str = "segment"):
    """The feature-parallel level-wise builder of a mesh
    (``tree_learner="feature"``): every rank holds every row, histogram
    work splits by feature slice of the ``d_pad`` (a multiple of the
    ``data`` axis) padded features, and split candidates are all-gathered
    over the ``data`` group. The returned fn matches
    ``_build_tree_multi``: (bins, bins_t, grad (n, K), hess, row_mask,
    feat_mask) -> (f, t, leaf, node) stacked over the class axis, the
    class loop running on every rank with its collectives inside each
    class's build."""
    group = mesh.group("data")
    n_dev = mesh.axis_size("data")
    if d_pad % n_dev:
        raise ValueError(f"d_pad ({d_pad}) must be a multiple of the data "
                         f"axis ({n_dev})")
    if group is None and n_dev > 1:
        raise ValueError("a feature-parallel mesh of several ranks "
                         "needs a process group")
    rank = mesh.axis_index("data")

    def build(bins, bins_t, grad, hess, row_mask, feat_mask):
        return _per_class(
            lambda g, h: _build_tree_fp(
                bins, bins_t, g, h, row_mask, feat_mask, depth=depth,
                n_bins=n_bins, d_local=d_pad // n_dev, rank=rank,
                n_dev=n_dev, group=group, lambda_l2=lambda_l2,
                lambda_l1=lambda_l1, min_child_weight=min_child_weight,
                min_split_gain=min_split_gain, hist_impl=hist_impl),
            grad, hess)
    return build


def _gather_tree_contrib(lv, node):
    """(K, L) leaf tables + (K, n) per-row leaf ids -> (n, K) raw-score
    contributions (the training-raw update)."""
    return torch.stack([lv[k][node[k].long()] for k in range(lv.shape[0])],
                       dim=1)


def _span(on: bool, name: str, **attrs):
    return telemetry.trace.span(name, **attrs) if on else _NOOP_SPAN


def _boost_step(build, bins, bins_t, raw, y, row_mask, feat_mask, lr, alpha,
                *, objective: str, num_class: int, update_raw: bool,
                it: int = 0, mode: str = "levelwise", sharded: bool = False):
    """One boosting iteration: gradients, the K trees and the training-raw
    update (``update_raw=False``, rf mode, keeps raw fixed). ``build``
    (bins, bins_t, grad, hess, row_mask, feat_mask) returns the trees'
    arrays ending in (leaf, node): ``_build_tree_multi``, the leaf-wise
    ``build_tree_leafwise_multi`` or a ``make_feature_builder`` fn, any
    collectives inside. Returns (raw, the trees' arrays with the leaf
    scaled by ``lr``, node). A serial fit times the iteration as one span
    ``gbdt/iter/step``, as the JAX engine's serial path does; a sharded
    fit (``sharded``) times its parts as ``gbdt/iter/{grad,build,apply}``,
    the collectives inside ``build``."""
    with _span(not sharded, "gbdt/iter/step", tree=it, mode=mode) as step:
        with _span(sharded, "gbdt/iter/grad", tree=it) as sp:
            g, h = _grad_hess(raw, y, objective, num_class, alpha)
            sp.set_sync(h)
        with _span(sharded, "gbdt/iter/build", tree=it, mode=mode) as sp:
            *tree, lv, node = build(bins, bins_t, g, h, row_mask, feat_mask)
            sp.set_sync(node)
        lv = lv * lr
        if update_raw:
            with _span(sharded, "gbdt/iter/apply", tree=it) as sp:
                raw = raw + _gather_tree_contrib(lv, node)
                sp.set_sync(raw)
        step.set_sync((raw, lv))
    return (raw, *tree, lv, node)


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
    """Train a boosted ensemble: level-wise (a TreeEnsemble), or leaf-wise
    when ``num_leaves > 0`` (a leafwise.LeafwiseEnsemble, with
    category-set splits on ``categorical_feature``).

    With no ``mesh`` the fit is serial on ``device`` (cuda unless the
    caller asks for "cpu"). With a ``mesh`` (``parallel.mesh``) it runs the
    sharded builders on the mesh's device (``cuda:LOCAL_RANK`` under
    NCCL, the CPU under gloo; ``device`` must name the same kind) and
    ``params.tree_learner`` picks the learner: "data" (and "auto") — this
    rank's ``x`` is its own row shard, histograms and leaf sums are
    all-reduced over the ``data`` axis, LightGBM's socket-allreduce ring;
    "feature" — every rank passes the same whole ``x``, builds the
    histograms of its own feature slice, and the split candidates are
    all-gathered. In a world of more than one rank the bin edges and the
    init score of a data fit come from a sample pooled over the ranks in
    proportion to their real rows, per-row randomness (bagging, the
    holdout) draws from ``seed + rank``, the feature mask from the shared
    ``seed ^ 0x5EED`` stream, and the early-stopping loss is the
    row-weighted mean over the ranks, so every rank grows the same trees.

    ``sample_weight`` (n,) masks or weights rows (weight 0 rows neither
    train nor enter the bin edges and the init score); ``eval_set=(x, y)``
    is the early-stopping holdout, else ``early_stopping_round > 0`` holds
    out a seeded fifth of the rows; ``binned=(bins, edges)`` supplies an
    already-binned (n, d) uint8 matrix (numpy or tensor) and its edges
    (pass x=None; one process only). ``elastic_ctx`` (an
    ``ElasticStepContext``) checks each iteration for a host verdict before
    its device work and, in one process, resumes from and saves the
    per-iteration boosting snapshot."""
    dev = torch_device(device)
    if mesh is not None and mesh.distributed:
        if mesh.device.type != dev.type:
            raise ValueError(
                f"the fit's device {str(device)!r} is not the mesh's "
                f"{mesh.device}: a sharded fit runs on its rank's device")
        dev = mesh.device
    n, d = (binned[0].shape if binned is not None else x.shape)
    with telemetry.trace.span("gbdt/fit", rows=int(n), features=int(d),
                              objective=params.objective,
                              iterations=params.num_iterations):
        return _fit_gbdt_impl(x, y, params, mesh=mesh,
                              sample_weight=sample_weight,
                              eval_set=eval_set, binned=binned, device=dev,
                              elastic_ctx=elastic_ctx)


def fit_gbdt_elastic(x: np.ndarray, y: np.ndarray, params: GBDTParams,
                     *, checkpoint_dir: str, n_hosts: int = 0,
                     min_hosts: int = 1, grace: Optional[float] = None,
                     max_failures: int = 5,
                     heartbeat_interval: Optional[float] = None,
                     max_hosts: int = 0,
                     sample_weight: Optional[np.ndarray] = None,
                     eval_set: Optional[tuple] = None,
                     device="cuda") -> TreeEnsemble:
    """Elastic boosted fit: drives :func:`fit_gbdt` through the
    :class:`~...resilience.elastic.ElasticFitCoordinator` recovery loop, so
    a host lost mid-boosting raises ``HostLossError`` -> re-mesh over the
    survivors -> resume from the last completed iteration's boosting-state
    snapshot (and a relaunched host grows the mesh back at the next
    iteration boundary) instead of the fit dying.

    ``x``/``y`` are the RAW rows: each attempt pads them to its own mesh's
    multiple (weight-0 rows; none over one rank). ``checkpoint_dir`` hosts
    the heartbeat files; the boosting state resumes from the
    coordinator's in-memory snapshot."""
    from ...parallel import mesh as meshlib
    from ...resilience.elastic import ElasticFitCoordinator
    if params.tree_learner not in ("data", "auto"):
        raise ValueError(
            "elastic GBDT fits shard rows (tree_learner=data|auto), got "
            f"{params.tree_learner!r}")
    coord = ElasticFitCoordinator(
        checkpoint_dir=checkpoint_dir, n_hosts=n_hosts,
        min_hosts=min_hosts, grace=grace, max_failures=max_failures,
        heartbeat_interval=heartbeat_interval, max_hosts=max_hosts)

    def attempt(devices, ctx):
        mesh = meshlib.create_mesh()
        xp, n_real = meshlib.pad_batch_to_devices(x, mesh)
        yp = np.concatenate([y, np.zeros(len(xp) - n_real, y.dtype)])
        w = (np.ones(n_real, np.float32) if sample_weight is None
             else np.asarray(sample_weight, np.float32))
        w = np.concatenate([w, np.zeros(len(xp) - n_real, np.float32)])
        with meshlib.collective_fit_lock:
            return fit_gbdt(xp, yp, params, mesh=mesh, sample_weight=w,
                            eval_set=eval_set, elastic_ctx=ctx,
                            device=device)

    return coord.run(attempt)


def _pooled_edges_and_base(x, y, sample_weight, p: GBDTParams):
    """A multi-process data fit's bin edges and init score, the same on
    every rank: each rank contributes real rows in proportion to its real
    shard size (an equal split would over-weight small shards against the
    one-process fit), the samples are gathered, and the edges and the
    score come from the pool (LightGBM's bin_construct_sample_cnt, split
    across the fleet)."""
    from ...parallel import dataplane
    n = x.shape[0]
    # sample indices first: masking or casting the whole shard would copy
    # multi-GB transients to keep <= cap rows
    cand = (np.arange(n) if sample_weight is None
            else np.flatnonzero(sample_weight > 0))
    cap = dataplane.proportional_sample_cap(len(cand), 200_000)
    if len(cand) > cap:
        cand = np.random.default_rng(p.seed).choice(cand, cap, replace=False)
    pooled = dataplane.allgather_pyobj((x[cand].astype(np.float32),
                                        y[cand].astype(np.float32)))
    gx = np.concatenate([a for a, _ in pooled])
    gy = np.concatenate([b for _, b in pooled])
    return compute_bin_edges(gx, p.max_bin), _init_score(gy, p)


def _check_replicated(x, y, sample_weight):
    """A multi-process feature-parallel fit needs the same rows on every
    rank (routing and the leaf sums are local): one gather of a digest."""
    import hashlib

    from ...parallel import dataplane
    h = hashlib.sha256()
    for a in (x, y, sample_weight):
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    if len(set(dataplane.allgather_pyobj(h.hexdigest()))) > 1:
        raise ValueError(
            "tree_learner='feature' over several ranks needs the same rows "
            "on every rank (each builds the histograms of its feature "
            "slice over all rows); shard rows with tree_learner='data'")


def _fit_gbdt_impl(x, y, params: GBDTParams, *, mesh, sample_weight,
                   eval_set, binned, device: torch.device, elastic_ctx=None):
    from ...parallel import mesh as meshlib
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
    tree_learner = p.tree_learner if mesh is not None else "serial"
    if tree_learner == "serial":
        mesh = None
    leafwise = p.num_leaves > 0
    if leafwise and not 2 <= p.num_leaves <= 4096:
        raise ValueError(f"num_leaves must be in [2, 4096], got {p.num_leaves}")
    if leafwise and p.tree_learner == "feature":
        raise ValueError(
            "leaf-wise growth supports tree_learner=serial|data|auto "
            "(feature-parallel candidates are level-wise only; set "
            "num_leaves=0 or tree_learner='data')")
    if p.categorical_feature and not leafwise:
        raise ValueError("categorical_feature requires leaf-wise growth "
                         "(set num_leaves > 0)")
    if mesh is not None and any(s != 1 for a, s in mesh.shape.items()
                                if a != "data"):
        raise ValueError(f"GBDT fits shard over the mesh's data axis only; "
                         f"its other axes must be 1, got {mesh.shape}")
    nproc = meshlib.effective_process_count()
    if binned is not None and nproc > 1:
        raise ValueError(
            "binned fits are single-process (fit-side pipeline fusion); "
            "multi-process fits pool bin edges from raw row shards")
    if nproc > 1 and tree_learner == "serial":
        raise ValueError(
            "multi-process fits need a mesh and tree_learner=data|auto "
            "(rows sharded over the ranks) or feature (every rank holds "
            "every row), got a serial fit")
    # a data fit's rows are this rank's shard; a feature fit's are all rows
    row_sharded = nproc > 1 and tree_learner != "feature"
    if nproc > 1 and tree_learner == "feature":
        _check_replicated(x, y, sample_weight)
    cat_arr = np.zeros(d, dtype=bool)
    for j in p.categorical_feature:
        if not 0 <= j < d:
            raise ValueError(f"categorical_feature index {j} out of range "
                             f"for {d} features")
        cat_arr[j] = True
        if binned is not None:
            # identity binning already clipped the codes; the raw column
            # never materialized, so the top-code warning cannot run
            continue
        with np.errstate(invalid="ignore"):
            top = float(np.nanmax(x[:, j])) if len(x) else 0.0
        if top >= p.max_bin:
            get_logger("gbdt").warning(
                "categorical feature %d has codes up to %d but max_bin=%d; "
                "codes >= max_bin alias into one bin — raise maxBin or "
                "re-index the column", j, int(top), p.max_bin)
    has_cats = bool(cat_arr.any())
    cat_bins = cat_arr if has_cats else None
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
    base = None
    if binned is None:
        if row_sharded:
            edges, base = _pooled_edges_and_base(x, y, sample_weight, p)
        else:
            edges = compute_bin_edges(x[real], p.max_bin)
        with _m_bin_time.time(), telemetry.trace.span(
                "gbdt/bin", rows=n, features=d) as sp:
            bins = bin_data_auto(x, edges, cat_bins, p.max_bin, device)
            sp.set_sync(bins)
    else:
        bins = torch.as_tensor(np.asarray(bins_in) if not isinstance(
            bins_in, torch.Tensor) else bins_in).to(device, torch.uint8)
    d_pad = d
    if tree_learner == "feature":
        # pad the feature axis to a multiple of the ranks; padded columns
        # carry feat_mask 0, so they never win a split
        n_dev = mesh.axis_size("data")
        d_pad = -(-d // n_dev) * n_dev
        if d_pad != d:
            bins = torch.cat([bins, bins.new_zeros((n, d_pad - d))], dim=1)
    bins_t = bins.T.contiguous()              # once per fit, for the kernel
    if base is None:
        base = _init_score(y[real], p)
    raw = torch.from_numpy(np.broadcast_to(base[None, :], (n, K)).astype(
        np.float32)).to(device)
    yj = torch.from_numpy(np.asarray(y, np.float32)).to(device)

    group = mesh.group("data") if mesh is not None else None
    reduce = (AllReduce(group)
              if group is not None and tree_learner != "feature" else None)
    if leafwise:
        from . import leafwise as lw
        cat_t = torch.from_numpy(cat_arr.astype(np.float32)).to(device)
        build = functools.partial(
            lw.build_tree_leafwise_multi, cat_feats=cat_t,
            num_leaves=p.num_leaves, n_bins=p.max_bin, lambda_l2=p.lambda_l2,
            lambda_l1=p.lambda_l1, min_child_weight=p.min_child_weight,
            min_split_gain=p.min_split_gain, cat_smooth=p.cat_smooth,
            max_depth=max(0, p.max_depth),     # 0 or -1 = uncapped
            hist_impl=hist_impl, has_cats=has_cats, reduce=reduce)
    elif tree_learner == "feature":
        build = make_feature_builder(
            mesh, depth=p.max_depth, n_bins=p.max_bin, d_pad=d_pad,
            lambda_l2=p.lambda_l2, lambda_l1=p.lambda_l1,
            min_child_weight=p.min_child_weight,
            min_split_gain=p.min_split_gain, hist_impl=hist_impl)
    else:
        # serial, data, and "auto" (XLA's auto-SPMD in the JAX engine; the
        # data-parallel builder here)
        build = functools.partial(
            _build_tree_multi, depth=p.max_depth, n_bins=p.max_bin,
            lambda_l2=p.lambda_l2, lambda_l1=p.lambda_l1,
            min_child_weight=p.min_child_weight,
            min_split_gain=p.min_split_gain, hist_impl=hist_impl,
            reduce=reduce)

    # per-row randomness (bagging, holdout) is rank-local data and differs
    # between the ranks of a data fit; the feature mask is replicated and
    # must be the same everywhere — separate streams, as in the JAX engine
    rng = np.random.default_rng(
        p.seed + (meshlib.process_index() if row_sharded else 0))
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
            np.asarray(eval_set[0], dtype=np.float32), edges, cat_bins,
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
    fm = (None if p.feature_fraction < 1.0 else _to_device(
        np.pad(np.ones(d, dtype=np.float32), (0, d_pad - d)), device))
    lr_eff = 1.0 if is_rf else p.learning_rate
    mode = "leafwise" if leafwise else "levelwise"

    # ---- elastic resume: re-enter from the latest boosting snapshot ----
    # (one process only; a multi-process fleet uses the coordinator's
    # detection + fail-fast + relaunch path)
    start_it = 0
    row_mask = None
    elastic_snap = elastic_ctx is not None and nproc == 1
    if elastic_snap:
        snap = elastic_ctx.latest_snapshot()
        if snap is not None:
            start_it = snap["it"] + 1
            feats, thrs, leaves = (list(snap["feats"]), list(snap["thrs"]),
                                   list(snap["leaves"]))
            best_loss, since_best, best_iter = snap["best"]
            # the RNG streams continue EXACTLY where the lost attempt left
            # them: bagging masks and feature fractions replay from here
            rng.bit_generator.state = snap["rng"]
            feat_rng.bit_generator.state = snap["feat_rng"]
            k = min(len(snap["raw"]), n)
            raw[:k] = snap["raw"][:k].to(device)   # pad rows train at 0
            if snap.get("row_mask") is not None:
                row_mask = np.zeros(n, np.float32)
                row_mask[:k] = snap["row_mask"][:k]
                rm = _to_device(row_mask, device)
            if eval_set is not None and snap.get("raw_val") is not None:
                raw_val = snap["raw_val"].to(device)
            get_logger("gbdt").info(
                "elastic resume: re-entering the boosting loop at "
                "iteration %d (%d trees restored)", start_it, len(leaves))
        elastic_ctx.resumed(None if snap is None else (0, snap["it"]),
                            None)

    for it in range(start_it, p.num_iterations):
        t_iter = time.perf_counter() if telemetry.enabled() else 0.0
        if elastic_ctx is not None:
            # host-loss / grow check (site elastic.step): HostLossError /
            # HostRejoinError unwind to the coordinator's re-mesh; the
            # snapshot below is what the next attempt resumes from
            elastic_ctx.check_step()
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
            fm = _to_device(np.pad(keep.astype(np.float32), (0, d_pad - d)),
                            device)
        # rf leaves stay unscaled here; the 1/T average is applied at the
        # end over the forest's actual size
        raw, *tree, lv, _ = _boost_step(
            build, bins, bins_t, raw, yj, rm, fm, lr_eff, p.alpha,
            objective=p.objective, num_class=K, update_raw=not is_rf, it=it,
            mode=mode, sharded=mesh is not None)
        if leafwise:
            S, f, t, W, IC = tree
        else:
            f, t = tree
        if leafwise:
            feats.append((S, f, t, W, IC))
        else:
            feats.append(f)
            thrs.append(t)
        leaves.append(lv)
        if telemetry.enabled():
            _m_iters.inc()
            _m_iter_time.observe(time.perf_counter() - t_iter)
            # per-iteration device memory sample (profiler on only)
            telemetry.profiler.sample_live_buffers(device, (bins, raw))
        if p.early_stopping_round > 0:
            t_eval = time.perf_counter() if telemetry.enabled() else 0.0
            with telemetry.trace.span("gbdt/eval", tree=it) as sp:
                raw_val = raw_val + torch.stack(
                    [lw.predict_tree_lw_t(bins_val_t, S[k], f[k], t[k],
                                          W[k], IC[k], lv[k],
                                          has_cats=has_cats)
                     if leafwise else
                     _predict_tree_t(bins_val_t, f[k], t[k], lv[k],
                                     p.max_depth)
                     for k in range(K)], dim=1)
                sp.set_sync(raw_val)
            cur = float(_loss(raw_val, y_val, p.objective, p.alpha))
            if telemetry.enabled():
                _m_eval_time.observe(time.perf_counter() - t_eval)
            if row_sharded:
                # the stop decision must be the same on every rank: the
                # row-weighted mean of the ranks' validation losses
                from ...parallel import dataplane
                m = len(y_val)
                tot = dataplane.allreduce_sum(
                    np.array([cur * m if m else 0.0, float(m)]))
                cur = float(tot[0] / max(tot[1], 1.0))
            if cur < best_loss - 1e-9:
                best_loss, since_best, best_iter = cur, 0, it + 1
            else:
                since_best += 1
                if since_best >= p.early_stopping_round:
                    break

        if elastic_snap:
            # the boosting-state candidate (newest wins): everything a
            # re-meshed attempt needs to continue bit for bit from
            # iteration it+1. The tensors are this iteration's own (every
            # step makes new ones), so the snapshot costs no copy and no
            # wait; checkpoint_saved marks the grow boundary — for boosted
            # fits the snapshot IS the checkpoint
            elastic_ctx.save_snapshot({
                "it": it, "feats": list(feats), "thrs": list(thrs),
                "leaves": list(leaves), "raw": raw,
                "raw_val": raw_val if eval_set is not None else None,
                "row_mask": row_mask if bagging else None,
                "rng": rng.bit_generator.state,
                "feat_rng": feat_rng.bit_generator.state,
                "best": (best_loss, since_best, best_iter)})
            elastic_ctx.step_committed(0, it)
            elastic_ctx.checkpoint_saved(0, it)

    if best_iter is not None:
        feats, thrs, leaves = (feats[:best_iter], thrs[:best_iter],
                               leaves[:best_iter])
    if is_rf:
        leaves = [lv / len(leaves) for lv in leaves]
    if leafwise:
        S, F, T, W, IC = (torch.stack(parts) for parts in zip(*feats))
        return lw.LeafwiseEnsemble(
            split_leaf=S, feature=F, threshold=T, cat_bitset=W, is_cat=IC,
            leaf=torch.stack(leaves), bin_edges=edges, cat_features=cat_arr,
            base=base, objective=p.objective)
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
    """Score (d, n) rows in chunks of :func:`_predict_chunk_rows`, and
    record the peak test-table estimate on the telemetry gauge."""
    n = bins_t.shape[1]
    chunk = _predict_chunk_rows(n, table_nodes)
    _m_predict_table_bytes.set(table_nodes * min(max(n, 1), chunk))
    telemetry.profiler.sample_live_buffers(bins_t.device, bins_t)
    if n <= chunk:
        return score_chunk(bins_t)
    return torch.cat([score_chunk(bins_t[:, lo:lo + chunk].contiguous())
                      for lo in range(0, n, chunk)], dim=0)


def leaf_table_bytes(leaf) -> int:
    """Stored bytes of a quantized leaf table (the traffic-gauge term):
    2/leaf for bf16, 1/leaf + the f32 scales for int8."""
    if isinstance(leaf, tuple):
        q, scale = leaf
        return q.nbytes + scale.nbytes
    return leaf.numel() * 2


def _set_predict_traffic_gauge(n: int, d: int, K: int, table_bytes: int,
                               test_table_nodes: int):
    if telemetry.enabled() and n:
        _m_predict_bytes_per_row.set(
            d + 4 * K + test_table_nodes + table_bytes / n)


def _nbytes(*tables) -> int:
    """Bytes of tensors or arrays (the traffic gauge's table term)."""
    return int(sum(t.numel() * t.element_size()
                   for t in map(torch.as_tensor, tables)))


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
    d, n = bins_t.shape
    _set_predict_traffic_gauge(
        n, d, K, _nbytes(feat, thr) + leaf_table_bytes(leaf), 0)
    base = torch.from_numpy(np.asarray(ens.base, np.float32)).to(dev)[None]

    def run(part):
        return gk.gbdt_predict_quant_levelwise(part, feat, thr, leaf_f32,
                                               depth=depth) + base
    prof = telemetry.profiler.wrap(run, "gbdt.predict_quant")
    return _predict_chunked(bins_t, prof, d + 4 * K)


def _ens_device(ens, device) -> torch.device:
    if device is not None:
        return torch_device(device)
    if isinstance(ens.feature, torch.Tensor):
        return ens.feature.device
    return torch_device("cuda")


def predict_raw(ens, x: np.ndarray, num_iteration: Optional[int] = None,
                predict_impl: str = "auto", device=None) -> np.ndarray:
    """Raw ensemble scores (n, K) float32 of a level-wise TreeEnsemble or a
    leafwise.LeafwiseEnsemble. ``device`` defaults to the ensemble's own
    (cuda for host arrays). ``predict_impl``: 'dense' walks the int32/f32
    trees tree by tree; 'pallas' runs the quantized predict kernel (uint8
    tables, bf16 leaves); 'pallas_int8' the same with per-tree-scaled int8
    leaves; 'auto' the kernel on CUDA when the ensemble fits its caps (and,
    leaf-wise, has no categorical split), else dense."""
    from .leafwise import LeafwiseEnsemble, predict_raw_lw
    dev = _ens_device(ens, device)
    if isinstance(ens, LeafwiseEnsemble):
        cats = np.asarray(ens.cat_features, bool)
        bins_t = bin_data_auto(x, ens.bin_edges, cats if cats.any() else None,
                               ens.bin_edges.shape[1] + 1,
                               device=dev).T.contiguous()
        return predict_raw_lw(ens, bins_t, num_iteration,
                              predict_impl=predict_impl).cpu().numpy()
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
    nodes = 2 ** depth - 1
    _set_predict_traffic_gauge(bins_t.shape[1], bins_t.shape[0], K,
                               _nbytes(feature, threshold, leaf),
                               max(nodes, 1))

    def score(part):
        raw = base[None, :].expand(part.shape[1], K).clone()
        for t in range(T):
            raw = raw + torch.stack(
                [_predict_tree_t(part, feature[t, k], threshold[t, k],
                                 leaf[t, k], depth) for k in range(K)], dim=1)
        return raw
    return _predict_chunked(bins_t, score, max(nodes, 1)).cpu().numpy()


def traced_raw_levelwise(params: dict, x, depth: int, K: int):
    """The dense level-wise scoring body as a sync-free function of device
    tensors — binning included — for cross-stage pipeline fusion
    (core/capture.py): ``params = {feature, threshold, leaf, base,
    edges}`` (the boosterState arrays on the device), ``x`` raw (n, d)
    features. The math of :func:`predict_raw`'s dense path: per-feature
    ``searchsorted`` binning (NaN -> bin 0, the ``bin_data`` contract),
    then the per-tree walk of :func:`_predict_tree_t` over every row at
    once (no host-sized chunks, so a CUDA graph captures it), the trees
    summed in order onto the base score."""
    xf = x.to(torch.float32)
    edges = params["edges"].to(torch.float32)
    edges = torch.where(torch.isnan(edges), torch.inf, edges)
    ids = torch.searchsorted(edges, xf.T.contiguous(), side="left")
    bins_t = torch.where(torch.isnan(xf.T), 0, ids).to(torch.int32)
    feature, threshold = params["feature"], params["threshold"]
    leaf = params["leaf"].to(torch.float32)
    raw = params["base"].to(torch.float32)[None, :].expand(
        x.shape[0], K).clone()
    for t in range(feature.shape[0]):
        raw = raw + torch.stack(
            [_predict_tree_t(bins_t, feature[t, k], threshold[t, k],
                             leaf[t, k], depth) for k in range(K)], dim=1)
    return raw


def prob_from_raw(objective: str, raw: np.ndarray) -> np.ndarray:
    """Raw margins -> probabilities (classification) or values (regression)."""
    if objective == "binary":
        p1 = 1.0 / (1.0 + np.exp(-raw[:, 0]))
        return np.stack([1 - p1, p1], axis=1)
    if objective == "multiclass":
        e = np.exp(raw - raw.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
    return raw[:, 0]


def predict(ens, x: np.ndarray, predict_impl: str = "auto",
            device=None) -> np.ndarray:
    """Probabilities for classification, values for regression."""
    return prob_from_raw(ens.objective,
                         predict_raw(ens, x, predict_impl=predict_impl,
                                     device=device))

