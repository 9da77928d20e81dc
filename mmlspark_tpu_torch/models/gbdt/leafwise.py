"""Leaf-wise (best-first) tree growth with categorical set splits: the port
of ``mmlspark_tpu/models/gbdt/leafwise.py``.

Native LightGBM grows trees best-first: it splits the leaf with the highest
gain until ``num_leaves`` leaves exist (``numLeaves``, default 31 —
LightGBMParams.scala:34). As in the JAX package the shape of the work is
fixed, not the shape of the tree:

  * exactly ``num_leaves - 1`` split rounds run;
  * each round argmaxes a per-leaf candidate cache (gain, feature,
    threshold or category set), splits that leaf, and rebuilds candidates
    for ONLY the two fresh leaves with one histogram pass over all rows
    (rows outside the two leaves add nothing: the node-histogram kernel
    drops their out-of-range id, the combined-id paths send them to a
    discard slot);
  * a leaf whose best gain cannot clear ``min_split_gain`` is retired (its
    cache entry pinned to -inf), so an exhausted tree finishes in no-op
    rounds.

Everything in a round stays on the device: the chosen leaf, the ``ok``
flag and the caches are tensors, and updates go through tensor indices, so
the host queues all rounds of a tree without waiting for the card. Every
round runs, no-op rounds included, so the histogram kernel launches
``num_leaves`` times per tree and class.

Trees are recorded as the split sequence: round r splits leaf
``split_leaf[r]`` (-1 for a no-op round) and the right child becomes leaf
r+1. Prediction replays the sequence, or, for numeric ensembles on CUDA,
runs the leaf-wise predict kernel (``ops/csrc/gbdt_predict.cu``).

Categorical features split as category sets: per (leaf, feature) the bins
sort by grad/hess ratio (a stable sort, as ``jnp.argsort``) and a prefix
scan over the sorted order finds the best partition; the set routed right
is kept as a 256-bit mask per split. On the device the mask is 8 int64
words each holding 32 bits (torch's uint32 has few kernels); the fitted
state carries them as uint32, as the JAX package's does.

Not ported: the mesh-sharded builder (``make_sharded_builder_lw``), which
waits for the parallel/ port (ROADMAP item 12).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import gbdt_kernels as gk

#: 256 bits of category membership per split (max_bin <= 256)
CAT_WORDS = 8

_NEG_INF = float("-inf")


class LeafwiseEnsemble(NamedTuple):
    """Fitted leaf-wise booster. T trees x K classes; L = num_leaves.

    split_leaf: (T,K,L-1) int32 tensor — leaf id split at round r (-1 no-op)
    feature:    (T,K,L-1) int32 tensor — split feature
    threshold:  (T,K,L-1) int32 tensor — numeric split bin (right if bin >
                thr)
    cat_bitset: (T,K,L-1,CAT_WORDS) int64 tensor — category set routed
                right, 32 bits per word
    is_cat:     (T,K,L-1) bool tensor
    leaf:       (T,K,L) f32 tensor — leaf values (learning rate applied)
    """
    split_leaf: torch.Tensor
    feature: torch.Tensor
    threshold: torch.Tensor
    cat_bitset: torch.Tensor
    is_cat: torch.Tensor
    leaf: torch.Tensor
    bin_edges: np.ndarray
    cat_features: np.ndarray      # (d,) bool
    base: np.ndarray
    objective: str


def _soft(gsum, l1):
    return torch.sign(gsum) * torch.clamp(gsum.abs() - l1, min=0.0)


def _leaf_score(gsum, hsum, l2, l1):
    gs = _soft(gsum, l1)
    return gs * gs / (hsum + l2)


def _take(a, idx, dim):
    """``a`` indexed along ``dim`` by ``idx``, which has one entry there
    (jnp.take_along_axis(..)[.., 0])."""
    return a.gather(dim, idx.unsqueeze(dim)).squeeze(dim)


def _pack_bits(member):
    """(n_nodes, B) bool -> (n_nodes, CAT_WORDS) int64 words, bin b as bit
    b & 31 of word b >> 5."""
    n_nodes, B = member.shape
    padded = torch.zeros((n_nodes, CAT_WORDS * 32), dtype=torch.int64,
                         device=member.device)
    padded[:, :B] = member.to(torch.int64)
    weights = 1 << torch.arange(32, device=member.device)
    return (padded.reshape(n_nodes, CAT_WORDS, 32) * weights).sum(2)


def _candidates_2(hg, hh, feat_mask, cat_feats, n_bins, l2, l1,
                  min_child_weight, cat_smooth, has_cats: bool = True):
    """Best split per node from (n_nodes, d, B) histograms, numeric and
    categorical forms evaluated per feature.

    Returns per node: gain (n,), feat (n,) int64, thr (n,) int64 (numeric
    bin or sorted-prefix end for categorical), bitset (n, CAT_WORDS) int64.
    ``has_cats=False`` skips the categorical arm. Ties and NaN take the
    first index, as jnp.argmax does."""
    n_nodes = hg.shape[0]
    gt = hg.sum(2, keepdim=True)
    ht = hh.sum(2, keepdim=True)
    parent = _leaf_score(gt, ht, l2, l1)

    # numeric: prefix over the natural (value-ordered) bin axis
    gl = torch.cumsum(hg, 2)
    hl = torch.cumsum(hh, 2)
    gain_n = (_leaf_score(gl, hl, l2, l1)
              + _leaf_score(gt - gl, ht - hl, l2, l1) - parent)
    valid_n = (hl >= min_child_weight) & (ht - hl >= min_child_weight)
    gain_n = torch.where(valid_n, gain_n, _NEG_INF)
    gain_n[:, :, -1] = _NEG_INF            # all-left split is no split
    bin_n = torch.argmax(gain_n, 2)
    best_n = _take(gain_n, bin_n, 2)

    if not has_cats:
        gain_f = torch.where(feat_mask[None, :] > 0, best_n, _NEG_INF)
        bf = torch.argmax(gain_f, 1)
        return (_take(gain_f, bf, 1), bf, _take(bin_n, bf, 1),
                torch.zeros((n_nodes, CAT_WORDS), dtype=torch.int64,
                            device=hg.device))

    # categorical: prefix over bins sorted by grad/hess ratio (stable, so
    # empty bins, all at ratio 0, keep their order as in jnp.argsort)
    ratio = hg / (hh + cat_smooth)
    order = torch.argsort(ratio, dim=2, stable=True)
    cgl = torch.cumsum(hg.gather(2, order), 2)
    chl = torch.cumsum(hh.gather(2, order), 2)
    gain_c = (_leaf_score(cgl, chl, l2, l1)
              + _leaf_score(gt - cgl, ht - chl, l2, l1) - parent)
    valid_c = (chl >= min_child_weight) & (ht - chl >= min_child_weight)
    gain_c = torch.where(valid_c, gain_c, _NEG_INF)
    gain_c[:, :, -1] = _NEG_INF
    k_c = torch.argmax(gain_c, 2)                   # prefix end index
    best_c = _take(gain_c, k_c, 2)

    # per-feature choice, then per-node argmax over features
    is_cat = cat_feats[None, :] > 0
    gain_f = torch.where(is_cat, best_c, best_n)
    gain_f = torch.where(feat_mask[None, :] > 0, gain_f, _NEG_INF)
    bf = torch.argmax(gain_f, 1)
    gain = _take(gain_f, bf, 1)
    thr = _take(torch.where(is_cat, k_c, bin_n), bf, 1)

    # the winner's categories past the sorted prefix [0..thr] route right
    # (numeric and categorical routing agree: "right when the test hits")
    win_order = _take(order, bf[:, None].expand(n_nodes, order.shape[2]), 1)
    ranks = torch.argsort(win_order, dim=1)         # bin -> rank
    return gain, bf, thr, _pack_bits(ranks > thr[:, None])


def _bit_test(bitset_row, rb):
    """bitset_row (CAT_WORDS,) int64, rb (n,) int64 bins -> (n,) bool."""
    word = bitset_row[rb >> 5]
    return ((word >> (rb & 31)) & 1) == 1


def _at(a, idx):
    """a[idx] for a 0-d index tensor: a copy, and no host sync (indexing
    with a 0-d tensor reads its value on the host and returns a view)."""
    return a.index_select(0, idx.reshape(1))[0]


def _put(a, idx, value):
    """a[idx] = value for a 0-d index tensor, without a host sync."""
    a.index_put_((idx.reshape(1),), value.reshape((1,) + a.shape[1:]))


def grow_tree_leafwise(bins, bins_t, g, h, *, num_leaves: int, n_bins: int,
                       cat_feats, feat_mask, lambda_l2, lambda_l1,
                       min_child_weight, min_split_gain, cat_smooth: float,
                       max_depth: int = 0, hist_impl: str = "segment",
                       has_cats: bool = True):
    """One leaf-wise tree. bins (n, d) uint8 and bins_t its (d, n)
    transpose; g/h (n,) float32 (already masked); cat_feats/feat_mask (d,)
    float32 tensors.

    Returns (split_leaf (L-1,) int32, feature (L-1,) int32, threshold (L-1,)
    int32, cat_bitset (L-1, CAT_WORDS) int64, is_cat (L-1,) bool, leaf (L,)
    float32, node (n,) int32 — each training row's final leaf)."""
    from .engine import _histograms

    n = bins.shape[0]
    dev = bins.device
    L = num_leaves

    # the node-histogram kernel drops ids outside [0, n_nodes), so it
    # builds the two leaves alone; the combined-id paths (node * n_bins +
    # bin) need the discard slot's ids in range, or they would spill into
    # the next feature
    n_ids = 2 if hist_impl == "mxu" else 3

    def cand_pair(node, a, b):
        """Candidates of leaves a and b from one histogram pass (ids 0 and
        1; id 2, every other row, adds nothing to the two leaves)."""
        ids = torch.where(node == a, 0, torch.where(node == b, 1, 2)).to(
            torch.int32)
        hg, hh = _histograms(bins, bins_t, g, h, ids, n_ids, n_bins,
                             hist_impl)
        return _candidates_2(hg[:2], hh[:2], feat_mask, cat_feats, n_bins,
                             lambda_l2, lambda_l1, min_child_weight,
                             cat_smooth, has_cats=has_cats)

    node = torch.zeros(n, dtype=torch.int32, device=dev)
    g0, f0, t0, w0 = cand_pair(node, 0, -1)         # root candidates
    cg = torch.full((L,), _NEG_INF, device=dev)
    cg[0] = g0[0]
    cf = torch.zeros(L, dtype=torch.int64, device=dev)
    cf[0] = f0[0]
    ct = torch.zeros(L, dtype=torch.int64, device=dev)
    ct[0] = t0[0]
    cw = torch.zeros((L, CAT_WORDS), dtype=torch.int64, device=dev)
    cw[0] = w0[0]
    dep = torch.zeros(L, dtype=torch.int64, device=dev)

    recs = []
    for r in range(L - 1):
        s = torch.argmax(cg)
        ok = _at(cg, s) > min_split_gain
        f, t, w = _at(cf, s), _at(ct, s), _at(cw, s)
        rb = _at(bins_t, f).long()
        if has_cats:
            f_is_cat = _at(cat_feats, f) > 0
            right = torch.where(f_is_cat, _bit_test(w, rb), rb > t)
        else:
            f_is_cat = torch.zeros((), dtype=torch.bool, device=dev)
            right = rb > t
        right = right & (node == s) & ok
        node = torch.where(right, r + 1, node)
        recs.append((torch.where(ok, s, -1), f, t, w, f_is_cat & ok))

        gain2, f2, t2, w2 = cand_pair(node, s, r + 1)
        childdep = _at(dep, s) + 1
        if max_depth > 0:
            gain2 = torch.where(childdep < max_depth, gain2, _NEG_INF)
        _put(cg, s, torch.where(ok, gain2[0], _NEG_INF))
        cg[r + 1] = torch.where(ok, gain2[1], _NEG_INF)
        _put(cf, s, torch.where(ok, f2[0], f))
        cf[r + 1] = f2[1]
        _put(ct, s, torch.where(ok, t2[0], t))
        ct[r + 1] = t2[1]
        _put(cw, s, torch.where(ok, w2[0], w))
        cw[r + 1] = w2[1]
        _put(dep, s, torch.where(ok, childdep, childdep - 1))
        dep[r + 1] = childdep

    lg, lh = gk.node_sums(node, g, h, L, impl=hist_impl)
    leaf = -_soft(lg, lambda_l1) / (lh + lambda_l2)
    S, F, T, W, IC = (torch.stack(parts) for parts in zip(*recs))
    return (S.to(torch.int32), F.to(torch.int32), T.to(torch.int32), W, IC,
            leaf, node)


def build_tree_leafwise_multi(bins, bins_t, grad, hess, row_mask, feat_mask,
                              cat_feats, *, num_leaves, n_bins, lambda_l2,
                              lambda_l1, min_child_weight, min_split_gain,
                              cat_smooth, max_depth, hist_impl="segment",
                              has_cats=True):
    """K leaf-wise trees per boosting iteration over the class axis of
    grad/hess (K = 1 except multiclass), stacked: (split_leaf (K, L-1),
    feature, threshold, cat_bitset (K, L-1, CAT_WORDS), is_cat, leaf
    (K, L), node (K, n))."""
    builds = [grow_tree_leafwise(
        bins, bins_t, grad[:, k] * row_mask, hess[:, k] * row_mask,
        num_leaves=num_leaves, n_bins=n_bins, cat_feats=cat_feats,
        feat_mask=feat_mask, lambda_l2=lambda_l2, lambda_l1=lambda_l1,
        min_child_weight=min_child_weight, min_split_gain=min_split_gain,
        cat_smooth=cat_smooth, max_depth=max_depth, hist_impl=hist_impl,
        has_cats=has_cats) for k in range(grad.shape[1])]
    return tuple(torch.stack(parts) for parts in zip(*builds))


#: precomputed (L-1, n) test tables stop at this many splits; wider trees
#: replay with one bin row read per round instead (bounded memory)
_TEST_TABLE_MAX_SPLITS = 255


def _tree_tests_lw(bins_t, F, T, W, IC, has_cats: bool = True):
    """All of one tree's split tests at once: (L-1, n) bool, from the L-1
    split features' rows of the transposed bin matrix."""
    rows = bins_t.index_select(0, F.long())                  # (L-1, n)
    num_t = rows.to(torch.int32) > T[:, None]
    if not has_cats:
        return num_t
    rb = rows.long()
    word = W.gather(1, rb >> 5)
    cat_t = ((word >> (rb & 31)) & 1) == 1
    return torch.where(IC[:, None], cat_t, num_t)


def _replay_lw(tests, S, leaf):
    """Replay the split sequence over precomputed tests: (n,) leaf values."""
    n = tests.shape[1]
    pos = torch.zeros(n, dtype=torch.long, device=tests.device)
    for r in range(S.shape[0]):
        right = (pos == S[r]) & (S[r] >= 0) & tests[r]
        pos = torch.where(right, r + 1, pos)
    return leaf[pos]


def _replay_lw_streaming(bins_t, S, F, T, W, IC, leaf,
                         has_cats: bool = True):
    """Replay without the test table: each round reads its one split
    feature's row of bins_t — O(n) live memory however many leaves the tree
    has (trees past _TEST_TABLE_MAX_SPLITS)."""
    n = bins_t.shape[1]
    pos = torch.zeros(n, dtype=torch.long, device=bins_t.device)
    for r in range(S.shape[0]):
        rb = bins_t.index_select(0, F[r:r + 1].long())[0].long()
        test = rb > T[r]
        if has_cats:
            cat_t = _bit_test(W[r], rb)
            test = torch.where(IC[r], cat_t, test)
        right = (pos == S[r]) & (S[r] >= 0) & test
        pos = torch.where(right, r + 1, pos)
    return leaf[pos]


def predict_tree_lw_t(bins_t, S, F, T, W, IC, leaf, has_cats: bool = True):
    """One tree's predictions from the transposed bin matrix (d, n)."""
    if S.shape[0] > _TEST_TABLE_MAX_SPLITS:
        return _replay_lw_streaming(bins_t, S, F, T, W, IC, leaf,
                                    has_cats=has_cats)
    return _replay_lw(_tree_tests_lw(bins_t, F, T, W, IC,
                                     has_cats=has_cats), S, leaf)


def predict_tree_lw(bins, S, F, T, W, IC, leaf, has_cats: bool = True):
    """Replay one tree's split sequence: bins (n, d) -> (n,) leaf values."""
    return predict_tree_lw_t(bins.T, S, F, T, W, IC, leaf, has_cats=has_cats)


def quantize_ensemble_lw(ens: LeafwiseEnsemble,
                         num_iteration: Optional[int] = None,
                         leaf_dtype: str = "bf16"):
    """Leaf-wise ensemble -> ``(split_leaf int32, feature uint8, threshold
    uint8, leaf)`` tensors, leaf a bf16 (T,K,L) tensor (``'bf16'``) or a
    per-tree-scaled numpy ``(int8, f32 scale)`` pair (``'int8'``). Numeric
    splits only (the caller keeps categorical ensembles on the dense path).
    Thresholds clamp to 255, which routes nothing right against uint8
    bins; only the leaf round is lossy."""
    from .engine import quantize_leaves_int8
    if leaf_dtype not in ("bf16", "int8"):
        raise ValueError(f"leaf_dtype must be bf16|int8, got {leaf_dtype!r}")
    T = ens.feature.shape[0]
    T = min(T, num_iteration) if num_iteration else T
    d = ens.bin_edges.shape[0]
    if d > 256:
        raise ValueError(f"quantized predict tables need <= 256 features "
                         f"(uint8 feature ids), got {d}")
    if leaf_dtype == "int8":
        leaf = quantize_leaves_int8(
            torch.as_tensor(ens.leaf[:T]).cpu().numpy())
    else:
        leaf = torch.as_tensor(ens.leaf[:T]).to(torch.bfloat16)
    return (torch.as_tensor(ens.split_leaf[:T]).to(torch.int32),
            torch.as_tensor(ens.feature[:T]).to(torch.uint8),
            torch.as_tensor(ens.threshold[:T]).clamp(max=255).to(
                torch.uint8),
            leaf)


def _quant_eligible_lw(ens: LeafwiseEnsemble, has_cats: bool):
    if has_cats:
        return False, "categorical bitset splits stay on the dense path"
    d = ens.bin_edges.shape[0]
    if d > 256:
        return False, f"{d} features exceed the uint8 feature-id space"
    splits = int(ens.split_leaf.shape[2])
    if splits > gk.PREDICT_QUANT_MAX_NODES \
            or splits + 1 > gk.PREDICT_QUANT_MAX_LEAVES:
        return False, (f"{splits + 1} leaves exceed the kernel's unroll "
                       f"cap ({gk.PREDICT_QUANT_MAX_NODES} splits)")
    return True, ""


def _predict_quant_lw(ens: LeafwiseEnsemble, bins_t, T: int,
                      leaf_dtype: str = "bf16") -> torch.Tensor:
    """The quantized scoring path: uint8 tables and bf16 or int8 leaves
    (widened to float32) replayed by the leaf-wise predict kernel in one
    launch per chunk, plus the base score."""
    from .engine import _predict_chunked, dequant_leaf
    dev = bins_t.device
    S, F, Th, leaf = quantize_ensemble_lw(ens, T, leaf_dtype=leaf_dtype)
    S, F, Th = S.to(dev), F.to(dev), Th.to(dev)
    leaf_f32 = dequant_leaf(leaf).to(dev)
    K = F.shape[1]
    base = torch.from_numpy(np.asarray(ens.base, np.float32)).to(dev)[None]

    def score(part):
        return gk.gbdt_predict_quant_leafwise(part, S, F, Th, leaf_f32) + base
    return _predict_chunked(bins_t, score, bins_t.shape[0] + 4 * K)


def predict_raw_lw(ens: LeafwiseEnsemble, bins_t,
                   num_iteration: Optional[int] = None,
                   predict_impl: str = "auto") -> torch.Tensor:
    """Raw scores (n, K) of a leaf-wise ensemble from the transposed bin
    matrix (d, n) on its device. Rows batch past the test-table byte cap
    (engine._predict_chunked). ``predict_impl`` as engine.predict_raw:
    dense | pallas | pallas_int8 (the leaf-wise predict kernel; numeric
    splits only) | auto (the kernel on CUDA for an eligible ensemble)."""
    from .engine import _predict_chunked, _resolve_predict_impl
    dev = bins_t.device
    T, K = ens.feature.shape[:2]
    T = min(T, num_iteration) if num_iteration else T

    has_cats = bool(np.asarray(ens.cat_features).any())
    eligible, why = _quant_eligible_lw(ens, has_cats)
    resolved = _resolve_predict_impl(predict_impl, eligible, why, dev)
    if resolved in ("pallas", "pallas_int8"):
        return _predict_quant_lw(
            ens, bins_t, T,
            leaf_dtype="int8" if resolved == "pallas_int8" else "bf16")

    S, F, Th, W, IC, leaf = (torch.as_tensor(a[:T]).to(dev) for a in (
        ens.split_leaf, ens.feature, ens.threshold, ens.cat_bitset,
        ens.is_cat, ens.leaf))
    base = torch.from_numpy(np.asarray(ens.base, np.float32)).to(dev)

    def score(part):
        raw = base[None, :].expand(part.shape[1], K).clone()
        for t in range(T):
            raw = raw + torch.stack(
                [predict_tree_lw_t(part, S[t, k], F[t, k], Th[t, k],
                                   W[t, k], IC[t, k], leaf[t, k],
                                   has_cats=has_cats) for k in range(K)],
                dim=1)
        return raw

    splits = int(ens.split_leaf.shape[2])
    table_nodes = splits if splits <= _TEST_TABLE_MAX_SPLITS else 1
    # the categorical test gathers an int64 word per (split, row)
    return _predict_chunked(bins_t, score,
                            table_nodes * (9 if has_cats else 1))
