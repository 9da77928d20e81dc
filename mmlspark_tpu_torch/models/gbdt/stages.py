"""LightGBM-surface estimators backed by the PyTorch boosting engine: the
port of ``mmlspark_tpu/models/gbdt/stages.py``.

API parity with the reference (lightgbm/.../LightGBMClassifier.scala:32-83,
LightGBMRegressor.scala:34, TrainParams.scala) and with the JAX stages: the
same Params, plus ``device`` ("cuda" by default, raising without a card;
"cpu" on request).

Distributed fits: a rank is a device, so a world of one rank fits serially
and, in a world of more than one rank (``parallel.distributed``), every fit
runs the data-parallel program over a mesh of the whole world, each rank
passing its own row shard — the reference's per-partition workers
(LightGBMClassifier.scala:35-47). Every rank then derives the same fit:
the feature plan of a wide sparse input from fleet-summed document
frequencies and a pooled row sample, the growth policy from the global
row count, the objective from the fleet's label set, and the whole fit
runs under ``collective_fit_lock`` so a tuner's threads cannot interleave
its collectives. Inside ``local_fit_mode`` a fit stays serial.

Ported: level-wise (depthwise) and leaf-wise fits (the ``growthPolicy``
default below 262144 rows, with categorical slots as category-set splits)
and their models, dense and wide-sparse features (the top-k columns, and
under leaf-wise growth the tail bundled into categorical composites by
EFB, ``efb.py``), save/load, and JAX-fitted ``boosterState`` dicts of
either kind, which the models take as they are, and elastic fits
(``elasticConfig``: ``engine.fit_gbdt_elastic``, over simulated hosts of
the one device in a world of one rank). The growthPolicy='auto' reroute
counts in ``mmlspark_gbdt_auto_depthwise_reroutes``.

Pipeline fusion (core/capture.py): a level-wise model's ``capture`` is the
dense traced walk (``engine.traced_raw_levelwise``, binning included) in
place of the quantized predict kernel; a leaf-wise model does not capture
and runs its staged transform between segments. ``_fit_captured`` is the
fused featurize -> bin fit: the raw columns go up, the featurize body and
the slab binner run as one program per slab (profile tag
``gbdt.fused_bin``, span ``pipeline/fit_segment``), the bins stay on the
card, and only the float32 labels and the <= 200k-row edge sample come
back.
"""

from __future__ import annotations

import numpy as np

from ...core.dataframe import DataFrame
from ...core.params import (ComplexParam, DictParam, FloatParam,
                            HasFeaturesCol, HasLabelCol, IntParam, ListParam,
                            StringParam)
from ...core.pipeline import Estimator, Model
from ...core.schema import MML_TAG, SparkSchema
from ...core.utils import get_logger, object_column
from ...ops.text_ops import rows_to_matrix
from ...parallel import mesh as meshlib
from . import engine
from .leafwise import LeafwiseEnsemble

_DEVICE_DOC = ("torch device the fit and the fitted model run on: cuda (the "
               "default; raises without a card) or cpu")


class _BoosterParams:
    numIterations = IntParam("number of boosting iterations", default=100, min=1)
    learningRate = FloatParam("shrinkage rate", default=0.1, min=0.0)
    numLeaves = IntParam("max leaves per tree (LightGBMParams.scala:34 "
                         "default 31; best-first growth under the default "
                         "growthPolicy)", default=31, min=2)
    maxBin = IntParam("max feature histogram bins", default=255, min=2)
    maxDepth = IntParam("depth cap; 0 = uncapped for leaf-wise growth / "
                        "derived from numLeaves for depthwise", default=0,
                        min=0)
    growthPolicy = StringParam(
        "leafwise = native-LightGBM best-first growth to numLeaves leaves; "
        "depthwise = level-wise to "
        "maxDepth; auto (default) = leafwise EXCEPT for pure-default fits "
        "at >= 262144 rows, which run depthwise to the numLeaves-equivalent "
        "depth (one level-wise round histograms every node at once). The "
        "trees differ from LightGBM's (balanced 2^depth leaves vs "
        "best-first 31); setting numLeaves/maxDepth/categorical slots "
        "implies leafwise", default="auto",
        choices=("auto", "leafwise", "depthwise"))
    categoricalSlotIndexes = ListParam(
        "feature-vector slot indexes to split as category sets; [] also "
        "auto-detects single-slot categorical columns from the assembled "
        "features metadata", default=())
    catSmooth = FloatParam("categorical smoothing (LightGBM cat_smooth)",
                           default=10.0, min=0.0)
    lambdaL1 = FloatParam("L1 regularization", default=0.0, min=0.0)
    lambdaL2 = FloatParam("L2 regularization", default=1.0, min=0.0)
    minSumHessianInLeaf = FloatParam("min child hessian", default=1e-3, min=0.0)
    baggingFraction = FloatParam("row subsample fraction", default=1.0)
    baggingFreq = IntParam("resample every k iterations (0=off)", default=0)
    featureFraction = FloatParam("feature subsample fraction", default=1.0)
    earlyStoppingRound = IntParam("stop if no improvement for k rounds (0=off)",
                                  default=0)
    parallelism = StringParam(
        "tree_learner (TrainParams.scala): data_parallel = rows sharded "
        "over the ranks + histogram all-reduce; feature_parallel = "
        "histogram work split by feature, split candidates all-gathered "
        "(fit_gbdt with a mesh; the stages shard rows, so a multi-rank "
        "stage fit needs data_parallel); voting_parallel maps to "
        "data_parallel; serial = one device. A world of one rank fits "
        "serially", default="data_parallel",
        choices=("data_parallel", "feature_parallel", "voting_parallel",
                 "serial"))
    seed = IntParam("random seed", default=0)
    elasticConfig = DictParam(
        "elastic boosted fit (resilience/elastic.py): "
        "{'checkpointDir': dir (required; hosts the heartbeat files), "
        "'hosts': N failure domains (0 = one per process; >1 in a world "
        "of one rank = simulated hosts over its device), 'minHosts', "
        "'graceSeconds', 'maxHosts', 'maxFailures'}. A host lost "
        "mid-boosting re-meshes over the survivors and resumes from the "
        "last completed iteration's boosting-state snapshot (a "
        "relaunched host grows the mesh back at the next iteration "
        "boundary) instead of the fit dying. Requires "
        "parallelism=data_parallel (or voting_parallel)", default=None)
    maxDenseFeatures = IntParam(
        "sparse inputs wider than this train on the top-k document-"
        "frequency columns (the dense bin matrix is the device format; "
        "2^18-dim hashed text cannot densify whole)", default=4096, min=1)
    device = StringParam(_DEVICE_DOC, default="cuda")

    def _depth(self) -> int:
        d = self.getOrDefault("maxDepth")
        if d > 0:
            return d
        return max(1, int(np.ceil(np.log2(self.getOrDefault("numLeaves")))))

    def _engine_params(self, objective: str, num_class: int = 1,
                       alpha: float = 0.9, categorical: tuple = (),
                       n_rows: int = None) -> engine.GBDTParams:
        leafwise = self._effective_leafwise(n_rows=n_rows,
                                            categorical=bool(categorical))
        log = get_logger("gbdt")
        if (not leafwise and self.getOrDefault("growthPolicy") == "auto"
                and self._tree_learner() != "feature"):
            log.info(
                "growthPolicy=auto: routing this %s-row pure-default fit "
                "to depthwise growth (balanced 2^%d-leaf trees); set "
                "growthPolicy='leafwise' for native LightGBM best-first "
                "trees", n_rows, self._depth())
            engine._m_auto_depthwise.inc()
        if not leafwise and self.getOrDefault("growthPolicy") == "leafwise":
            log.warning("growthPolicy=leafwise is unavailable with "
                        "feature_parallel; using depthwise growth")
        if categorical and not leafwise:
            if self.getOrDefault("categoricalSlotIndexes"):
                raise ValueError(
                    "categorical splits need growthPolicy='leafwise' (and "
                    "a non-feature_parallel parallelism)")
            log.warning(
                "ignoring auto-detected categorical slots %s: this growth "
                "mode treats them numerically (set growthPolicy='leafwise' "
                "for category-set splits)", list(categorical))
            categorical = ()
        return engine.GBDTParams(
            num_iterations=self.getOrDefault("numIterations"),
            learning_rate=self.getOrDefault("learningRate"),
            max_depth=(self.getOrDefault("maxDepth") if leafwise
                       else self._depth()),
            num_leaves=(self.getOrDefault("numLeaves") if leafwise else 0),
            categorical_feature=tuple(int(j) for j in categorical),
            cat_smooth=self.getOrDefault("catSmooth"),
            max_bin=self.getOrDefault("maxBin"),
            lambda_l1=self.getOrDefault("lambdaL1"),
            lambda_l2=self.getOrDefault("lambdaL2"),
            min_child_weight=self.getOrDefault("minSumHessianInLeaf"),
            bagging_fraction=self.getOrDefault("baggingFraction"),
            bagging_freq=self.getOrDefault("baggingFreq"),
            feature_fraction=self.getOrDefault("featureFraction"),
            early_stopping_round=self.getOrDefault("earlyStoppingRound"),
            objective=objective, num_class=num_class, alpha=alpha,
            seed=self.getOrDefault("seed"),
            tree_learner=self._tree_learner())

    #: auto growth routes pure-default fits at or above this many rows to
    #: the depthwise program
    AUTO_DEPTHWISE_ROWS = 1 << 18

    def _effective_leafwise(self, n_rows: int = None,
                            categorical: bool = False) -> bool:
        """The one place the growth decision lives: leaf-wise unless the
        user chose depthwise, a feature-parallel learner, or — under the
        default "auto" policy — left every tree-shape param at its default
        on a fit of at least AUTO_DEPTHWISE_ROWS rows."""
        if self._tree_learner() == "feature":
            return False
        policy = self.getOrDefault("growthPolicy")
        if policy != "auto":
            return policy == "leafwise"
        if (self.isSet("numLeaves") or self.isSet("maxDepth")
                or categorical
                or self.getOrDefault("categoricalSlotIndexes")):
            return True
        return n_rows is None or n_rows < self.AUTO_DEPTHWISE_ROWS

    def _tree_learner(self) -> str:
        return {"data_parallel": "data", "voting_parallel": "data",
                "feature_parallel": "feature",
                "serial": "serial"}[self.getOrDefault("parallelism")]

    def _mesh(self, n_rows: int = None):
        """The mesh a fit runs on. Inside ``local_fit_mode`` (a tuner's
        trial-to-rank search) the fit stays local and collective-free:
        None. A world of more than one rank always runs the collective
        program, whatever the local shard's size — the JAX stages'
        small-fit heuristic would diverge on per-rank shard sizes, and
        every rank must make the same choice. A world of one rank is the
        JAX stages' single-device case: None. (A rank is a device, so the
        JAX stages' one-process multi-device choice does not arise.)"""
        if meshlib.in_local_fit() or meshlib.effective_process_count() < 2:
            return None
        return meshlib.create_mesh()


def _fleet_fit_guard():
    """One critical section for a whole multi-rank fit (the feature-plan
    collectives and the engine fit): separate lock acquisitions would let
    another thread's collectives land between them in a different order
    on each rank and pair cross-purpose. One-rank fits skip it: the
    tuner's thread pool depends on concurrent serial fits."""
    import contextlib
    if meshlib.effective_process_count() > 1:
        return meshlib.collective_fit_lock
    return contextlib.nullcontext()


def _fleet_doc_freq(mat_csc):
    """Per-column nonzero counts, summed over every rank's shard in a
    multi-rank fit. Feature selection and EFB planning must key off
    fleet-wide statistics: a plan from the local shard would give each
    rank a different column -> feature mapping (a different d, even)
    under trees every rank grows alike. Callers guarantee every rank
    reaches this together (_check_fleet_features)."""
    doc_freq = np.diff(mat_csc.indptr)
    if meshlib.effective_process_count() > 1:
        from ...parallel import dataplane
        doc_freq = dataplane.allreduce_sum(doc_freq.astype(np.int64))
    return doc_freq


def _check_fleet_features(mat):
    """The fleet-consistency gate of a multi-rank fit's feature matrix:
    every later branch in _prepare_fit_features must be taken by every
    rank together (their collectives would otherwise pair cross-purpose
    and hang or corrupt), so the branch inputs (sparse or dense, width)
    are checked fleet-wide here, in one collective every rank reaches."""
    if meshlib.effective_process_count() == 1:
        return
    from ...parallel import dataplane
    info = dataplane.allgather_pyobj(
        (bool(hasattr(mat, "tocsc")), int(mat.shape[1])))
    kinds = {k for k, _ in info}
    widths = {w for _, w in info}
    if len(widths) != 1:
        raise ValueError(
            f"sharded GBDT fit saw different feature widths per process: "
            f"{sorted(widths)}; hash/assemble features with a fixed "
            f"dimension before a fleet fit")
    if len(kinds) != 1:
        raise ValueError(
            "sharded GBDT fit saw sparse feature rows on some processes "
            "and dense on others; use one representation fleet-wide")


#: rows in the fleet-pooled sample EFB planning reads
_EFB_PLAN_SAMPLE_ROWS = 8192


def _pooled_row_sample(mat_csr, seed: int):
    """A fleet-pooled row sample of the sparse matrix (about
    ``_EFB_PLAN_SAMPLE_ROWS`` rows), the same on every rank: each rank
    contributes rows in proportion to its shard size (the engine's
    pooled-edge trade). EFB planning needs global conflict
    statistics: a plan from one shard's bitmaps under-counts conflicts
    and packs bundles that destroy information fleet-wide."""
    import scipy.sparse as sp

    from ...parallel import dataplane
    n = mat_csr.shape[0]
    cap = dataplane.proportional_sample_cap(n, _EFB_PLAN_SAMPLE_ROWS)
    local = mat_csr.tocsr()
    if n > cap:
        rows = np.sort(np.random.default_rng(
            seed ^ (0x9E37 * (meshlib.process_index() + 1))).choice(
                n, cap, replace=False))
        local = local[rows]
    parts = dataplane.allgather_pyobj(local)
    return sp.vstack(parts, format="csr")


def _global_rows(n_local: int) -> int:
    """The fleet-wide row count: the auto growth policy must route every
    rank alike, and shard sizes differ."""
    if meshlib.effective_process_count() > 1:
        from ...parallel import dataplane
        return int(sum(dataplane.allgather_pyobj(int(n_local))))
    return int(n_local)


def _prepare_fit_features(stage, df):
    """Feature matrix for a booster fit: (x, selection, bundles,
    bundle_cat_ids). Dense inputs pass through; wide sparse inputs keep the
    maxDenseFeatures densest columns numeric and, when the growth mode
    supports category-set splits, BUNDLE the tail into categorical
    composites (EFB-lite, efb.py); otherwise the tail is dropped.

    Multi-rank fits select columns from fleet-summed document frequencies
    and plan bundles over a fleet-pooled row sample, so every rank derives
    the same feature mapping from the same global statistics."""
    mat = rows_to_matrix(df.col(stage.getFeaturesCol()))
    if hasattr(mat, "tocsc"):
        mat = mat.tocsc()
    _check_fleet_features(mat)
    # every condition below is a pure function of the params (the same on
    # every rank) and the fleet-checked (kind, width): the ranks branch
    # together
    cap = stage.getMaxDenseFeatures()
    # sparse-wide inputs signal EFB (categorical bundles) intent, which
    # needs leaf-wise growth — categorical=True keeps the auto policy
    # leaf-wise rather than routing large fits depthwise
    if hasattr(mat, "tocsc") and mat.shape[1] > cap \
            and stage._effective_leafwise(n_rows=_global_rows(mat.shape[0]),
                                          categorical=True):
        from .efb import apply_bundles, plan_and_split
        seed = stage.getOrDefault("seed")
        doc_freq = _fleet_doc_freq(mat)
        plan_mat = (_pooled_row_sample(mat, seed).tocsc()
                    if meshlib.effective_process_count() > 1 else mat)
        dense, bundles = plan_and_split(plan_mat, cap,
                                        stage.getOrDefault("maxBin"),
                                        seed, doc_freq=doc_freq)
        xd = _densify(mat, dense)
        if not bundles:
            return xd, dense, None, ()
        xb = apply_bundles(mat, bundles)
        get_logger("gbdt").info(
            "EFB: %d sparse tail columns bundled into %d categorical "
            "composites (+%d dense)", sum(len(b) for b in bundles),
            len(bundles), len(dense))
        x = np.concatenate([xd, xb], axis=1)
        return (x, dense, bundles,
                tuple(range(xd.shape[1], x.shape[1])))
    doc_freq = (_fleet_doc_freq(mat) if hasattr(mat, "tocsc")
                and mat.shape[1] > cap else None)
    sel = _select_features(mat, cap, doc_freq=doc_freq)
    return _densify(mat, sel), sel, None, ()


def _predict_features(df, col, selection, bundles) -> np.ndarray:
    """Transform-time twin of _prepare_fit_features for a fitted model."""
    if not bundles:
        return _features_matrix(df, col, selection)
    from .efb import apply_bundles
    mat = rows_to_matrix(df.col(col))
    if not hasattr(mat, "tocsc"):
        import scipy.sparse as sp
        mat = sp.csc_matrix(np.asarray(mat))
    else:
        mat = mat.tocsc()
    xd = _densify(mat, selection)
    xb = apply_bundles(mat, [np.asarray(b) for b in bundles])
    return np.concatenate([xd, xb], axis=1)


def _densify(mat, selection=None) -> np.ndarray:
    if selection is not None:
        mat = mat.tocsc()[:, selection] if hasattr(mat, "tocsc") \
            else mat[:, selection]
    if hasattr(mat, "toarray"):
        mat = mat.toarray()
    return np.asarray(mat, dtype=np.float32)


def _features_matrix(df: DataFrame, col: str, selection=None) -> np.ndarray:
    return _densify(rows_to_matrix(df.col(col)), selection)


def _select_features(mat, cap: int, doc_freq=None):
    """Keep the ``cap`` highest-document-frequency columns of a sparse
    input wider than ``cap``: sorted column indices, or None when the input
    already fits (dense inputs stay uncapped)."""
    d = mat.shape[1]
    if d <= cap or not hasattr(mat, "tocsc"):
        return None
    if doc_freq is None:
        doc_freq = np.diff(mat.tocsc().indptr)
    sel = np.sort(np.argsort(-doc_freq, kind="stable")[:cap]).astype(np.int64)
    get_logger("gbdt").warning(
        "sparse input has %d features; training on the %d most frequent "
        "(raise maxDenseFeatures to keep more)", d, cap)
    return sel


def _categorical_slots(df: DataFrame, feat_col: str, explicit, sel):
    """Categorical feature-vector slot indexes: the explicit param, else
    width-1 categorical slots read from the assembled-features metadata.
    Indexes remap through the sparse feature selection."""
    idxs = [int(i) for i in explicit]
    was_explicit = bool(idxs)
    if not idxs:
        asm = df.metadata(feat_col).get(MML_TAG, {}).get("assembled")
        if asm:
            for slot in asm.get("slots", {}).values():
                if slot.get("categorical") is not None \
                        and slot.get("width") == 1:
                    idxs.append(int(slot["start"]))
    if sel is not None:
        pos = {int(c): i for i, c in enumerate(sel)}
        dropped = [j for j in idxs if j not in pos]
        if dropped and was_explicit:
            raise ValueError(
                f"categoricalSlotIndexes {dropped} were removed by the "
                f"sparse feature selection (maxDenseFeatures kept "
                f"{len(pos)} columns); raise maxDenseFeatures or drop "
                f"those indexes")
        idxs = [pos[j] for j in idxs if j in pos]
    return tuple(sorted(set(idxs)))


def _fit_ensemble(params_holder, x, y, objective, num_class=1, alpha=0.9,
                  categorical=(), binned=None):
    """``binned=(bins, edges)`` is the fit-side pipeline-fusion form (one
    process only: the fused hook declines multi-rank fits). In a
    multi-rank world ``x`` is this rank's row shard, passed as it is: the
    learners sum histograms, so shards need no padding to equal sizes."""
    n_local = int(binned[0].shape[0]) if binned is not None else x.shape[0]
    p = params_holder._engine_params(objective, num_class, alpha, categorical,
                                     n_rows=_global_rows(n_local))
    device = params_holder.getOrDefault("device")
    ecfg = params_holder.getOrDefault("elasticConfig")
    if ecfg:
        if binned is not None:
            raise ValueError(
                "binned (fused) fits do not support elasticConfig; the "
                "fused hook should have declined this fit")
        if not ecfg.get("checkpointDir"):
            raise ValueError("elasticConfig needs 'checkpointDir' (hosts "
                             "the heartbeat files)")
        if p.tree_learner not in ("data", "auto"):
            raise ValueError(
                "elasticConfig requires a data-parallel fit "
                "(parallelism=data_parallel); got "
                f"{params_holder.getOrDefault('parallelism')!r}")
        # the elastic wrapper pads per attempt (its mesh may shrink or
        # grow), so it takes the RAW rows
        return engine.fit_gbdt_elastic(
            x, y, p,
            checkpoint_dir=ecfg["checkpointDir"],
            n_hosts=int(ecfg.get("hosts", 0)),
            min_hosts=int(ecfg.get("minHosts", 1)),
            grace=ecfg.get("graceSeconds"),
            max_failures=int(ecfg.get("maxFailures", 5)),
            max_hosts=int(ecfg.get("maxHosts", 0)), device=device)
    mesh = params_holder._mesh(n_local)
    if mesh is None:
        return engine.fit_gbdt(x, y, p, binned=binned, device=device)
    if p.tree_learner not in ("data", "auto"):
        raise ValueError(
            "multi-process GBDT fits shard rows across processes and need "
            "parallelism=data_parallel (the reference's per-partition "
            "workers, LightGBMClassifier.scala:35-47); got "
            f"{params_holder.getOrDefault('parallelism')!r}")
    # the stage's fit holds collective_fit_lock here (_fleet_fit_guard)
    return engine.fit_gbdt(x, y, p, mesh=mesh, binned=binned, device=device)


def _fused_categorical_slots(plan, feat_col, explicit):
    """Fit-side twin of :func:`_categorical_slots`: the assembled
    slot-range metadata comes from the capture plan
    (FastVectorAssembler.capture_metadata, computed from the RAW frame)
    instead of a materialized features column. No sparse selection on
    the fused path, so no index remapping."""
    idxs = [int(i) for i in explicit]
    if not idxs:
        meta = (plan.metadata or {}).get(feat_col) or {}
        asm = meta.get(MML_TAG, {}).get("assembled")
        if asm:
            for slot in asm.get("slots", {}).values():
                if slot.get("categorical") is not None \
                        and slot.get("width") == 1:
                    idxs.append(int(slot["start"]))
    return tuple(sorted(set(idxs)))


def _fused_bin_matrix(plan, raws, edges, cat_arr, max_bin, dev):
    """featurize -> bin as ONE program per slab on ``dev``: raw wire-dtype
    columns go up, the featurize body and the slab binner
    (``engine._bin_slab_device``) run through the profiler's executable
    cache (one CUDA graph per slab signature on a card), the uint8 bins
    land in one (n, d) device tensor and only the float32 label column
    comes back — the staged featurized float32 matrix never exists, on
    the host or on the card. Slabs pad to power-of-two buckets like the
    JAX package's, so ragged tails reuse a few signatures. Returns (bins
    (n, d) uint8 on ``dev``, y (n,) float32 numpy)."""
    import torch

    from ... import telemetry
    from ...core import capture as capturelib
    n = len(raws[0])
    d = int(edges.shape[0])
    edges_t, cat = engine._slab_tables(edges, cat_arr, dev)
    fp = plan.device_params(dev)

    def body(*arrs):
        xb, yb = plan.body(fp, arrs)
        xb = xb.to(torch.float32)
        xb = xb.reshape(xb.shape[0], -1)
        return (engine._bin_slab_device(xb, edges_t, cat, int(max_bin)),
                yb.to(torch.float32))

    prog = telemetry.profiler.wrap(body, "gbdt.fused_bin", aot=True)
    slab = engine._BIN_SLAB
    out = torch.empty((n, d), dtype=torch.uint8, device=dev)
    ys = []
    uploaded = 0
    for start in range(0, n, slab):
        sl = [r[start:start + slab] for r in raws]
        m = len(sl[0])
        target = min(1 << max(0, int(np.ceil(np.log2(max(m, 1))))), slab)
        if m < target:
            sl = [np.concatenate(
                [c, np.zeros((target - m,) + c.shape[1:], c.dtype)])
                for c in sl]
        uploaded += sum(int(c.nbytes) for c in sl)
        bd, yd = prog(*(capturelib.upload(np.ascontiguousarray(c), dev)
                        for c in sl))
        out[start:start + m] = bd[:m]
        ys.append(yd[:m])
        capturelib._m_fit_fused.inc()
    y = torch.cat(ys).cpu().numpy()
    capturelib.count_fit_transfer("in", uploaded)
    capturelib.count_fit_transfer("out", y.nbytes)
    return out, y


def _featurized_width(plan, raws) -> int:
    """The featurized row width of ``plan`` over ``raws``, from a run of
    its body on the meta device (shapes only, no data moves); -1 when the
    body does not run there."""
    from ...core.capture import meta_batch
    try:
        xb, _ = plan.body(plan.device_params("meta"), meta_batch(raws))
    except Exception:
        return -1
    return int(np.prod(xb.shape[1:])) if xb.ndim > 1 else 1


def _booster_fit_captured(stage, df, plan, finish):
    """Shared LightGBM fused-fit hook (Pipeline.fit fusePipeline): the
    composed featurize body feeds the device binner directly, so a
    featurize->booster pipeline bins on the device from raw columns with
    no staged featurize materialization. Returns None (-> Pipeline falls
    back to the staged fit) when the path doesn't cover this fit:
    multi-process (bin edges pool from raw row shards), elastic (the
    wrapper re-pads raw rows per attempt), features wider than
    ``maxDenseFeatures`` (selection and EFB need the host matrix), or raw
    columns the plan cannot encode."""
    import torch

    from ... import telemetry
    from ...core import capture as capturelib
    if meshlib.effective_process_count() > 1:
        return None
    if stage.getOrDefault("elasticConfig"):
        return None
    raws = plan.encode(df)
    if raws is None:
        return None
    n = len(raws[0])
    d = _featurized_width(plan, raws)
    if d < 0 or d > stage.getMaxDenseFeatures():
        return None
    dev = engine.torch_device(stage.getOrDefault("device"))
    max_bin = int(stage.getOrDefault("maxBin"))
    cats = _fused_categorical_slots(plan, stage.getFeaturesCol(),
                                    stage.getCategoricalSlotIndexes())
    cat_arr = np.zeros(d, dtype=bool)
    for j in cats:
        cat_arr[j] = True
    # quantile edges from a <= 200k-row featurized sample read back — the
    # SAME rows compute_bin_edges samples from the staged matrix (same
    # rng seed, same cap), so the edges match the staged fit bit for bit;
    # nanquantile is order-invariant
    cap = 200_000
    if n > cap:
        sidx = np.random.default_rng(0).choice(n, cap, replace=False)
        s_raws = [np.ascontiguousarray(r[sidx]) for r in raws]
    else:
        s_raws = raws
    with torch.no_grad():
        xs_d, _ = plan.body(plan.device_params(dev), tuple(
            capturelib.upload(r, dev) for r in s_raws))
        xs = xs_d.to(torch.float32).reshape(len(s_raws[0]), -1) \
            .cpu().numpy()
    capturelib.count_fit_transfer("in",
                                  sum(int(r.nbytes) for r in s_raws))
    capturelib.count_fit_transfer("out", xs.nbytes)
    edges = engine.compute_bin_edges(xs, max_bin)
    with telemetry.trace.span("pipeline/fit_segment",
                              stages=len(plan.pairs), rows=n, path="gbdt"), \
            torch.no_grad():
        bins, y = _fused_bin_matrix(plan, raws, edges, cat_arr, max_bin,
                                    dev)
    return finish(y, bins, edges, cats)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _ensemble_to_state(ens) -> dict:
    """The fitted ensemble as host arrays, in the JAX stages' layout (a
    leaf-wise state carries ``kind`` and its category bitsets as uint32),
    so states of the two packages interchange."""
    state = {"feature": _host(ens.feature), "threshold": _host(ens.threshold),
             "leaf": _host(ens.leaf), "bin_edges": np.asarray(ens.bin_edges),
             "base": np.asarray(ens.base)}
    if isinstance(ens, LeafwiseEnsemble):
        state.update(kind="leafwise", split_leaf=_host(ens.split_leaf),
                     cat_bitset=_host(ens.cat_bitset).astype(np.uint32),
                     is_cat=_host(ens.is_cat),
                     cat_features=np.asarray(ens.cat_features))
    return state


def _state_to_ensemble(state: dict, objective: str, device=None):
    """A ``boosterState`` — the port's, or the JAX stages' as it is — as a
    TreeEnsemble, or a LeafwiseEnsemble for ``kind="leafwise"``, on
    ``device`` (default cuda)."""
    import torch
    dev = engine.torch_device(device or "cuda")

    def put(key, dtype):
        return torch.from_numpy(np.asarray(state[key]).astype(dtype)).to(dev)
    common = dict(feature=put("feature", np.int32),
                  threshold=put("threshold", np.int32),
                  leaf=put("leaf", np.float32),
                  bin_edges=np.asarray(state["bin_edges"], np.float32),
                  base=np.asarray(state["base"], np.float32),
                  objective=objective)
    if state.get("kind") == "leafwise":
        # uint32 words widen to int64 (32 bits per word, as the grower packs)
        return LeafwiseEnsemble(
            split_leaf=put("split_leaf", np.int32),
            cat_bitset=put("cat_bitset", np.uint32).to(torch.int64),
            is_cat=put("is_cat", bool),
            cat_features=np.asarray(state["cat_features"]).astype(bool),
            **common)
    return engine.TreeEnsemble(**common)


def _split_importances(state: dict, selection, bundles,
                       n_features=None) -> np.ndarray:
    """Per-original-feature split counts across the fitted ensemble
    (LightGBM ``importance_type='split'``). Depth-wise trees mark a real
    split with ``threshold < n_bins``; the leaf-wise grower marks no-op
    rounds with ``split_leaf = -1``. Dense splits map back through the
    sparse feature selection; a split on an EFB bundle composite credits
    every member column in the split's category set."""
    feat = np.asarray(state["feature"])
    edges = np.asarray(state["bin_edges"])
    d_internal = edges.shape[0]
    bundles = list(bundles) if bundles else []
    n_dense = d_internal - len(bundles)
    if state.get("kind") == "leafwise":
        real = np.asarray(state["split_leaf"]) >= 0
    else:
        real = np.asarray(state["threshold"]) < edges.shape[1] + 1
    dense_split = real & (feat < n_dense)
    counts = np.bincount(feat[dense_split],
                         minlength=n_dense).astype(np.int64)

    sel = None if selection is None else np.asarray(selection)
    needed = d_internal if sel is None else int(max(
        [sel.max(initial=-1)]
        + [b.max(initial=-1) for b in map(np.asarray, bundles)])) + 1
    if n_features is None:
        n_features = needed
    elif n_features < needed:
        raise ValueError(
            f"n_features ({n_features}) is narrower than the fitted "
            f"feature space (needs >= {needed})")
    out = np.zeros(n_features, np.int64)
    if sel is None:
        out[:n_dense] = counts
    else:
        out[sel[:n_dense]] = counts

    if bundles:
        bits = np.asarray(state["cat_bitset"])   # (T,K,L-1,CAT_WORDS)
        for t, k, r in zip(*np.nonzero(real & (feat >= n_dense))):
            members = np.asarray(bundles[feat[t, k, r] - n_dense])
            w = bits[t, k, r]
            # category c = 1-based member position; category 0 = "no member
            # nonzero". The set may be the complement form ({0} + unused
            # codes routed right, all members left — the "any member
            # nonzero?" split): member bits then carry no signal, and the
            # split reads every member equally.
            in_set = np.asarray(
                [(w[c >> 5] >> np.uint32(c & 31)) & np.uint32(1)
                 for c in range(1, len(members) + 1)], dtype=bool)
            out[members[in_set] if in_set.any() else members] += 1
    return out


def _check_labels(y) -> int:
    """The number of classes of consecutive integer labels. In a
    multi-rank fit the label set is the fleet's (a shard may lack a class,
    and every rank must fit the same objective)."""
    classes = np.unique(y.astype(np.int64))
    integral = bool(np.allclose(y, y.astype(np.int64)))
    if meshlib.effective_process_count() > 1:
        from ...parallel import dataplane
        parts = dataplane.allgather_pyobj((classes, integral))
        classes = np.unique(np.concatenate([c for c, _ in parts]))
        integral = all(i for _, i in parts)
    if not np.array_equal(classes, np.arange(len(classes))) or not integral:
        raise ValueError(
            f"labels must be consecutive integers 0..K-1, got classes "
            f"{classes.tolist()}; index them first (e.g. ValueIndexer)")
    return len(classes)


_PREDICT_IMPL_DOC = (
    "ensemble scoring backend: dense = the int32/f32 tree walk; pallas = "
    "quantized structure-of-arrays tables (uint8 feature/threshold, bf16 "
    "leaf) walked by the predict kernel (ops/csrc/gbdt_predict.cu; its "
    "plain version on the CPU); pallas_int8 = the same kernel with "
    "per-tree-scaled int8 leaf tables (one extra lossy round — explicit "
    "opt-in); auto (default) = the kernel on CUDA when the ensemble fits "
    "its caps, dense otherwise")


class _BoosterModel(Model, HasFeaturesCol):
    _abstract = True
    predictImpl = StringParam(_PREDICT_IMPL_DOC, default="auto",
                              choices=("auto", "dense", "pallas",
                                       "pallas_int8"))
    boosterState = ComplexParam("fitted tree arrays", default=None)
    featureSelection = ComplexParam(
        "column indices the fit kept (sparse wide inputs)", default=None)
    featureBundles = ComplexParam(
        "EFB bundles: tail sparse columns per categorical composite",
        default=None)
    device = StringParam(_DEVICE_DOC, default="cuda")

    def _ensemble(self):
        return _state_to_ensemble(self.getBoosterState(), self.getObjective(),
                                  self.getDevice())

    def _raw(self, df: DataFrame) -> np.ndarray:
        x = _predict_features(df, self.getFeaturesCol(),
                              self.getFeatureSelection(),
                              self.getFeatureBundles())
        return engine.predict_raw(self._ensemble(), x,
                                  predict_impl=self.getPredictImpl())

    def featureImportances(self, n_features=None) -> np.ndarray:
        """Split-count importance per original feature-vector slot
        (LightGBM ``importance_type='split'``). ``n_features`` widens the
        returned vector when trailing slots never split."""
        return _split_importances(self.getBoosterState(),
                                  self.getFeatureSelection(),
                                  self.getFeatureBundles(), n_features)

    def _capture_eligible(self, columns) -> bool:
        """Fused predict covers the dense level-wise path: no leaf-wise
        routing, no sparse feature selection / EFB bundles (host sparse
        work), and not an explicit request for the quantized kernel (the
        fused body is the dense walk)."""
        state = self.getBoosterState()
        return (state is not None and state.get("kind") != "leafwise"
                and self.getFeatureSelection() is None
                and not self.getFeatureBundles()
                and self.getPredictImpl() in ("auto", "dense")
                and self.getFeaturesCol() in columns)

    def _capture_raw(self):
        """``(raw(p, xs) -> (n, K) margins, params)`` of the level-wise
        state: the dense traced walk over the boosterState arrays (the
        STORED arrays — stable identity keeps the fused segment's program
        cache warm across transforms)."""
        import torch
        state = self.getBoosterState()
        leaf = np.asarray(state["leaf"])
        depth = int(np.log2(leaf.shape[2]))
        K = leaf.shape[1]

        def raw(p, xs):
            x = xs[0].to(torch.float32)
            return engine.traced_raw_levelwise(
                p, x.reshape(x.shape[0], -1), depth=depth, K=K)
        params = {"feature": state["feature"],
                  "threshold": state["threshold"], "leaf": state["leaf"],
                  "base": state["base"], "edges": state["bin_edges"]}
        return raw, params


class LightGBMClassificationModel(_BoosterModel):
    rawPredictionCol = StringParam("raw margin column", default="rawPrediction")
    probabilityCol = StringParam("probability column", default="probability")
    predictionCol = StringParam("predicted label column", default="prediction")
    objective = StringParam("binary|multiclass", default="binary")

    def transform(self, df: DataFrame) -> DataFrame:
        raw = self._raw(df)
        prob = engine.prob_from_raw(self.getObjective(), raw)
        out = (df.withColumn(self.getRawPredictionCol(), object_column(raw))
                 .withColumn(self.getProbabilityCol(), object_column(prob))
                 .withColumn(self.getPredictionCol(),
                             prob.argmax(axis=1).astype(np.float64)))
        out = SparkSchema.setScoresColumnName(out, self.getProbabilityCol(),
                                              "classification")
        return SparkSchema.setScoredLabelsColumnName(
            out, self.getPredictionCol(), "classification")

    def capture(self, columns):
        """The dense predict as a pipeline capture
        (engine.traced_raw_levelwise): binning + tree walk + probability
        + argmax inside the enclosing segment's one program."""
        from ...core.capture import StageCapture
        if not self._capture_eligible(columns):
            return None
        raw_fn, params = self._capture_raw()
        objective = self.getObjective()
        raw_col, prob_col = self.getRawPredictionCol(), self.getProbabilityCol()
        pred_col = self.getPredictionCol()

        def fn(p, xs):
            import torch
            raw = raw_fn(p, xs)
            if objective == "binary":
                p1 = torch.sigmoid(raw[:, 0])
                prob = torch.stack([1.0 - p1, p1], dim=1)
            else:
                prob = torch.softmax(raw, dim=-1)
            pred = torch.argmax(prob, dim=-1).to(torch.float32)
            return raw, prob, pred

        def finalize(df):
            out = SparkSchema.setScoresColumnName(df, prob_col,
                                                  "classification")
            return SparkSchema.setScoredLabelsColumnName(
                out, pred_col, "classification")

        return StageCapture(fn, inputs=(self.getFeaturesCol(),),
                            outputs=(raw_col, prob_col, pred_col),
                            params=params,
                            host_cast={pred_col: np.float64},
                            finalize=finalize, tag="gbdt.predict")


class LightGBMClassifier(Estimator, HasFeaturesCol, HasLabelCol, _BoosterParams):
    """Binary/multiclass boosted trees (reference: LightGBMClassifier.scala:32)."""

    def fit(self, df: DataFrame) -> LightGBMClassificationModel:
        with _fleet_fit_guard():
            x, sel, bundles, bundle_cats = _prepare_fit_features(self, df)
            y = np.asarray(df.col(self.getLabelCol())).astype(np.float32)
            num_class = _check_labels(y)
            objective = "binary" if num_class <= 2 else "multiclass"
            cats = _categorical_slots(df, self.getFeaturesCol(),
                                      self.getCategoricalSlotIndexes(), sel)
            ens = _fit_ensemble(
                self, x, y, objective,
                num_class=(num_class if objective == "multiclass" else 1),
                categorical=tuple(cats) + bundle_cats)
        return (LightGBMClassificationModel()
                .setFeaturesCol(self.getFeaturesCol())
                .setObjective(objective)
                .setDevice(self.getDevice())
                .setFeatureSelection(sel)
                .setFeatureBundles(bundles)
                .setBoosterState(_ensemble_to_state(ens)))

    def _fit_captured(self, df: DataFrame, plan):
        """Fused-fit hook (Pipeline fusePipeline): featurize -> bin on the
        device from raw columns, then grow trees from the binned matrix —
        the staged featurized float32 matrix never materializes. Returns
        None to fall back staged when the fused binner does not cover
        this fit (see _booster_fit_captured)."""
        def finish(y, bins, edges, cats):
            num_class = _check_labels(y)
            objective = "binary" if num_class <= 2 else "multiclass"
            ens = _fit_ensemble(
                self, None, y, objective,
                num_class=(num_class if objective == "multiclass" else 1),
                categorical=cats, binned=(bins, edges))
            return (LightGBMClassificationModel()
                    .setFeaturesCol(self.getFeaturesCol())
                    .setObjective(objective)
                    .setDevice(self.getDevice())
                    .setBoosterState(_ensemble_to_state(ens)))
        return _booster_fit_captured(self, df, plan, finish)


class LightGBMRegressionModel(_BoosterModel):
    predictionCol = StringParam("prediction column", default="prediction")
    objective = StringParam("regression|quantile|mae", default="regression")

    def transform(self, df: DataFrame) -> DataFrame:
        pred = engine.prob_from_raw(self.getObjective(),
                                    self._raw(df)).astype(np.float64)
        out = df.withColumn(self.getPredictionCol(), pred)
        return SparkSchema.setScoresColumnName(out, self.getPredictionCol(),
                                               "regression")

    def capture(self, columns):
        """Regression twin of the classifier capture: fused binning +
        tree walk, prediction = the summed raw margin."""
        from ...core.capture import StageCapture
        if not self._capture_eligible(columns):
            return None
        raw_fn, params = self._capture_raw()
        pred_col = self.getPredictionCol()

        def fn(p, xs):
            return (raw_fn(p, xs)[:, 0],)

        def finalize(df):
            return SparkSchema.setScoresColumnName(df, pred_col,
                                                   "regression")

        return StageCapture(fn, inputs=(self.getFeaturesCol(),),
                            outputs=(pred_col,), params=params,
                            host_cast={pred_col: np.float64},
                            finalize=finalize, tag="gbdt.predict")


class LightGBMRegressor(Estimator, HasFeaturesCol, HasLabelCol, _BoosterParams):
    """Boosted-tree regression incl. quantile (reference:
    LightGBMRegressor.scala:34; application=quantile/alpha at
    TrainParams.scala — RegressorTrainParams)."""

    application = StringParam("regression|quantile|mae", default="regression",
                              choices=("regression", "quantile", "mae"))
    alpha = FloatParam("quantile level", default=0.9, min=0.0, max=1.0)

    def fit(self, df: DataFrame) -> LightGBMRegressionModel:
        with _fleet_fit_guard():
            x, sel, bundles, bundle_cats = _prepare_fit_features(self, df)
            y = np.asarray(df.col(self.getLabelCol())).astype(np.float32)
            cats = _categorical_slots(df, self.getFeaturesCol(),
                                      self.getCategoricalSlotIndexes(), sel)
            ens = _fit_ensemble(self, x, y, self.getApplication(),
                                alpha=self.getAlpha(),
                                categorical=tuple(cats) + bundle_cats)
        return (LightGBMRegressionModel()
                .setFeaturesCol(self.getFeaturesCol())
                .setObjective(self.getApplication())
                .setDevice(self.getDevice())
                .setFeatureSelection(sel)
                .setFeatureBundles(bundles)
                .setBoosterState(_ensemble_to_state(ens)))

    def _fit_captured(self, df: DataFrame, plan):
        """Regression twin of LightGBMClassifier._fit_captured."""
        def finish(y, bins, edges, cats):
            ens = _fit_ensemble(self, None, y, self.getApplication(),
                                alpha=self.getAlpha(),
                                categorical=cats, binned=(bins, edges))
            return (LightGBMRegressionModel()
                    .setFeaturesCol(self.getFeaturesCol())
                    .setObjective(self.getApplication())
                    .setDevice(self.getDevice())
                    .setBoosterState(_ensemble_to_state(ens)))
        return _booster_fit_captured(self, df, plan, finish)
