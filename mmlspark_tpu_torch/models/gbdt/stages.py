"""LightGBM-surface estimators backed by the PyTorch boosting engine: the
port of ``mmlspark_tpu/models/gbdt/stages.py``.

API parity with the reference (lightgbm/.../LightGBMClassifier.scala:32-83,
LightGBMRegressor.scala:34, TrainParams.scala) and with the JAX stages: the
same Params, plus ``device`` ("cuda" by default, raising without a card;
"cpu" on request). One card is one serial learner, so ``parallelism`` is
accepted and every fit runs serial, as the JAX stages do on one device.

Ported: level-wise (depthwise) fits and their models, dense and wide-sparse
(top-k columns) features, save/load, and JAX-fitted ``boosterState`` dicts,
which the models take as they are. Not yet, each raising
NotImplementedError: leaf-wise growth — the ``growthPolicy`` default below
262144 rows, categorical splits and EFB bundles (ROADMAP slice 4) — and
``elasticConfig`` (ROADMAP item 13). ``capture``/``_fit_captured`` wait for
the core/capture.py port (item 11).
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
from . import engine

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
        "leafwise = native-LightGBM best-first growth to numLeaves leaves "
        "(not ported yet: ROADMAP slice 4); depthwise = level-wise to "
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
        "tree_learner (TrainParams.scala): data_parallel, "
        "feature_parallel, voting_parallel (maps to data_parallel) or "
        "serial; on one card every fit is serial", default="data_parallel",
        choices=("data_parallel", "feature_parallel", "voting_parallel",
                 "serial"))
    seed = IntParam("random seed", default=0)
    elasticConfig = DictParam(
        "elastic boosted fit (not ported yet: ROADMAP item 13)",
        default=None)
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
        """One card: every fit is the serial program (the JAX stages'
        single-device case)."""
        return None


def _prepare_fit_features(stage, df):
    """Feature matrix for a booster fit: (x, selection, bundles,
    bundle_cat_ids). Dense inputs pass through; wide sparse inputs keep the
    maxDenseFeatures most frequent columns. The EFB branch (wide sparse
    inputs under leaf-wise growth) is slice 4's."""
    mat = rows_to_matrix(df.col(stage.getFeaturesCol()))
    cap = stage.getMaxDenseFeatures()
    if hasattr(mat, "tocsc") and mat.shape[1] > cap \
            and stage._effective_leafwise(n_rows=mat.shape[0],
                                          categorical=True):
        raise NotImplementedError(engine._SLICE_4)
    sel = _select_features(mat, cap)
    return _densify(mat, sel), sel, None, ()


def _predict_features(df, col, selection, bundles) -> np.ndarray:
    """Transform-time twin of _prepare_fit_features for a fitted model."""
    if bundles:
        raise NotImplementedError(engine._SLICE_4)
    return _features_matrix(df, col, selection)


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
    n_rows = int(binned[0].shape[0]) if binned is not None else x.shape[0]
    p = params_holder._engine_params(objective, num_class, alpha, categorical,
                                     n_rows=n_rows)
    if params_holder.getOrDefault("elasticConfig"):
        raise NotImplementedError(
            "elasticConfig waits for the resilience/ port: ROADMAP.md Queue 1 "
            "item 13")
    return engine.fit_gbdt(x, y, p, mesh=params_holder._mesh(n_rows),
                           binned=binned,
                           device=params_holder.getOrDefault("device"))


def _ensemble_to_state(ens) -> dict:
    def host(a):
        return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return {"feature": host(ens.feature), "threshold": host(ens.threshold),
            "leaf": host(ens.leaf), "bin_edges": np.asarray(ens.bin_edges),
            "base": np.asarray(ens.base)}


def _state_to_ensemble(state: dict, objective: str, device=None):
    """A level-wise ``boosterState`` — the port's, or the JAX stages' as it
    is — as a TreeEnsemble on ``device`` (default cuda)."""
    if state.get("kind") == "leafwise":
        raise NotImplementedError(engine._SLICE_4)
    import torch
    dev = engine.torch_device(device or "cuda")
    return engine.TreeEnsemble(
        feature=torch.from_numpy(np.asarray(state["feature"],
                                            np.int32)).to(dev),
        threshold=torch.from_numpy(np.asarray(state["threshold"],
                                              np.int32)).to(dev),
        leaf=torch.from_numpy(np.asarray(state["leaf"], np.float32)).to(dev),
        bin_edges=np.asarray(state["bin_edges"], np.float32),
        base=np.asarray(state["base"], np.float32),
        objective=objective)


def _split_importances(state: dict, selection, bundles,
                       n_features=None) -> np.ndarray:
    """Per-original-feature split counts across the fitted ensemble
    (LightGBM ``importance_type='split'``): a real split has
    ``threshold < n_bins``; splits map back through the sparse feature
    selection."""
    if bundles or state.get("kind") == "leafwise":
        raise NotImplementedError(engine._SLICE_4)
    feat = np.asarray(state["feature"])
    edges = np.asarray(state["bin_edges"])
    d_internal = edges.shape[0]
    real = np.asarray(state["threshold"]) < edges.shape[1] + 1
    counts = np.bincount(feat[real], minlength=d_internal).astype(np.int64)
    sel = None if selection is None else np.asarray(selection)
    needed = d_internal if sel is None else int(sel.max(initial=-1)) + 1
    if n_features is None:
        n_features = needed
    elif n_features < needed:
        raise ValueError(
            f"n_features ({n_features}) is narrower than the fitted "
            f"feature space (needs >= {needed})")
    out = np.zeros(n_features, np.int64)
    if sel is None:
        out[:d_internal] = counts
    else:
        out[sel] = counts
    return out


def _check_labels(y) -> int:
    classes = np.unique(y.astype(np.int64))
    if not np.array_equal(classes, np.arange(len(classes))) or \
            not np.allclose(y, y.astype(np.int64)):
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
        "EFB bundles: tail sparse columns per categorical composite "
        "(slice 4)", default=None)
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


class LightGBMClassifier(Estimator, HasFeaturesCol, HasLabelCol, _BoosterParams):
    """Binary/multiclass boosted trees (reference: LightGBMClassifier.scala:32)."""

    def fit(self, df: DataFrame) -> LightGBMClassificationModel:
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


class LightGBMRegressionModel(_BoosterModel):
    predictionCol = StringParam("prediction column", default="prediction")
    objective = StringParam("regression|quantile|mae", default="regression")

    def transform(self, df: DataFrame) -> DataFrame:
        pred = engine.prob_from_raw(self.getObjective(),
                                    self._raw(df)).astype(np.float64)
        out = df.withColumn(self.getPredictionCol(), pred)
        return SparkSchema.setScoresColumnName(out, self.getPredictionCol(),
                                               "regression")


class LightGBMRegressor(Estimator, HasFeaturesCol, HasLabelCol, _BoosterParams):
    """Boosted-tree regression incl. quantile (reference:
    LightGBMRegressor.scala:34; application=quantile/alpha at
    TrainParams.scala — RegressorTrainParams)."""

    application = StringParam("regression|quantile|mae", default="regression",
                              choices=("regression", "quantile", "mae"))
    alpha = FloatParam("quantile level", default=0.9, min=0.0, max=1.0)

    def fit(self, df: DataFrame) -> LightGBMRegressionModel:
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
