"""Classical learners: the algorithm families TrainClassifier /
TrainRegressor expose — the port of ``mmlspark_tpu/models/classical.py``
(reference: train-classifier/.../TrainClassifier.scala:45-56 supports
LR/DT/RF/GBT/NB/MLP via Spark ML; train-regressor similarly).

Each estimator fits on ``device`` ("cuda" by default; raising without a
card, "cpu" on request):
  * LogisticRegression / LinearRegression — full-batch Adam (optax's adam:
    eps outside the sqrt) from zeros on the (optionally L2-regularized)
    convex objective, the features on the device for the whole fit, every
    product in full float32 (TF32 off, ``full_precision_matmuls``);
  * NaiveBayes — multinomial (Spark ML parity: dense class sums on the
    device with ``index_add_``, sparse ones on the host through scipy) or
    Gaussian (class moments on the device), both closed form;
  * DecisionTree / RandomForest / GBT — thin settings over the port's
    LightGBM stages (RF = LightGBM-style boosting_type=rf bagged mode);
  * MultilayerPerceptron — TorchLearner with an MLP config.

The fitted models score on the host in numpy (``_probs``), as the JAX
package's do, so both packages give the same probabilities from the same
weights. Inside a fused pipeline segment (core/capture.py) they score on
the segment's device instead: ``capture`` runs ``_traced_probs``, the same
math in float32 tensor code. All share the fit(df) -> Model(transform)
contract and emit probability/prediction columns like the GBDT stages.
"""

from __future__ import annotations

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import (ComplexParam, FloatParam, HasFeaturesCol,
                           HasLabelCol, IntParam, ListParam, StringParam)
from ..core.pipeline import Estimator, Model
from ..core.schema import SparkSchema
from ..core.utils import object_column
from ..ops.text_ops import rows_to_matrix
from .gbdt.stages import (LightGBMClassifier, LightGBMRegressor,
                          _features_matrix)

_DEVICE_DOC = ("torch device the fit runs on: 'cuda' (default), 'cuda:N' or "
               "'cpu'. Asking for CUDA where there is none raises")


class _ProbClassifierModel(Model, HasFeaturesCol):
    """Shared transform for linear/NB/MLP classification models."""
    _abstract = True
    probabilityCol = StringParam("probability column", default="probability")
    predictionCol = StringParam("predicted label column", default="prediction")

    def _probs(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _capture_params(self):
        """Param tree for the capture (the STORED arrays, so identity
        changes — new weights — invalidate the cached fused program), or
        None when the model has no device form."""
        return None

    def _capture_place(self, params, device):
        """``params`` on the segment's device (core/capture.place_tree)."""
        from ..core.capture import place_tree
        return place_tree(params, device)

    def _traced_probs(self, p, x):
        """Tensor twin of ``_probs``: ``p`` = ``_capture_params()`` on the
        device, ``x`` an (n, d) float32 tensor."""
        raise NotImplementedError

    def capture(self, columns):
        """Probability + argmax as one body (cross-stage fusion,
        core/capture.py). Host ``_probs`` computes in float64; the fused
        path runs the device dtype (float32) — same values at float32
        precision."""
        from ..core.capture import StageCapture
        params = self._capture_params()
        if params is None or self.getFeaturesCol() not in columns:
            return None
        prob_col, pred_col = self.getProbabilityCol(), self.getPredictionCol()

        def fn(p, xs):
            import torch
            x = xs[0].to(torch.float32)
            prob = self._traced_probs(p, x.reshape(x.shape[0], -1))
            pred = torch.argmax(prob, dim=-1).to(torch.float32)
            return prob, pred

        def finalize(df):
            out = SparkSchema.setScoresColumnName(df, prob_col,
                                                  "classification")
            return SparkSchema.setScoredLabelsColumnName(
                out, pred_col, "classification")

        return StageCapture(fn, inputs=(self.getFeaturesCol(),),
                            outputs=(prob_col, pred_col),
                            params=params,
                            host_cast={pred_col: np.float64},
                            finalize=finalize, tag="classical.predict",
                            place=self._capture_place)

    def _features(self, df: DataFrame):
        """Feature matrix hook — models that can score a sparse matrix
        directly (multinomial NB's one matmul) override to skip _densify."""
        return _features_matrix(df, self.getFeaturesCol())

    def transform(self, df: DataFrame) -> DataFrame:
        x = self._features(df)
        prob = self._probs(x)
        out = (df.withColumn(self.getProbabilityCol(), object_column(prob))
                 .withColumn(self.getPredictionCol(),
                             prob.argmax(axis=1).astype(np.float64)))
        out = SparkSchema.setScoresColumnName(out, self.getProbabilityCol(),
                                              "classification")
        return SparkSchema.setScoredLabelsColumnName(
            out, self.getPredictionCol(), "classification")


# ------------------------------------------------------------------ linear

def _fit_linear(x: np.ndarray, y: np.ndarray, num_out: int, objective: str,
                reg_param: float, max_iter: int, lr: float, device: str):
    """Full-batch Adam on softmax/linear regression from zeros, on
    ``device``. Returns (W, b) as numpy. The JAX package's ``seed`` draws
    nothing (its key is unused), so the fit is deterministic in both."""
    import torch
    import torch.nn.functional as F

    from ..core.env import resolve_device
    from .precision import apply_updates
    from .torch_model import full_precision_matmuls
    from .trainer import _adam
    dev = resolve_device(device, "classical fit")
    xj = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    if objective == "classification":
        yj = torch.from_numpy(np.asarray(y, dtype=np.int64)).to(dev)
    else:
        yj = torch.from_numpy(np.asarray(y, dtype=np.float32)).to(dev)
    d = xj.shape[1]
    params = {"W": torch.zeros((d, num_out), dtype=torch.float32, device=dev),
              "b": torch.zeros((num_out,), dtype=torch.float32, device=dev)}
    tx = _adam(lr)
    opt = tx.init(params)

    def loss(p):
        z = xj @ p["W"] + p["b"]
        if objective == "classification":
            ll = F.cross_entropy(z, yj)
        else:
            ll = torch.mean((z[:, 0] - yj) ** 2)
        return ll + reg_param * torch.sum(p["W"] * p["W"])

    with full_precision_matmuls(True):
        for _ in range(max_iter):
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            grads = dict(zip(p, torch.autograd.grad(loss(p), list(p.values()))))
            updates, opt = tx.update(grads, opt, params)
            params = apply_updates(params, updates)
    return params["W"].cpu().numpy(), params["b"].cpu().numpy()


class LogisticRegressionModel(_ProbClassifierModel):
    coefficients = ComplexParam("weight matrix (d, K)", default=None)
    intercept = ComplexParam("bias (K,)", default=None)

    def _probs(self, x):
        z = x @ np.asarray(self.getCoefficients()) + np.asarray(self.getIntercept())
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def _capture_params(self):
        if self.getCoefficients() is None:
            return None
        return {"W": self.getCoefficients(), "b": self.getIntercept()}

    def _traced_probs(self, p, x):
        import torch
        z = x @ p["W"].to(torch.float32) + p["b"].to(torch.float32)
        return torch.softmax(z, dim=-1)


class LogisticRegression(Estimator, HasFeaturesCol, HasLabelCol):
    regParam = FloatParam("L2 regularization", default=0.0, min=0.0)
    maxIter = IntParam("optimizer iterations", default=200, min=1)
    stepSize = FloatParam("Adam learning rate", default=0.05, min=0.0)
    seed = IntParam("seed", default=0)
    device = StringParam(_DEVICE_DOC, default="cuda")

    def fit(self, df: DataFrame) -> LogisticRegressionModel:
        x = _features_matrix(df, self.getFeaturesCol())
        y = np.asarray(df.col(self.getLabelCol())).astype(np.int64)
        k = int(y.max()) + 1
        W, b = _fit_linear(x, y, max(k, 2), "classification",
                           self.getRegParam(), self.getMaxIter(),
                           self.getStepSize(), self.getDevice())
        return (LogisticRegressionModel()
                .setFeaturesCol(self.getFeaturesCol())
                .setCoefficients(W).setIntercept(b))


class LinearRegressionModel(Model, HasFeaturesCol):
    predictionCol = StringParam("prediction column", default="prediction")
    coefficients = ComplexParam("weights (d, 1)", default=None)
    intercept = ComplexParam("bias (1,)", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        x = _features_matrix(df, self.getFeaturesCol())
        pred = (x @ np.asarray(self.getCoefficients())
                + np.asarray(self.getIntercept()))[:, 0].astype(np.float64)
        out = df.withColumn(self.getPredictionCol(), pred)
        return SparkSchema.setScoresColumnName(out, self.getPredictionCol(),
                                               "regression")

    def capture(self, columns):
        from ..core.capture import StageCapture
        if self.getCoefficients() is None \
                or self.getFeaturesCol() not in columns:
            return None
        pred_col = self.getPredictionCol()

        def fn(p, xs):
            import torch
            x = xs[0].to(torch.float32)
            x = x.reshape(x.shape[0], -1)
            z = x @ p["W"].to(torch.float32) + p["b"].to(torch.float32)
            return (z[:, 0],)

        def finalize(df):
            return SparkSchema.setScoresColumnName(df, pred_col,
                                                   "regression")

        return StageCapture(fn, inputs=(self.getFeaturesCol(),),
                            outputs=(pred_col,),
                            params={"W": self.getCoefficients(),
                                    "b": self.getIntercept()},
                            host_cast={pred_col: np.float64},
                            finalize=finalize, tag="classical.predict")


class LinearRegression(Estimator, HasFeaturesCol, HasLabelCol):
    regParam = FloatParam("L2 regularization", default=0.0, min=0.0)
    maxIter = IntParam("optimizer iterations", default=300, min=1)
    stepSize = FloatParam("Adam learning rate", default=0.05, min=0.0)
    seed = IntParam("seed", default=0)
    device = StringParam(_DEVICE_DOC, default="cuda")

    def fit(self, df: DataFrame) -> LinearRegressionModel:
        x = _features_matrix(df, self.getFeaturesCol())
        y = np.asarray(df.col(self.getLabelCol())).astype(np.float32)
        W, b = _fit_linear(x, y, 1, "regression", self.getRegParam(),
                           self.getMaxIter(), self.getStepSize(),
                           self.getDevice())
        return (LinearRegressionModel()
                .setFeaturesCol(self.getFeaturesCol())
                .setCoefficients(W).setIntercept(b))


# -------------------------------------------------------------- naive bayes

class NaiveBayesModel(_ProbClassifierModel):
    modelType = StringParam("multinomial|gaussian", default="multinomial")
    classLogPriors = ComplexParam("(K,) log priors", default=None)
    means = ComplexParam("(K, d) per-class means (gaussian)", default=None)
    variances = ComplexParam("(K, d) per-class variances (gaussian)",
                             default=None)
    featureLogProbs = ComplexParam(
        "(K, d) per-class log feature probabilities (multinomial theta)",
        default=None)

    def _is_multinomial(self) -> bool:
        # decide by which arrays the fit stored, not the modelType param:
        # artifacts that carry only means/variances load as gaussian
        return self.getFeatureLogProbs() is not None

    def _features(self, df: DataFrame):
        if self._is_multinomial():
            mat = rows_to_matrix(df.col(self.getFeaturesCol()))
            if hasattr(mat, "tocsr"):
                return mat.tocsr()   # sparse scoring: one csr @ dense matmul
            return np.asarray(mat, dtype=np.float32)
        return super()._features(df)

    def _probs(self, x):
        lp = np.asarray(self.getClassLogPriors())
        if self._is_multinomial():
            # z_{ik} = log prior_k + sum_j x_ij * log theta_kj — one matmul
            # (works unchanged for a scipy CSR x: hashed text never
            # densifies)
            z = np.asarray(x @ np.asarray(self.getFeatureLogProbs()).T) \
                + lp[None]
        else:
            mu = np.asarray(self.getMeans())
            var = np.asarray(self.getVariances())
            # gaussian log-likelihood per class, vectorized (n, K)
            ll = -0.5 * (np.log(2 * np.pi * var)[None]
                         + (x[:, None, :] - mu[None]) ** 2
                         / var[None]).sum(axis=2)
            z = ll + lp[None]
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def _capture_params(self):
        lp = self.getClassLogPriors()
        if lp is None:
            return None
        if self._is_multinomial():
            return {"lp": lp, "theta": self.getFeatureLogProbs()}
        if self.getMeans() is None:
            return None
        return {"lp": lp, "mu": self.getMeans(),
                "var": self.getVariances()}

    def _traced_probs(self, p, x):
        import torch
        lp = p["lp"].to(torch.float32)
        if "theta" in p:
            z = x @ p["theta"].to(torch.float32).T + lp[None]
        else:
            mu = p["mu"].to(torch.float32)
            var = p["var"].to(torch.float32)
            ll = -0.5 * (torch.log(2 * np.pi * var)[None]
                         + (x[:, None, :] - mu[None]) ** 2
                         / var[None]).sum(dim=2)
            z = ll + lp[None]
        return torch.softmax(z, dim=-1)


def _nb_inputs(x: np.ndarray, y: np.ndarray, k: int, device: str):
    """(features, labels, a (k, d) zero table) on ``device``: the per-class
    sums are ``zeros.index_add(0, labels, v)``, the JAX package's
    ``segment_sum``."""
    import torch

    from ..core.env import resolve_device
    dev = resolve_device(device, "NaiveBayes")
    xj = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    yj = torch.from_numpy(np.asarray(y, dtype=np.int64)).to(dev)
    return xj, yj, xj.new_zeros((k, xj.shape[1]))


class NaiveBayes(Estimator, HasFeaturesCol, HasLabelCol):
    """Naive Bayes: Spark-ML-parity multinomial default plus Gaussian.

    ``modelType='multinomial'`` matches Spark ML's NaiveBayes — event
    counts over NONNEGATIVE features (hashed text), log theta from
    additively-smoothed per-class feature sums, raising on negative values
    exactly like Spark (reference: TrainClassifier.scala:45-56 wraps Spark
    ML NaiveBayes, whose default is multinomial with smoothing 1.0).
    Sparse inputs stay sparse end to end on the host: the fit is K row-masked
    column sums and scoring is one csr @ dense matmul; dense inputs sum on
    ``device``. ``modelType='gaussian'`` computes closed-form per-class
    moments on ``device`` (an extension Spark ML 2.x lacks)."""
    modelType = StringParam("multinomial = Spark ML parity over nonnegative "
                            "count-like features; gaussian = continuous "
                            "features via per-class moments",
                            default="multinomial",
                            choices=("multinomial", "gaussian"))
    smoothing = FloatParam("additive (Laplace) smoothing for multinomial — "
                           "Spark ML's default 1.0 (values below 1e-10 "
                           "clamp there, as sklearn does: smoothing 0 with "
                           "a class-absent feature would make every "
                           "posterior NaN)", default=1.0, min=0.0)
    varianceSmoothing = FloatParam("variance floor added in gaussian mode",
                                   default=1e-6, min=0.0)
    device = StringParam(_DEVICE_DOC, default="cuda")

    def fit(self, df: DataFrame) -> NaiveBayesModel:
        y = np.asarray(df.col(self.getLabelCol())).astype(np.int32)
        k = int(y.max()) + 1
        counts = np.bincount(y, minlength=k).astype(np.float64)
        model = (NaiveBayesModel().setFeaturesCol(self.getFeaturesCol())
                 .setModelType(self.getModelType())
                 .setClassLogPriors(np.log(counts / counts.sum())))
        if self.getModelType() == "multinomial":
            mat = rows_to_matrix(df.col(self.getFeaturesCol()))
            sparse = hasattr(mat, "tocsr")
            neg = (mat.data.size and mat.data.min() < 0) if sparse \
                else np.any(np.asarray(mat) < 0)
            if neg:
                raise ValueError(
                    "multinomial NaiveBayes requires nonnegative features "
                    "(Spark ML raises the same); use "
                    "setModelType('gaussian') for real-valued features")
            if sparse:
                mat = mat.tocsr()
                sums = np.stack([
                    np.asarray(mat[y == c].sum(axis=0)).ravel()
                    for c in range(k)])
            else:
                xj, yj, zeros = _nb_inputs(mat, y, k, self.getDevice())
                sums = zeros.index_add(0, yj, xj).cpu().numpy()
            sums = sums + max(self.getSmoothing(), 1e-10)
            theta = np.log(sums) - np.log(sums.sum(axis=1, keepdims=True))
            return model.setFeatureLogProbs(theta.astype(np.float32))
        xj, yj, zeros = _nb_inputs(_features_matrix(df, self.getFeaturesCol()),
                                   y, k, self.getDevice())
        sums = zeros.index_add(0, yj, xj).cpu().numpy()
        sqs = zeros.index_add(0, yj, xj * xj).cpu().numpy()
        # the JAX package's jnp.var: the mean of squared deviations
        var_x = xj.var(dim=0, unbiased=False).cpu().numpy()
        c = counts.astype(np.float32)[:, None]
        mu = sums / c
        var = sqs / c - mu * mu + np.float32(self.getVarianceSmoothing()) \
            + np.float32(1e-9) * var_x[None]
        return (model.setMeans(mu)
                .setVariances(np.maximum(var, np.float32(1e-9))))


# ------------------------------------------------------------ tree wrappers

class DecisionTreeClassifier(LightGBMClassifier):
    """Single tree = one boosting iteration at learning rate 1."""
    numIterations = IntParam("fixed to 1 for a single tree", default=1)
    learningRate = FloatParam("fixed to 1 for a single tree", default=1.0)
    maxDepth = IntParam("tree depth", default=5, min=1)


class DecisionTreeRegressor(LightGBMRegressor):
    numIterations = IntParam("fixed to 1 for a single tree", default=1)
    learningRate = FloatParam("fixed to 1 for a single tree", default=1.0)
    maxDepth = IntParam("tree depth", default=5, min=1)


class RandomForestClassifier(LightGBMClassifier):
    """Bagged trees (engine boosting_type=rf), averaged."""
    numIterations = IntParam("number of trees", default=50, min=1)
    baggingFraction = FloatParam("bootstrap fraction", default=0.7)
    baggingFreq = IntParam("resample every tree", default=1)
    featureFraction = FloatParam("features per tree", default=0.7)

    def _engine_params(self, objective, num_class=1, alpha=0.9,
                       categorical=(), n_rows=None):
        return super()._engine_params(objective, num_class, alpha,
                                      categorical, n_rows=n_rows) \
            ._replace(boosting_type="rf")


class RandomForestRegressor(LightGBMRegressor):
    numIterations = IntParam("number of trees", default=50, min=1)
    baggingFraction = FloatParam("bootstrap fraction", default=0.7)
    baggingFreq = IntParam("resample every tree", default=1)
    featureFraction = FloatParam("features per tree", default=0.7)

    def _engine_params(self, objective, num_class=1, alpha=0.9,
                       categorical=(), n_rows=None):
        return super()._engine_params(objective, num_class, alpha,
                                      categorical, n_rows=n_rows) \
            ._replace(boosting_type="rf")


class GBTClassifier(LightGBMClassifier):
    """Gradient-boosted trees, Spark ML surface name."""


class GBTRegressor(LightGBMRegressor):
    pass


# ---------------------------------------------------------------------- mlp

class MultilayerPerceptronClassifier(Estimator, HasFeaturesCol, HasLabelCol):
    layers = ListParam("hidden layer sizes", default=(64,))
    maxIter = IntParam("epochs", default=30, min=1)
    stepSize = FloatParam("learning rate", default=0.02, min=0.0)
    batchSize = IntParam("batch size", default=128, min=1)
    seed = IntParam("seed", default=0)
    device = StringParam(_DEVICE_DOC, default="cuda")

    def fit(self, df: DataFrame):
        from ..core.utils import to_float32_matrix
        from .trainer import TorchLearner
        y = np.asarray(df.col(self.getLabelCol())).astype(np.int64)
        k = int(y.max()) + 1
        # standardize features (fitted mean/std applied again at transform):
        # MLP convergence on raw-scale columns is luck-of-the-batch-order;
        # tree learners are scale-free so only this wrapper needs it
        mat = to_float32_matrix(df.col(self.getFeaturesCol()))
        from ..parallel import dataplane
        if dataplane.is_sharded(df):
            # fleet-wide moments: each shard must standardize identically
            # (the DP gradient all-reduce mixes everyone's batches), and
            # every rank must build the same head (a shard may lack the
            # top class)
            tot = dataplane.allreduce_sum(np.stack([
                np.full(mat.shape[1], float(len(mat))),
                mat.sum(axis=0, dtype=np.float64),
                (mat.astype(np.float64) ** 2).sum(axis=0)]))
            cnt = np.maximum(tot[0], 1.0)
            mu = tot[1] / cnt
            sd = np.sqrt(np.maximum(tot[2] / cnt - mu ** 2, 0.0))
            k = max(dataplane.allgather_pyobj(k))
        else:
            mu = mat.mean(axis=0)
            sd = mat.std(axis=0)
        sd[sd < 1e-7] = 1.0
        sdf = df.withColumn(self.getFeaturesCol(),
                            object_column(((mat - mu) / sd)
                                          .astype(np.float32)))
        learner = (TorchLearner()
                   .setFeaturesCol(self.getFeaturesCol())
                   .setLabelCol(self.getLabelCol())
                   .setModelConfig({"type": "mlp",
                                    "hidden": list(self.getLayers()),
                                    "num_classes": max(k, 2)})
                   .setEpochs(self.getMaxIter())
                   .setBatchSize(self.getBatchSize())
                   .setLearningRate(self.getStepSize())
                   .setOptimizer("adam")
                   .setSeed(self.getSeed())
                   .setDevice(self.getDevice()))
        inner = learner.fit(sdf)
        return (MLPClassificationModel()
                .setFeaturesCol(self.getFeaturesCol())
                .setInner(inner)
                .setFeatureMean(mu.astype(np.float64))
                .setFeatureScale(sd.astype(np.float64)))


class MLPClassificationModel(_ProbClassifierModel):
    inner = ComplexParam("fitted TorchModel", default=None)
    featureMean = ComplexParam("standardization mean", default=None)
    featureScale = ComplexParam("standardization scale", default=None)

    def _capture_params(self):
        tm = self.getInner()
        if tm is None or tm.getModelParams() is None \
                or tm.getModelConfig() is None \
                or tm.getTensorParallel() > 1:
            return None
        p = {"inner": tm.getModelParams()}
        if self.getFeatureMean() is not None:
            p["mu"] = self.getFeatureMean()
            p["sd"] = self.getFeatureScale()
        return p

    def _capture_place(self, params, device):
        # the inner net's weights live in its own device module
        # (TorchModel._device_module): only the standardization uploads
        from ..core.capture import place_tree
        rest = {k: v for k, v in params.items() if k != "inner"}
        return place_tree(rest, device)

    def _traced_probs(self, p, x):
        import torch

        from .modules import sized_for
        tm = self.getInner()
        if "mu" in p:
            x = (x - p["mu"].to(torch.float32)) / p["sd"].to(torch.float32)
        module = tm._device_module(x.device,
                                   sized_for(tm.getModelConfig(), x.shape))
        return torch.softmax(module(x).float(), dim=-1)

    def _probs(self, x):
        import scipy.special
        tm = self.getInner()
        if self.getFeatureMean() is not None:
            x = (x - np.asarray(self.getFeatureMean())) \
                / np.asarray(self.getFeatureScale())
        feats = object_column(x.astype(np.float32))
        tmp = DataFrame({"features": feats})
        logits = np.stack(list(
            tm.setInputCol("features").setOutputCol("scores")
            .transform(tmp).col("scores")))
        return scipy.special.softmax(logits, axis=1)
