"""The port's classical learners against the JAX package's.

The same seeded numpy frames go through ``mmlspark_tpu.models.classical``
and the port's ``models/classical.py`` (``device="cpu"``). Tolerances:
LogisticRegression and LinearRegression weights within 1e-5 relative L2
(both fit from zeros by full-batch Adam; float32 rounding only); Naive
Bayes arrays within 1e-6 relative (multinomial dense and CSR, gaussian);
``_probs`` from the same arrays within 1e-6 absolute (host numpy on both
sides); the MLP classifier's probabilities from carried-over JAX weights in
a float32 config within 1e-5. The tree wrappers' engine params are equal.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.models import classical as J
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.models.tpu_model import TpuModel
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.serialize import load_stage
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.models import classical as P
from mmlspark_tpu_torch.models.torch_model import (TorchModel,
                                                   full_precision_matmuls)

TOL_LINEAR = 1e-5
TOL_NB = 1e-6
TOL_PROBS = 1e-6
TOL_MLP = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _frames(x, y):
    """The same (features, label) frame for both packages; ``x`` dense or
    CSR."""
    if sp.issparse(x):
        rows = [x.getrow(i) for i in range(x.shape[0])]
    else:
        rows = list(np.asarray(x, np.float32))
    col = object_column(rows)
    return (DataFrame({"features": col, "label": y}),
            JaxDataFrame({"features": col.copy(), "label": y.copy()}))


def _data(n=300, d=6, k=2, seed=0, nonneg=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, k))
    y = (x @ w + rng.normal(0, 0.5, (n, k))).argmax(axis=1)
    if nonneg:
        x = np.abs(x) * 3
    return x, y.astype(np.int64)


@pytest.mark.parametrize("k,reg,iters", [(2, 0.0, 60), (3, 0.0, 80),
                                         (2, 0.1, 40), (4, 0.01, 120)])
def test_logistic_regression_weights(k, reg, iters):
    df, jdf = _frames(*_data(k=k, seed=k))
    kw = dict(regParam=reg, maxIter=iters)
    m = P.LogisticRegression(device="cpu", **kw).fit(df)
    jm = J.LogisticRegression(**kw).fit(jdf)
    assert _rel(m.getCoefficients(), jm.getCoefficients()) <= TOL_LINEAR
    assert _rel(m.getIntercept(), jm.getIntercept()) <= TOL_LINEAR
    p = np.stack(m.transform(df).col("probability"))
    jp = np.stack(jm.transform(jdf).col("probability"))
    assert np.abs(p - jp).max() <= 1e-5


@pytest.mark.parametrize("reg", [0.0, 0.05])
def test_linear_regression_weights(reg):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    y = (x @ rng.normal(size=5) + 0.3 + rng.normal(0, 0.1, 200)) \
        .astype(np.float64)
    df, jdf = _frames(x, y)
    m = P.LinearRegression(device="cpu", regParam=reg, maxIter=150).fit(df)
    jm = J.LinearRegression(regParam=reg, maxIter=150).fit(jdf)
    assert _rel(m.getCoefficients(), jm.getCoefficients()) <= TOL_LINEAR
    assert _rel(m.getIntercept(), jm.getIntercept()) <= TOL_LINEAR
    out = m.transform(df)
    assert out.col("prediction").dtype == np.float64
    assert np.abs(out.col("prediction")
                  - jm.transform(jdf).col("prediction")).max() <= 1e-4


@pytest.mark.parametrize("sparse,smoothing", [(False, 1.0), (True, 1.0),
                                              (False, 0.0), (True, 0.3)])
def test_naive_bayes_multinomial(sparse, smoothing):
    x, y = _data(n=240, d=12, k=3, seed=5, nonneg=True)
    x[x < 1.5] = 0.0
    df, jdf = _frames(sp.csr_matrix(x) if sparse else x, y)
    m = P.NaiveBayes(device="cpu", smoothing=smoothing).fit(df)
    jm = J.NaiveBayes(smoothing=smoothing).fit(jdf)
    assert _rel(m.getFeatureLogProbs(), jm.getFeatureLogProbs()) <= TOL_NB
    assert np.array_equal(m.getClassLogPriors(), jm.getClassLogPriors())
    p = np.stack(m.transform(df).col("probability"))
    jp = np.stack(jm.transform(jdf).col("probability"))
    assert np.abs(p - jp).max() <= TOL_PROBS


@pytest.mark.parametrize("smoothing", [1e-6, 1e-2])
def test_naive_bayes_gaussian(smoothing):
    x, y = _data(n=260, d=7, k=3, seed=6)
    df, jdf = _frames(x, y)
    kw = dict(modelType="gaussian", varianceSmoothing=smoothing)
    m = P.NaiveBayes(device="cpu", **kw).fit(df)
    jm = J.NaiveBayes(**kw).fit(jdf)
    for get in ("getMeans", "getVariances"):
        got, want = getattr(m, get)(), getattr(jm, get)()
        assert got.dtype == want.dtype and _rel(got, want) <= TOL_NB
    p = np.stack(m.transform(df).col("probability"))
    jp = np.stack(jm.transform(jdf).col("probability"))
    assert np.abs(p - jp).max() <= TOL_PROBS


@pytest.mark.parametrize("sparse", [False, True])
def test_naive_bayes_rejects_negative_features(sparse):
    x, y = _data(n=50, seed=7)
    df, jdf = _frames(sp.csr_matrix(x) if sparse else x, y)
    for est, frame in ((P.NaiveBayes(device="cpu"), df),
                       (J.NaiveBayes(), jdf)):
        with pytest.raises(ValueError, match="nonnegative"):
            est.fit(frame)


def _probs_pair(kind, rng):
    d, k = 5, 3
    if kind == "lr":
        w = rng.normal(size=(d, k)).astype(np.float32)
        b = rng.normal(size=k).astype(np.float32)
        return (P.LogisticRegressionModel(coefficients=w, intercept=b),
                J.LogisticRegressionModel(coefficients=w, intercept=b))
    lp = np.log(np.array([0.2, 0.5, 0.3]))
    if kind == "nb_multinomial":
        theta = np.log(rng.dirichlet(np.ones(d), size=k)).astype(np.float32)
        return (P.NaiveBayesModel(classLogPriors=lp, featureLogProbs=theta),
                J.NaiveBayesModel(classLogPriors=lp, featureLogProbs=theta))
    mu = rng.normal(size=(k, d)).astype(np.float32)
    var = (rng.random((k, d)) + 0.1).astype(np.float32)
    return (P.NaiveBayesModel(classLogPriors=lp, means=mu, variances=var),
            J.NaiveBayesModel(classLogPriors=lp, means=mu, variances=var))


@pytest.mark.parametrize("kind", ["lr", "nb_multinomial", "nb_gaussian"])
def test_probs_same_from_same_arrays(kind):
    rng = np.random.default_rng(8)
    model, jmodel = _probs_pair(kind, rng)
    x = np.abs(rng.normal(size=(40, 5))).astype(np.float32)
    assert np.abs(model._probs(x) - jmodel._probs(x)).max() <= TOL_PROBS
    df, jdf = _frames(x, np.zeros(40, np.int64))
    out, jout = model.transform(df), jmodel.transform(jdf)
    assert np.array_equal(out.col("prediction"), jout.col("prediction"))
    assert (out.metadata("prediction") == jout.metadata("prediction"))


@pytest.mark.parametrize("name", ["DecisionTreeClassifier",
                                  "DecisionTreeRegressor",
                                  "RandomForestClassifier",
                                  "RandomForestRegressor", "GBTClassifier",
                                  "GBTRegressor"])
@pytest.mark.parametrize("n_rows", [1000, 1 << 19])
def test_tree_wrappers_engine_params(name, n_rows):
    objective = "binary" if name.endswith("Classifier") else "regression"
    got = getattr(P, name)()._engine_params(objective, n_rows=n_rows)
    want = getattr(J, name)()._engine_params(objective, n_rows=n_rows)
    assert got._asdict() == want._asdict()
    assert (got.boosting_type == "rf") == name.startswith("RandomForest")


@pytest.mark.parametrize("standardize", [False, True])
def test_mlp_probs_from_jax_weights(standardize):
    """MLPClassificationModel._probs over a TorchModel holding the JAX
    package's flax params (float32 config) against the JAX model's."""
    rng = np.random.default_rng(9)
    cfg = {"type": "mlp", "hidden": [16, 8], "num_classes": 3,
           "dtype": "float32"}
    x = rng.normal(size=(33, 6)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(
        jax.random.PRNGKey(2), jnp.asarray(x[:2])))
    kw = {}
    if standardize:
        kw = dict(featureMean=x.mean(axis=0).astype(np.float64),
                  featureScale=x.std(axis=0).astype(np.float64))
    jm = J.MLPClassificationModel(
        inner=TpuModel(modelConfig=cfg, modelParams=params), **kw)
    m = P.MLPClassificationModel(
        inner=TorchModel(modelConfig=cfg, modelParams=params, device="cpu"),
        **kw)
    assert np.abs(m._probs(x) - jm._probs(x)).max() <= TOL_MLP


def test_mlp_fit_on_cpu_and_round_trip(tmp_path):
    x, y = _data(n=256, d=5, k=2, seed=10)
    df, _ = _frames(x, y)
    m = P.MultilayerPerceptronClassifier(device="cpu", maxIter=20,
                                         layers=(16,)).fit(df)
    out = m.transform(df)
    acc = float((out.col("prediction") == y).mean())
    assert acc >= 0.85
    m.save(str(tmp_path / "mlp"))
    loaded = load_stage(str(tmp_path / "mlp"))
    assert np.allclose(np.stack(loaded.transform(df).col("probability")),
                       np.stack(out.col("probability")), atol=1e-6)


@pytest.mark.parametrize("make", [
    lambda: P.LogisticRegression(), lambda: P.LinearRegression(),
    lambda: P.NaiveBayes(modelType="gaussian"),
    lambda: P.NaiveBayes(),
    lambda: P.MultilayerPerceptronClassifier(),
    lambda: P.RandomForestClassifier()])
def test_estimators_default_to_cuda(make):
    est = make()
    assert est.getDevice() == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    df, _ = _frames(*_data(n=20, seed=11, nonneg=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        est.fit(df)


@pytest.mark.parametrize("name", ["LogisticRegressionModel",
                                  "LinearRegressionModel", "NaiveBayesModel"])
def test_fitted_models_round_trip(tmp_path, name):
    x, y = _data(n=60, seed=12, nonneg=True)
    df, _ = _frames(x, y)
    est = {"LogisticRegressionModel": P.LogisticRegression(maxIter=5),
           "LinearRegressionModel": P.LinearRegression(maxIter=5),
           "NaiveBayesModel": P.NaiveBayes()}[name]
    model = est.setDevice("cpu").fit(df)
    model.save(str(tmp_path / name))
    loaded = load_stage(str(tmp_path / name))
    assert type(loaded).__name__ == name
    col = "prediction" if name == "LinearRegressionModel" else "probability"
    assert np.array_equal(np.stack(loaded.transform(df).col(col)),
                          np.stack(model.transform(df).col(col)))


def test_full_precision_blocks_of_threads_overlap():
    """Two threads are inside ``full_precision_matmuls(True)`` at once:
    the second enters while the first is still in its block, and leaving
    the first does not turn TF32 back on under the second."""
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    flags.allow_tf32 = True
    first_in, second_in, first_out = (threading.Event() for _ in range(3))
    seen = {}

    def first():
        with full_precision_matmuls(True):
            first_in.set()
            seen["overlap"] = second_in.wait(timeout=10)
        first_out.set()

    def second():
        first_in.wait(timeout=10)
        with full_precision_matmuls(True):
            second_in.set()
            first_out.wait(timeout=10)
            seen["after_first_left"] = flags.allow_tf32
    try:
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert seen == {"overlap": True, "after_first_left": False}
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = before


def test_full_precision_block_holds_across_threads():
    """Threads entering and leaving ``full_precision_matmuls(True)`` at
    once: each sees TF32 off throughout its block, and the switches end as
    they began (here: on)."""
    flags = torch.backends.cuda.matmul
    before = (flags.allow_tf32, torch.backends.cudnn.allow_tf32)
    flags.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    seen_on = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with full_precision_matmuls(True):
                    for _ in range(5):
                        if flags.allow_tf32 or \
                                torch.backends.cudnn.allow_tf32:
                            seen_on.append(True)
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not seen_on
        assert flags.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        sys.setswitchinterval(interval)
        flags.allow_tf32, torch.backends.cudnn.allow_tf32 = before
