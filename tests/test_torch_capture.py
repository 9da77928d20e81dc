"""The port's whole-pipeline capture (``mmlspark_tpu_torch/core/capture.py``)
against the JAX package's ``mmlspark_tpu/core/capture.py``.

* every capture body: the same seeded numpy inputs through the port's
  ``cap.fn`` (placed params, CPU tensors) and the JAX package's
  ``jax.jit(cap.fn)``, within rtol 1e-4 / atol 1e-5 (the JAX package's own
  lowering-parity gate), over a builder for every port class that defines
  ``capture`` (the sweep fails when an override lands without one);
* fused vs staged ``PipelineModel.transform`` for the JAX package's six
  parity pipelines, metadata and dtypes included (rtol 1e-4; atol 1e-5,
  1e-4 for boosters and Naive Bayes, 1e-3 for the net, as there);
* one program per segment (one dispatch, one capture, a replay on the
  second transform, a new capture per row count), transfer bytes at the
  boundaries only, segment splitting at prefix, middle and suffix, and the
  counted ragged-row fallback;
* the pipeline serving composite: replies equal the staged pipeline's, a
  bundle round trip loads warm with no capture counted, a torn pipeline
  shard raises CorruptCheckpoint, a torn capture record degrades one
  bucket, and serve_continuous serves the composite.

Everything runs on the CPU (``device="cpu"``), where a segment's program is
the function itself, cached once it has run.
"""

import base64
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import DataFrame as JaxDataFrame
from mmlspark_tpu.models import classical as J
from mmlspark_tpu.models.gbdt import stages as jstages
from mmlspark_tpu.models.modules import build_model as jax_build_model
from mmlspark_tpu.models.tpu_model import TpuModel
from mmlspark_tpu.stages import basic as jbasic
from mmlspark_tpu.stages import data_stages as jdata
from mmlspark_tpu_torch import DataFrame, telemetry
from mmlspark_tpu_torch.core import capture as capturelib
from mmlspark_tpu_torch.core.capture import StageCapture
from mmlspark_tpu_torch.core.pipeline import (Pipeline, PipelineModel,
                                              Transformer,
                                              registered_stages)
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.io.serving import (BucketPolicy, FusedServingStep,
                                           load_bundle, save_bundle,
                                           serve_continuous)
from mmlspark_tpu_torch.models import classical as P
from mmlspark_tpu_torch.models.gbdt import stages as tstages
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.trainer import TorchLearner
from mmlspark_tpu_torch.resilience.ckpt import CorruptCheckpoint
from mmlspark_tpu_torch.stages import basic as tbasic
from mmlspark_tpu_torch.stages import data_stages as tdata

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def tel():
    telemetry.registry.reset()
    telemetry.enable()
    yield telemetry
    telemetry.disable()


def _counter_total(name):
    snap = telemetry.snapshot()
    return sum(s["value"] for s in snap.get(name, {}).get("series", []))


def _col_matrix(df, name):
    col = df.col(name)
    if col.dtype.kind == "O":
        return np.stack([np.asarray(v) for v in col])
    return np.asarray(col)


# ------------------------------------------------ capture bodies vs JAX

def _twin_frames(cols: dict):
    return DataFrame(dict(cols)), JaxDataFrame(
        {k: (v.copy() if hasattr(v, "copy") else v) for k, v in cols.items()})


def _builders():
    """name -> () -> (port stage, JAX stage, port frame, JAX frame): one
    or more cases per port class DEFINING capture(), the two stages built
    from the same numpy arrays (or fitted on the same frame)."""
    rng = np.random.default_rng(0)
    n = 48
    f0, f1 = rng.normal(size=n), rng.normal(size=n)
    f0[::7] = np.nan
    base = {"f0": f0, "f1": f1,
            "label": rng.integers(0, 2, n).astype(np.int64)}
    xm = rng.normal(size=(n, 4)).astype(np.float32)
    feat = {"features": object_column(list(xm)),
            "label": rng.integers(0, 2, n).astype(np.int64)}
    reg = {"features": object_column(list(xm)),
           "label": rng.normal(size=n)}
    W, b = rng.normal(size=(4, 3)), rng.normal(size=3)

    def plain(tcls, jcls, frame, **kw):
        return lambda: (tcls(**kw), jcls(**kw), *_twin_frames(frame))

    def clean():
        tdf, jdf = _twin_frames(base)
        return (tdata.CleanMissingData(inputCols=("f0", "f1")).fit(tdf),
                jdata.CleanMissingData(inputCols=("f0", "f1")).fit(jdf),
                tdf, jdf)

    def logistic():
        kw = dict(coefficients=W, intercept=b)
        return (P.LogisticRegressionModel(**kw),
                J.LogisticRegressionModel(**kw), *_twin_frames(feat))

    def nb(kind):
        lp = np.log(np.array([0.2, 0.3, 0.5]))
        kw = ({"featureLogProbs": np.log(rng.dirichlet(np.ones(4), 3))}
              if kind == "multinomial" else
              {"means": rng.normal(size=(3, 4)),
               "variances": rng.random((3, 4)) + 0.2})
        cols = dict(feat, features=object_column(list(np.abs(xm))))
        return lambda: (P.NaiveBayesModel(classLogPriors=lp, **kw),
                        J.NaiveBayesModel(classLogPriors=lp, **kw),
                        *_twin_frames(cols))

    cfg = {"type": "mlp", "hidden": [8], "num_classes": 2,
           "dtype": "float32"}
    flax = jax.tree_util.tree_map(np.asarray, jax_build_model(cfg).init(
        jax.random.PRNGKey(3), jnp.asarray(xm[:2])))

    def mlp():
        kw = dict(featureMean=xm.mean(axis=0).astype(np.float64),
                  featureScale=xm.std(axis=0).astype(np.float64))
        return (P.MLPClassificationModel(inner=TorchModel(
                    modelConfig=cfg, modelParams=flax, device="cpu"), **kw),
                J.MLPClassificationModel(inner=TpuModel(
                    modelConfig=cfg, modelParams=flax), **kw),
                *_twin_frames(feat))

    def linreg():
        kw = dict(coefficients=W[:, :1], intercept=b[:1])
        return (P.LinearRegressionModel(**kw),
                J.LinearRegressionModel(**kw), *_twin_frames(reg))

    def torch_model():
        kw = dict(modelConfig=cfg, modelParams=flax)
        return (TorchModel(device="cpu", **kw), TpuModel(**kw),
                *_twin_frames(feat))

    def booster(kind):
        def build():
            tdf, jdf = _twin_frames(reg if kind == "reg" else feat)
            est = (jstages.LightGBMRegressor if kind == "reg"
                   else jstages.LightGBMClassifier)
            jm = est(numIterations=3, growthPolicy="depthwise").fit(jdf)
            tcls = (tstages.LightGBMRegressionModel if kind == "reg"
                    else tstages.LightGBMClassificationModel)
            tm = tcls(boosterState=jm.getBoosterState(), device="cpu",
                      objective=jm.getObjective())
            return tm, jm, tdf, jdf
        return build

    return {
        "CleanMissingDataModel": clean,
        "DataConversion": plain(tdata.DataConversion, jdata.DataConversion,
                                base, cols=("f1",), convertTo="float"),
        "DataConversion:integer": plain(
            tdata.DataConversion, jdata.DataConversion, base,
            cols=("label",), convertTo="integer"),
        "DropColumns": plain(tbasic.DropColumns, jbasic.DropColumns, base,
                             cols=("f1",)),
        "SelectColumns": plain(tbasic.SelectColumns, jbasic.SelectColumns,
                               base, cols=("f0", "label")),
        "RenameColumn": plain(tbasic.RenameColumn, jbasic.RenameColumn,
                              base, inputCol="f0", outputCol="g0"),
        "FastVectorAssembler": plain(
            tbasic.FastVectorAssembler, jbasic.FastVectorAssembler, base,
            inputCols=("f0", "f1", "label"), outputCol="features"),
        "_ProbClassifierModel": logistic,
        "_ProbClassifierModel:nb_gaussian": nb("gaussian"),
        "_ProbClassifierModel:nb_multinomial": nb("multinomial"),
        "_ProbClassifierModel:mlp": mlp,
        "LinearRegressionModel": linreg,
        "TorchModel": torch_model,
        "LightGBMClassificationModel": booster("cls"),
        "LightGBMRegressionModel": booster("reg"),
    }


def _capture_definer(cls):
    for c in cls.__mro__:
        if "capture" in c.__dict__:
            return None if c.__module__.endswith("core.pipeline") \
                else c.__name__
    return None


def test_every_capture_override_has_a_builder():
    definers = {d for cls in registered_stages().values()
                if issubclass(cls, Transformer)
                and cls.__module__.startswith("mmlspark_tpu_torch.")
                and (d := _capture_definer(cls))}
    built = {name.split(":")[0] for name in _builders()}
    assert definers == built, (
        "capture() overrides without a parity builder (extend _builders): "
        f"{definers ^ built}")


def _encode_like_jax(df, name):
    col = df.col(name)
    if col.dtype.kind == "O":
        return np.stack([np.asarray(v, np.float32) for v in col])
    return np.asarray(col)


@pytest.mark.parametrize("name", sorted(_builders()))
def test_capture_body_matches_jax(name):
    """The port's capture body on CPU tensors (inputs in the device
    dtypes, as a segment uploads them) against ``jax.jit`` of the JAX
    capture's body on the same arrays, and both against the staged
    transform's columns."""
    tstage, jstage, tdf, jdf = _builders()[name]()
    tcap = tstage.capture(list(tdf.columns))
    jcap = jstage.capture(list(jdf.columns))
    assert tcap is not None and jcap is not None, name
    assert (tcap.inputs, tcap.outputs, tcap.drops) == \
        (jcap.inputs, jcap.outputs, jcap.drops)
    assert tcap.host_cast == jcap.host_cast
    tparams = tcap.place(tcap.params, torch.device("cpu"))
    touts = tcap.fn(tparams, tuple(
        torch.from_numpy(capturelib.encode_column(tdf.col(c)))
        for c in tcap.inputs))
    jouts = jax.jit(jcap.fn)(jcap.params, tuple(
        jnp.asarray(_encode_like_jax(jdf, c)) for c in jcap.inputs))
    if not isinstance(jouts, (tuple, list)):
        jouts = (jouts,)
    staged = tstage.transform(tdf)
    assert len(touts) == len(jouts) == len(tcap.outputs)
    for out_name, got, want in zip(tcap.outputs, touts, jouts):
        got = got.numpy()
        assert got.dtype == np.asarray(want).dtype, out_name
        np.testing.assert_allclose(got.astype(np.float64),
                                   np.asarray(want, np.float64),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}:{out_name}")
        np.testing.assert_allclose(
            got.astype(np.float64),
            _col_matrix(staged, out_name).astype(np.float64),
            rtol=RTOL, atol=ATOL, err_msg=f"{name}:{out_name} vs staged")


# ------------------------------------------------- fused vs staged frames

def _frame(n=200, d=4, seed=0, nans=True):
    rng = np.random.default_rng(seed)
    cols = {f"f{i}": rng.normal(size=n) for i in range(d)}
    if nans:
        cols["f1"][::7] = np.nan
    y = (np.nan_to_num(cols["f0"]) + np.nan_to_num(cols["f1"]) > 0)
    return DataFrame({**cols, "label": y.astype(np.int64)}), \
        [f"f{i}" for i in range(d)]


def _fit_lr_pipeline(df, feats, max_iter=25):
    return Pipeline().setStages((
        tdata.CleanMissingData().setInputCols(feats),
        tbasic.FastVectorAssembler().setInputCols(feats)
        .setOutputCol("features"),
        P.LogisticRegression(device="cpu").setMaxIter(max_iter),
    )).fit(df)


def _assert_parity(staged, fused, cols, atol=1e-5):
    assert staged.columns == fused.columns
    for c in cols:
        np.testing.assert_allclose(
            _col_matrix(staged, c).astype(np.float64),
            _col_matrix(fused, c).astype(np.float64),
            rtol=1e-4, atol=atol, err_msg=c)
        assert fused.col(c).dtype == staged.col(c).dtype, c
        if c != "features":
            # the fused assembler leaves out the categorical slot ranges
            # (nothing downstream of a transform reads them), as in JAX
            assert fused.metadata(c) == staged.metadata(c), c


def _gbdt(kind, df, feats, policy="depthwise"):
    est = (tstages.LightGBMRegressor(labelCol="target") if kind == "reg"
           else tstages.LightGBMClassifier())
    return Pipeline().setStages((
        tbasic.FastVectorAssembler(inputCols=feats, outputCol="features"),
        est.set(device="cpu", numIterations=10, maxDepth=3,
                growthPolicy=policy),
    )).fit(df)


def _pipelines():
    def lr():
        df, feats = _frame()
        return (_fit_lr_pipeline(df, feats), df,
                ["features", "probability", "prediction"], 1e-5)

    def gbdt_cls():
        df, feats = _frame(n=400, nans=False)
        return (_gbdt("cls", df, feats), df,
                ["rawPrediction", "probability", "prediction"], 1e-4)

    def gbdt_reg():
        df, feats = _frame(n=400, nans=False)
        df = df.withColumn("target", np.asarray(df.col("f0")) * 2.0 + 1.0)
        return _gbdt("reg", df, feats), df, ["prediction"], 1e-4

    def net():
        df, feats = _frame(n=256, nans=True)
        pm = Pipeline().setStages((
            tdata.CleanMissingData().setInputCols(feats),
            tbasic.FastVectorAssembler().setInputCols(feats)
            .setOutputCol("features"),
            TorchLearner(device="cpu", epochs=2, batchSize=64,
                         modelConfig={"type": "mlp", "hidden": [16],
                                      "num_classes": 2}),
        )).fit(df)
        return pm, df, ["scores"], 1e-3

    def naive_bayes():
        df, feats = _frame(n=300, nans=False)
        pm = Pipeline().setStages((
            tbasic.FastVectorAssembler().setInputCols(feats)
            .setOutputCol("features"),
            P.NaiveBayes(device="cpu").setModelType("gaussian"),
        )).fit(df)
        return pm, df, ["probability", "prediction"], 1e-4

    def plumbing():
        df, feats = _frame(nans=False)
        pm = Pipeline().setStages((
            tbasic.FastVectorAssembler().setInputCols(feats)
            .setOutputCol("features"),
            tbasic.SelectColumns().setCols(["features", "label"]),
            P.LinearRegression(device="cpu").setLabelCol("label")
            .setMaxIter(25),
            tbasic.RenameColumn().setInputCol("prediction")
            .setOutputCol("yhat"),
            tbasic.DropColumns().setCols(["label"]),
        )).fit(df)
        return pm, df, ["yhat"], 1e-5

    return {"impute_assemble_lr": lr, "gbdt_classifier": gbdt_cls,
            "gbdt_regressor": gbdt_reg, "torch_learner_model": net,
            "naive_bayes": naive_bayes,
            "linear_regression_with_plumbing": plumbing}


@pytest.mark.parametrize("name", sorted(_pipelines()))
def test_fused_transform_matches_staged(tel, name):
    pm, df, cols, atol = _pipelines()[name]()
    staged = pm.transform(df)
    assert not pm.__dict__.get("_seg_cache")        # default is staged
    fused = pm.setFusePipeline(True).transform(df)
    _assert_parity(staged, fused, cols, atol=atol)
    if name == "linear_regression_with_plumbing":
        assert fused.columns == ["features", "yhat"]
    assert _counter_total("mmlspark_pipeline_fused_dispatches_total") == 1
    assert _counter_total("mmlspark_pipeline_fusion_fallbacks_total") == 0


def test_segment_device_follows_the_stages():
    """Unset, the PipelineModel's device is the first device-naming
    stage's; with none, "cuda" — which raises without a card."""
    df, feats = _frame(n=64)
    fitted = _gbdt("cls", df, feats)
    assert fitted.getDevice() == "cpu"          # the fit's device
    pm = PipelineModel(stages=fitted.getStages())
    assert not pm.isSet("device")
    assert capturelib.segment_device(pm, pm.getStages()).type == "cpu"
    bare = PipelineModel(stages=(
        tbasic.RenameColumn(inputCol="f0", outputCol="g"),
        tbasic.DropColumns(cols=("f2",)))).setFusePipeline(True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bare.transform(df)
    out = bare.setDevice("cpu").transform(df)
    assert out.columns == ["f1", "f3", "label", "g"]
    # the segment computes in float32 and reads back in the input's dtype
    assert out.col("g").dtype == np.float64
    np.testing.assert_array_equal(
        out.col("g"), df.col("f0").astype(np.float32).astype(np.float64))


def test_leafwise_booster_splits_the_segment(tel):
    """A leaf-wise booster does not capture: it runs its staged transform
    between two fused segments, with the staged pipeline's outputs."""
    df, feats = _frame(n=300)
    pm = Pipeline().setStages((
        tdata.CleanMissingData(inputCols=feats),
        tbasic.FastVectorAssembler(inputCols=feats, outputCol="features"),
        tstages.LightGBMClassifier(device="cpu", numIterations=5,
                                   growthPolicy="leafwise", numLeaves=7),
        tbasic.RenameColumn(inputCol="prediction", outputCol="yhat"),
        tbasic.DropColumns(cols=("rawPrediction",)),
    )).fit(df)
    staged = pm.transform(df)
    fused = pm.setFusePipeline(True).transform(df)
    _assert_parity(staged, fused, ["features", "probability", "yhat"])
    snap = telemetry.snapshot()
    assert snap["mmlspark_pipeline_segments"]["series"][0]["value"] == 2
    assert _counter_total("mmlspark_pipeline_fused_dispatches_total") == 2
    assert _counter_total(
        "mmlspark_pipeline_staged_stage_transforms_total") == 1


# ------------------------------------------------- one-program acceptance

def test_three_stage_pipeline_is_one_program(tel):
    df, feats = _frame()
    pm = _fit_lr_pipeline(df, feats).setFusePipeline(True)
    pm.transform(df)
    (entry,) = pm._seg_cache.values()
    pf = entry["pf"]
    assert pf.compiles == 1 and pf.calls == 1
    assert _counter_total("mmlspark_pipeline_fused_dispatches_total") == 1
    snap = telemetry.snapshot()
    assert snap["mmlspark_pipeline_segments"]["series"][0]["value"] == 1
    pm.transform(df)
    assert pf.compiles == 1 and pf.calls == 2       # warm: a replay


def test_transfer_bytes_counted_at_boundaries_only(tel):
    """In: the four feature columns ONCE, narrowed to float32 as the JAX
    package's device_put narrows them (the port casts on the host, so the
    upload moves 4 bytes a value); out: the imputed columns, features,
    probability and prediction, in float32."""
    df, feats = _frame()
    pm = _fit_lr_pipeline(df, feats).setFusePipeline(True)
    pm.transform(df)
    snap = telemetry.snapshot()
    series = {s["labels"]["direction"]: s["value"] for s in
              snap["mmlspark_pipeline_transfer_bytes_total"]["series"]}
    n = len(df)
    assert series["in"] == n * 4 * 4
    assert series["out"] == (n * 4 * 4) + (n * 4 * 4) + (n * 2 * 4) + n * 4


def test_new_row_count_is_a_counted_capture(tel):
    df, feats = _frame(n=200)
    df2, _ = _frame(n=77)
    pm = _fit_lr_pipeline(df, feats).setFusePipeline(True)
    pm.transform(df)
    pm.transform(df2)
    (entry,) = pm._seg_cache.values()
    assert entry["pf"].compiles == 2
    assert entry["pf"].causes.get("shape_change") == 1


def test_new_weights_recapture(tel):
    """Params key by identity: new weights make a new program."""
    df, feats = _frame()
    pm = _fit_lr_pipeline(df, feats).setFusePipeline(True)
    before = pm.transform(df)
    lr = pm.getStages()[-1]
    lr.setCoefficients(-np.asarray(lr.getCoefficients()))
    after = pm.transform(df)
    assert len({id(e["pf"]) for e in pm._seg_cache.values()}) == 1
    assert not np.array_equal(_col_matrix(before, "probability"),
                              _col_matrix(after, "probability"))
    np.testing.assert_allclose(_col_matrix(after, "probability"),
                               _col_matrix(lr.transform(
                                   pm.getStages()[1].transform(
                                       pm.getStages()[0].transform(df))),
                                   "probability"), atol=1e-6)


# ---------------------------------------------------- segment splitting

def _udf_stage(in_col="f0", out_col="g0"):
    return (tbasic.UDFTransformer().setInputCol(in_col).setOutputCol(out_col)
            .setUdf(lambda v: float(v) * 2.0).setVectorized(False))


def _split_pipeline(df, feats, where):
    stages = [tdata.CleanMissingData().setInputCols(feats),
              tbasic.FastVectorAssembler().setInputCols(feats)
              .setOutputCol("features"),
              P.LogisticRegression(device="cpu").setMaxIter(15)]
    udf = _udf_stage()
    if where == "prefix":
        stages = [udf] + stages
    elif where == "middle":
        stages = stages[:1] + [udf] + stages[1:]
    elif where == "suffix":
        stages = stages + [udf]
    return Pipeline().setStages(tuple(stages)).fit(df)


@pytest.mark.parametrize("where", ["none", "prefix", "suffix", "middle"])
def test_split_positions_keep_parity(tel, where):
    df, feats = _frame()
    pm = _split_pipeline(df, feats, where)
    staged = pm.transform(df)
    fused = pm.setFusePipeline(True).transform(df)
    _assert_parity(staged, fused, ["features", "probability", "prediction"]
                   + (["g0"] if where != "none" else []))
    snap = telemetry.snapshot()
    assert snap["mmlspark_pipeline_segments"]["series"][0]["value"] == 1
    # the middle split leaves CleanMissingData a segment of one: staged,
    # with the UDF; elsewhere only the UDF stages
    assert _counter_total(
        "mmlspark_pipeline_staged_stage_transforms_total") == \
        {"none": 0, "prefix": 1, "suffix": 1, "middle": 2}[where]
    assert _counter_total("mmlspark_pipeline_fused_dispatches_total") == 1


class _RowSum(Transformer):
    """Test stage: per-row sum of the features column. Capturable on
    paper — the fallback test feeds it RAGGED rows the encoder rejects."""

    def transform(self, df):
        out = np.array([float(np.asarray(v).sum())
                        for v in df.col("features")])
        return df.withColumn("s", out)

    def capture(self, columns):
        if "features" not in columns:
            return None
        return StageCapture(lambda p, xs: (xs[0].sum(dim=1),),
                            inputs=("features",), outputs=("s",),
                            host_cast={"s": np.float64})


def test_ragged_rows_fall_back_staged(tel):
    rows = [np.ones(3, np.float32), np.ones(4, np.float32)] * 10
    df = DataFrame({"features": object_column(rows),
                    "flat": np.arange(20).astype(np.float64)})
    pm = PipelineModel(device="cpu").setStages((
        _RowSum(), tbasic.RenameColumn().setInputCol("s")
        .setOutputCol("rowsum"))).setFusePipeline(True)
    out = pm.transform(df)
    assert _counter_total("mmlspark_pipeline_fusion_fallbacks_total") == 1
    assert _counter_total("mmlspark_pipeline_fused_dispatches_total") == 0
    np.testing.assert_allclose(out.col("rowsum"),
                               [float(np.asarray(r).sum()) for r in rows])


# --------------------------------------------------- serving composites

_D = 6


def _serving_pipeline(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(240, _D)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    df = DataFrame({"features": object_column(list(x)), "label": y})
    pm = Pipeline().setStages((
        tbasic.FastVectorAssembler().setInputCols(["features"])
        .setOutputCol("assembled"),
        P.LogisticRegression(device="cpu").setFeaturesCol("assembled")
        .setMaxIter(20),
    )).fit(df)
    return pm, x


def _step(pm, max_batch=32):
    return FusedServingStep.from_pipeline(
        pm, input_col="features", row_shape=(_D,), in_dtype=np.float32,
        policy=BucketPolicy(max_batch=max_batch, min_bucket=8),
        device="cpu")


def _payloads(x):
    return [base64.b64encode(np.ascontiguousarray(r).tobytes()).decode()
            for r in x]


def _staged_labels(pm, x):
    out = pm.transform(DataFrame({"features": object_column(list(x))}))
    return out.col("prediction").astype(int).tolist()


def test_composite_matches_staged_pipeline():
    pm, x = _serving_pipeline()
    step = _step(pm)
    assert step.score_col == "probability" and step.bundle_kind == "pipeline"
    got = [json.loads(r)["label"] for r in step(_payloads(x[:9]))]
    assert got == _staged_labels(pm, x[:9])
    for b in step.policy.buckets:       # every bucket: replay == eager
        rows = x[:b]
        np.testing.assert_array_equal(
            step.score_rows(rows, b),
            step.forward(torch.from_numpy(rows)).numpy())


def test_uncapturable_stage_raises():
    pm, _ = _serving_pipeline()
    bad = PipelineModel().setStages(
        tuple(pm.getStages()) + (_udf_stage("prediction", "z"),))
    with pytest.raises(ValueError, match="not capturable"):
        _step(bad)


def test_bundle_round_trip_zero_compiles(tel, tmp_path):
    pm, x = _serving_pipeline()
    step = _step(pm)
    step.compile_buckets()
    want = step(_payloads(x[:5]))
    save_bundle(str(tmp_path), step)
    loaded = load_bundle(str(tmp_path), device="cpu")
    assert loaded.bundle_kind == "pipeline"
    assert loaded.warm_buckets() == step.policy.buckets
    assert loaded.compiles() == 0
    assert loaded(_payloads(x[:5])) == want
    assert loaded.compiles() == 0
    snap = telemetry.snapshot()
    series = snap["mmlspark_serving_bundle_loads_total"]["series"]
    assert {s["labels"]["result"] for s in series} == {"warm"}


def test_torn_capture_record_degrades_one_bucket(tel, tmp_path):
    pm, _ = _serving_pipeline()
    save_bundle(str(tmp_path), _step(pm))
    shard = tmp_path / "bundle_exec_b16.bin"
    shard.write_bytes(shard.read_bytes()[:-5])
    loaded = load_bundle(str(tmp_path), device="cpu")
    assert loaded.warm_buckets() == [8, 32]
    assert _counter_total("mmlspark_serving_bundle_exec_failures_total") == 1
    out = loaded.score_rows(np.zeros((12, _D), np.float32), 16)
    assert out.shape == (12,)
    assert loaded.compiles() == 1


def test_torn_pipeline_shard_is_fatal(tel, tmp_path):
    pm, _ = _serving_pipeline()
    save_bundle(str(tmp_path), _step(pm))
    blob = (tmp_path / "bundle_pipeline.bin").read_bytes()
    (tmp_path / "bundle_pipeline.bin").write_bytes(blob[:-3])
    with pytest.raises(CorruptCheckpoint):
        load_bundle(str(tmp_path), device="cpu")


def test_continuous_engine_serves_pipeline_step(tel):
    import urllib.request
    pm, x = _serving_pipeline()
    step = _step(pm)
    source, loop = serve_continuous(step, max_wait=0.005)
    try:
        req = urllib.request.Request(source.url,
                                     data=_payloads(x[:1])[0].encode())
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            body = r.read().decode()
        assert body == '{"label": %d}' % _staged_labels(pm, x[:1])[0]
    finally:
        loop.stop()
        source.close()
