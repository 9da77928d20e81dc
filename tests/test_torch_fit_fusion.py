"""Fit-side pipeline fusion in the port (``Pipeline.fusePipeline`` on the fit
path, ``core/capture.py``'s FitCapturePlan) against the staged fit and the
JAX package.

* TorchLearner: the fused fit (raw wire-dtype columns up, featurized on the
  device ahead of each step) gives the staged fit's parameters bit for bit
  on the scan, feed, feed-with-prefetch and stream paths, with one capture
  per fused program and fewer uploaded bytes than the staged fit;
* LightGBM, both growth policies, classifier and regressor: the fused
  featurize -> bin fit grows the staged fit's booster state bit for bit,
  and the JAX package's fused fit's trees (split features and thresholds
  equal, leaves within 1e-5, the tolerance of the port's GBDT parity
  tests);
* a kill-and-resume of a fused fit is bit-exact, and a checkpoint written
  under another featurize plan is skipped (the resumed fit equals a fresh
  one);
* ``FitCapturePlan.digest()`` equals the JAX package's hex for the same
  plans, so a checkpoint directory resumes in either package;
* staged fallbacks: an uncapturable prefix, an estimator without the hook,
  an elastic booster — each counted.
"""

import hashlib

import numpy as np
import pytest

from mmlspark_tpu import DataFrame as JaxDataFrame
from mmlspark_tpu import Pipeline as JaxPipeline
from mmlspark_tpu.core.capture import compose_fit_capture as jax_compose
from mmlspark_tpu.models.gbdt import stages as jstages
from mmlspark_tpu.stages import basic as jbasic
from mmlspark_tpu.stages import data_stages as jdata
from mmlspark_tpu_torch import DataFrame, telemetry
from mmlspark_tpu_torch.core import capture as capturelib
from mmlspark_tpu_torch.core.capture import compose_fit_capture
from mmlspark_tpu_torch.core.pipeline import Pipeline
from mmlspark_tpu_torch.models import trainer as trainerlib
from mmlspark_tpu_torch.models.classical import LogisticRegression
from mmlspark_tpu_torch.models.gbdt import stages as tstages
from mmlspark_tpu_torch.models.trainer import TorchLearner
from mmlspark_tpu_torch.stages import basic as tbasic
from mmlspark_tpu_torch.stages import data_stages as tdata


@pytest.fixture
def tel():
    telemetry.registry.reset()
    telemetry.enable()
    yield telemetry
    telemetry.disable()


def _raw_cols(n=256, seed=0, reg=False):
    """Wire-dtype raw columns: the shapes the fused fit ships instead of
    the float32-widened feature matrix."""
    rng = np.random.default_rng(seed)
    return {"a": rng.integers(-5, 6, size=n).astype(np.int8),
            "b": rng.integers(0, 7, size=(n, 3)).astype(np.int16),
            "label": (rng.normal(size=n).astype(np.float32) if reg
                      else rng.integers(0, 2, size=n).astype(np.int32))}


def _raw_frame(n=256, seed=0, reg=False):
    return DataFrame(_raw_cols(n, seed, reg))


def _asm(cols=("a", "b")):
    return tbasic.FastVectorAssembler(inputCols=cols, outputCol="features")


def _learner(**kw):
    base = dict(modelConfig={"type": "mlp", "hidden": [8],
                             "num_classes": 2},
                epochs=3, batchSize=64, seed=7, learningRate=0.1,
                shuffle=True, device="cpu")
    base.update(kw)
    return TorchLearner(**base)


def _pipeline(df, fuse, lr=None, asm=None):
    return Pipeline(stages=(asm or _asm(), lr or _learner()),
                    fusePipeline=fuse).fit(df)


def _digest(model):
    h = hashlib.sha256()
    params = model.getModelParams()
    for k in sorted(params):
        h.update(params[k].numpy().tobytes())
    return h.hexdigest()


def _last(pm):
    return pm.getStages()[-1]


# ----------------------------------------------------------- trainer parity

@pytest.mark.parametrize("kw", [
    pytest.param(dict(epochs=1), id="scan_1_epoch"),
    pytest.param(dict(), id="scan_3_epochs"),
    pytest.param(dict(stepsPerDispatch=1), id="scan_one_step_windows"),
    pytest.param(dict(deviceDataCap=1, prefetchDepth=0), id="feed"),
    pytest.param(dict(deviceDataCap=1, prefetchDepth=2),
                 id="feed_prefetch"),
])
def test_trainer_fused_fit_matches_staged(tel, kw):
    df = _raw_frame()
    staged = _pipeline(df, False, _learner(**kw))
    lr = _learner(**kw)
    fused = _pipeline(df, True, lr)
    assert fused.getFusePipeline() and fused.getDevice() == "cpu"
    assert _digest(_last(staged)) == _digest(_last(fused))
    path = "feed" if "deviceDataCap" in kw else "scan"
    assert _last(fused)._fit_stats["path"] == path
    steps = _last(fused)._fit_stats["steps_per_epoch"]
    assert capturelib._m_fit_fused.value == steps * lr.getEpochs()
    assert capturelib._m_fit_fallbacks.value == 0
    # ONE capture per fused program, flat across every epoch
    (pf,) = lr._fused_programs.values()
    assert pf.compiles == 1, pf.causes
    assert pf.calls == steps * lr.getEpochs()


def test_trainer_fused_fit_uploads_fewer_bytes(tel):
    """Raw int8/int16 rows go up instead of the float32 matrix, on both
    the trainer's counter and the fit-phase pipeline counter."""
    df = _raw_frame(n=512)
    b0 = trainerlib._m_transfer_bytes.value
    _pipeline(df, False)
    staged_b = trainerlib._m_transfer_bytes.value - b0
    b1 = trainerlib._m_transfer_bytes.value
    _pipeline(df, True)
    fused_b = trainerlib._m_transfer_bytes.value - b1
    fit_in = capturelib._m_transfer.labels(direction="in",
                                           phase="fit").value
    # the dataset is under the reshuffle cap: one upload per epoch, three
    # epochs, of an int8 + 3 int16 + the int32 label per row, against 4
    # float32 + the int32 label
    assert staged_b == 3 * 512 * (4 * 4 + 4)
    assert fused_b == fit_in == 3 * 512 * (1 + 3 * 2 + 4)


def test_trainer_fused_stream_matches_fit_stream(tel):
    raws = [_raw_frame(n=64 - 5 * (s == 3), seed=s) for s in range(4)]
    asm = _asm()

    def staged_batches():
        for b in raws:
            out = asm.transform(b)
            yield (np.stack(list(out.col("features"))), out.col("label"))

    staged = _learner().fitStream(staged_batches)
    plan = compose_fit_capture([asm], raws[0], "features", "label")
    assert plan is not None and plan.in_names == ["a", "b", "label"]
    lr = _learner()
    fused = lr.fitStreamCaptured(lambda: iter(raws), plan)
    assert _digest(staged) == _digest(fused)
    assert fused._fit_stats["path"] == "stream"
    assert capturelib._m_fit_fused.value == 4 * 3
    # the ragged last batch (59 rows) pads to the same 64-row bucket
    (pf,) = lr._fused_programs.values()
    assert pf.compiles == 1
    # tuples of raw arrays in plan order train the same
    tuples = [tuple(b.col(c) for c in plan.in_names) for b in raws]
    again = _learner().fitStreamCaptured(lambda: iter(tuples), plan)
    assert _digest(again) == _digest(fused)


def test_fit_stream_captured_refuses_a_misaligned_batch():
    df = _raw_frame(n=32)
    plan = compose_fit_capture([_asm()], df, "features", "label")
    with pytest.raises(ValueError, match="capture plan needs 3"):
        _learner().fitStreamCaptured(
            lambda: iter([(df.col("a"), df.col("label"))]), plan)


# -------------------------------------------------------------- GBDT parity

def _booster(reg, policy, est_mod=tstages, **kw):
    cls = est_mod.LightGBMRegressor if reg else est_mod.LightGBMClassifier
    return cls(numIterations=6, numLeaves=8, learningRate=0.2,
               growthPolicy=policy, **kw)


@pytest.mark.parametrize("reg", [False, True], ids=["classifier",
                                                    "regressor"])
@pytest.mark.parametrize("policy", ["leafwise", "depthwise"])
def test_gbdt_fused_fit_matches_staged_and_jax(tel, policy, reg):
    cols = _raw_cols(n=512, seed=1, reg=reg)
    cols["c"] = np.random.default_rng(5).normal(size=512)
    cols["c"][::9] = np.nan          # float64 with gaps, imputed on device
    df = DataFrame(dict(cols))

    def stages(mod_data, mod_basic, est):
        return (mod_data.CleanMissingData(inputCols=("c",)),
                mod_basic.FastVectorAssembler(inputCols=("a", "b", "c"),
                                              outputCol="features"), est)

    staged = Pipeline(stages=stages(tdata, tbasic, _booster(
        reg, policy, device="cpu"))).fit(df)
    fused = Pipeline(stages=stages(tdata, tbasic, _booster(
        reg, policy, device="cpu")), fusePipeline=True).fit(df)
    assert capturelib._m_fit_fused.value == 1            # one slab
    assert capturelib._m_fit_fallbacks.value == 0
    s0, s1 = (_last(staged).getBoosterState(),
              _last(fused).getBoosterState())
    assert set(s0) == set(s1)
    for k in s0:
        np.testing.assert_array_equal(np.asarray(s0[k]),
                                      np.asarray(s1[k]), err_msg=k)
    jdf = JaxDataFrame({k: v.copy() for k, v in cols.items()})
    jfused = JaxPipeline().setStages(stages(jdata, jbasic, _booster(
        reg, policy, jstages))).setFusePipeline(True).fit(jdf)
    js = _last(jfused).getBoosterState()
    assert s1.get("kind") == js.get("kind")
    for k in s1:
        if k == "leaf":
            np.testing.assert_allclose(s1[k], np.asarray(js[k]), atol=1e-5)
        else:
            np.testing.assert_array_equal(np.asarray(s1[k]),
                                          np.asarray(js[k]), err_msg=k)
    # and the fused pipeline's transform scores as the staged one does
    out_s, out_f = staged.transform(df), fused.transform(df)
    col = "prediction"
    np.testing.assert_allclose(out_f.col(col), out_s.col(col), atol=1e-5)


def test_gbdt_fused_fit_declines(tel):
    df = _raw_frame(n=128)
    plan = compose_fit_capture([_asm()], df, "features", "label")
    est = tstages.LightGBMClassifier(
        device="cpu", numIterations=2,
        elasticConfig={"checkpointDir": "unused", "minHosts": 1})
    assert est._fit_captured(df, plan) is None
    narrow = tstages.LightGBMClassifier(device="cpu", maxDenseFeatures=3)
    assert narrow._fit_captured(df, plan) is None        # 4 features > 3


# ---------------------------------------------------------- resume + digest

def test_fused_resume_bit_exact(tel, tmp_path):
    ck = str(tmp_path / "ck")
    df = _raw_frame()
    uninterrupted = _pipeline(df, True, _learner(epochs=3))
    # "killed" after epoch 2; a fresh learner resumes epoch 3
    _pipeline(df, True, _learner(epochs=2, checkpointDir=ck))
    from mmlspark_tpu_torch.resilience import ckpt as ckptlib
    manifest = ckptlib.load_manifest(ck)
    plan = compose_fit_capture([_asm()], df, "features", "label")
    assert manifest["ckpt_00001.msgpack"]["featurize_digest"] == \
        plan.digest()
    lr = _learner(epochs=3, checkpointDir=ck)
    resumed = _pipeline(df, True, lr)
    assert _digest(_last(uninterrupted)) == _digest(_last(resumed))
    (pf,) = lr._fused_programs.values()
    assert pf.compiles == 1


def test_resume_skips_a_foreign_featurize_digest(tel, tmp_path):
    """A checkpoint written under a DIFFERENT featurize plan is skipped:
    the fit starts fresh and equals an uncheckpointed fit."""
    ck = str(tmp_path / "ck")
    df = _raw_frame()
    _pipeline(df, True, _learner(epochs=2, checkpointDir=ck),
              asm=_asm(("b", "a")))
    fresh = _pipeline(df, True, _learner(epochs=3))
    skipped = _pipeline(df, True, _learner(epochs=3, checkpointDir=ck))
    assert _digest(_last(fresh)) == _digest(_last(skipped))


def _plan_pair(kind):
    """The same featurize prefix built in both packages."""
    n = 64
    rng = np.random.default_rng(11)
    cols = {"x": rng.normal(size=n), "y": rng.normal(size=n),
            "k": rng.integers(0, 5, n).astype(np.int64),
            "label": rng.integers(0, 2, n).astype(np.int64)}
    cols["x"][::5] = np.nan
    out = []
    for data, basic, frame in ((tdata, tbasic, DataFrame),
                               (jdata, jbasic, JaxDataFrame)):
        df = frame({k: v.copy() for k, v in cols.items()})
        asm = basic.FastVectorAssembler(inputCols=("x", "y", "k"),
                                        outputCol="features")
        stages = {"assemble": [asm],
                  "impute_assemble": [data.CleanMissingData(
                      inputCols=("x", "y")), asm],
                  "convert_impute_assemble": [
                      data.DataConversion(cols=("k",), convertTo="float"),
                      data.CleanMissingData(inputCols=("x",),
                                            cleaningMode="Median"), asm],
                  }[kind]
        compose = compose_fit_capture if frame is DataFrame \
            else jax_compose
        out.append(compose(stages, df, "features", "label"))
    return out


@pytest.mark.parametrize("kind", ["assemble", "impute_assemble",
                                  "convert_impute_assemble"])
def test_plan_digest_matches_jax(kind):
    port, jax_plan = _plan_pair(kind)
    assert port.in_names == jax_plan.in_names
    assert port.digest() == jax_plan.digest()


# ---------------------------------------------------------------- fallbacks

def test_uncapturable_prefix_falls_back_staged(tel):
    df = _raw_frame()
    udf = tbasic.UDFTransformer(inputCol="a", outputCol="a",
                                udf=lambda v: np.asarray(v) * 1,
                                vectorized=True)
    pm = Pipeline(stages=(udf, _asm(), _learner()),
                  fusePipeline=True).fit(df)
    assert capturelib._m_fit_fallbacks.value == 1
    assert capturelib._m_fit_fused.value == 0
    staged = Pipeline(stages=(udf, _asm(), _learner())).fit(df)
    assert _digest(_last(pm)) == _digest(_last(staged))


def test_estimator_without_hook_falls_back(tel):
    df = _raw_frame()
    pm = Pipeline(stages=(_asm(), LogisticRegression(device="cpu",
                                                     maxIter=5)),
                  fusePipeline=True).fit(df)
    assert capturelib._m_fit_fallbacks.value == 1
    assert _last(pm).getCoefficients() is not None


def test_token_learner_declines_the_fused_fit(tel):
    cfg = {"type": "transformer", "vocab_size": 50, "d_model": 16,
           "heads": 2, "layers": 1, "num_classes": 2, "max_len": 8}
    df = DataFrame({"t": np.ones((16, 8), np.int64),
                    "label": np.zeros(16, np.int64)})
    lr = TorchLearner(modelConfig=cfg, device="cpu", epochs=1,
                      batchSize=8)
    plan = compose_fit_capture([_asm(("t",))], df, "features", "label")
    assert lr._fit_captured(df, plan) is None
