"""Registry-driven stage fuzzing of the port, with its coverage gate.

The port's counterpart of tests/test_fuzzing.py:312-330 (the reference's
FuzzingTest.scala:25-130): every concrete non-Model stage in the port's
registry (``core.pipeline.registered_stages()``, slices 1-11) registers a
TestObject factory below (the HTTP client stages of slice 13 included),
and each runs the experiment fuzz (fit/transform
execute) and the serialization fuzz (save/load of the stage and of its
fitted model, outputs equal within rtol 1e-4 / atol 1e-5) over the port's
``save_stage``/``load_stage``. Models are exercised through their
estimators. Every stage with a ``device`` Param runs with ``device="cpu"``.
The gate fails if a registered non-Model stage of the port has no factory.
"""

import numpy as np
import pytest

from mmlspark_tpu_torch import DataFrame, Pipeline
from mmlspark_tpu_torch.automl import (featurize, model_statistics,
                                       train_classifier, tune,
                                       value_indexer)
from mmlspark_tpu_torch.core import serialize
from mmlspark_tpu_torch.core.pipeline import Model, registered_stages
from mmlspark_tpu_torch.core.schema import (CategoricalUtilities,
                                            make_image_row)
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.io.http import (CustomInputParser, CustomOutputParser,
                                        HTTPTransformer, JSONInputParser,
                                        JSONOutputParser,
                                        SimpleHTTPTransformer,
                                        StringOutputParser)
from mmlspark_tpu_torch.models import classical, trainer
from mmlspark_tpu_torch.models.gbdt import stages as gbdt
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.modules import sized_for
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.models.trainer import TorchLearner
from mmlspark_tpu_torch.ops.image_stages import (ImageSetAugmenter,
                                                 ImageTransformer,
                                                 UnrollImage)
from mmlspark_tpu_torch.ops.text_stages import TextFeaturizer
from mmlspark_tpu_torch.ops.word2vec import Word2Vec
from mmlspark_tpu_torch.stages import (Cacher, CheckpointData, ClassBalancer,
                                       CleanMissingData, DataConversion,
                                       DropColumns, EnsembleByKey,
                                       FastVectorAssembler, FlattenBatch,
                                       MiniBatchTransformer,
                                       MultiColumnAdapter, PartitionSample,
                                       Profiler, RenameColumn, Repartition,
                                       SelectColumns, SummarizeData,
                                       TextPreprocessor, Timer,
                                       UDFTransformer)
from mmlspark_tpu_torch.testing.fuzzing import (FUZZING_REGISTRY, TestObject,
                                                experiment_fuzz,
                                                register_fuzzing,
                                                serialization_fuzz)

serialize._ensure_registry_populated()

# ---------------------------------------------------------------- fixtures

_rng = np.random.default_rng(0)
_N = 48


def _tab_df():
    y = _rng.integers(0, 2, _N)
    xm = _rng.normal(size=(_N, 4)) + y[:, None]
    return DataFrame({
        "a": _rng.normal(size=_N),
        "b": _rng.normal(size=_N) + y,
        "cat": np.array(["u", "v"], dtype=object)[_rng.integers(0, 2, _N)],
        "text": np.array([f"w{i} common tok{i % 3}" for i in range(_N)],
                         dtype=object),
        "features": object_column([r.astype(np.float32) for r in xm]),
        "label": y.astype(np.int64),
        "rlabel": (xm[:, 0] * 2 + _rng.normal(size=_N) * 0.1),
    })


def _img_df(n=3):
    rows = object_column([
        make_image_row(f"i{i}", 8, 8, 3,
                       _rng.integers(0, 255, (8, 8, 3), dtype=np.uint8))
        for i in range(n)])
    return DataFrame({"image": rows, "label": np.arange(n, dtype=np.int64)})


TAB = _tab_df()
IMG = _img_df()
CPU = {"device": "cpu"}


def _double(v):  # module-level so the UDF pickles by reference
    return float(v) * 2


# ------------------------------------------------------- TestObject factories

def _t(cls, factory):
    register_fuzzing(cls)(factory)


_t(Pipeline, lambda: TestObject(
    Pipeline().setStages((CleanMissingData().setInputCols(("a",)),
                          RenameColumn().setInputCol("b").setOutputCol("b2"))),
    TAB))
_t(ImageTransformer, lambda: TestObject(
    ImageTransformer(**CPU).setInputCol("image").setOutputCol("o")
    .resize(4, 4), IMG))
_t(UnrollImage, lambda: TestObject(
    UnrollImage().setInputCol("image").setOutputCol("o"), IMG))
_t(ImageSetAugmenter, lambda: TestObject(
    ImageSetAugmenter(**CPU).setInputCol("image").setOutputCol("image"),
    IMG))
_t(TextFeaturizer, lambda: TestObject(
    TextFeaturizer().setInputCol("text").setNumFeatures(32), TAB))
_t(Word2Vec, lambda: TestObject(
    Word2Vec(**CPU).setInputCol("text").setVectorSize(8).setMinCount(1)
    .setBatchSize(64), TAB))


def _torch_model():
    cfg = sized_for({"type": "mlp", "hidden": [4], "num_classes": 2}, (1, 4))
    return TestObject(TorchModel(**CPU).setModelConfig(cfg)
                      .setModelParams(trainer.init_params(cfg, 0))
                      .setInputCol("features"), TAB)


def _image_featurizer():
    cfg = {"type": "convnet", "channels": [4], "dense": 8,
           "num_classes": 2, "height": 8, "width": 8, "channels_in": 3}
    return TestObject(
        ImageFeaturizer(**CPU).setInputCol("image").setOutputCol("feats")
        .setModel(TorchModel().setModelConfig(cfg)
                  .setModelParams(trainer.init_params(cfg, 0))), IMG)


_t(TorchModel, _torch_model)
_t(ImageFeaturizer, _image_featurizer)
_t(TorchLearner, lambda: TestObject(
    TorchLearner(**CPU).setModelConfig({"type": "mlp", "hidden": [4],
                                        "num_classes": 2})
    .setEpochs(1).setBatchSize(16), TAB))
_t(gbdt.LightGBMClassifier, lambda: TestObject(
    gbdt.LightGBMClassifier(**CPU).setNumIterations(3).setMaxBin(15), TAB))
_t(gbdt.LightGBMRegressor, lambda: TestObject(
    gbdt.LightGBMRegressor(**CPU).setLabelCol("rlabel").setNumIterations(3)
    .setMaxBin(15), TAB))
_t(classical.LogisticRegression, lambda: TestObject(
    classical.LogisticRegression(**CPU).setMaxIter(10), TAB))
_t(classical.LinearRegression, lambda: TestObject(
    classical.LinearRegression(**CPU).setLabelCol("rlabel").setMaxIter(10),
    TAB))
_t(classical.NaiveBayes, lambda: TestObject(
    classical.NaiveBayes(**CPU).setModelType("gaussian"), TAB))
_t(classical.DecisionTreeClassifier, lambda: TestObject(
    classical.DecisionTreeClassifier(**CPU).setMaxBin(15), TAB))
_t(classical.DecisionTreeRegressor, lambda: TestObject(
    classical.DecisionTreeRegressor(**CPU).setLabelCol("rlabel")
    .setMaxBin(15), TAB))
_t(classical.RandomForestClassifier, lambda: TestObject(
    classical.RandomForestClassifier(**CPU).setNumIterations(3)
    .setMaxBin(15), TAB))
_t(classical.RandomForestRegressor, lambda: TestObject(
    classical.RandomForestRegressor(**CPU).setLabelCol("rlabel")
    .setNumIterations(3).setMaxBin(15), TAB))
_t(classical.GBTClassifier, lambda: TestObject(
    classical.GBTClassifier(**CPU).setNumIterations(3).setMaxBin(15), TAB))
_t(classical.GBTRegressor, lambda: TestObject(
    classical.GBTRegressor(**CPU).setLabelCol("rlabel").setNumIterations(3)
    .setMaxBin(15), TAB))
_t(classical.MultilayerPerceptronClassifier, lambda: TestObject(
    classical.MultilayerPerceptronClassifier(**CPU).setMaxIter(2)
    .setLayers((4,)), TAB))
_t(value_indexer.ValueIndexer, lambda: TestObject(
    value_indexer.ValueIndexer().setInputCol("cat").setOutputCol("ci"),
    TAB))


def _index_to_value():
    df = TAB.withColumn("ci", TAB.col("label").astype(np.float64))
    df = CategoricalUtilities.setLevels(df, "ci", ["n", "y"])
    return TestObject(value_indexer.IndexToValue().setInputCol("ci")
                      .setOutputCol("cv"), df)


_t(value_indexer.IndexToValue, _index_to_value)
_t(featurize.Featurize, lambda: TestObject(
    featurize.Featurize().setOutputCol("f")
    .setInputCols(("a", "b", "cat")).setNumberOfFeatures(16), TAB))
_t(train_classifier.TrainClassifier, lambda: TestObject(
    train_classifier.TrainClassifier().setLabelCol("label")
    .setModel(classical.LogisticRegression(**CPU).setMaxIter(5)),
    TAB.select("a", "b", "cat", "label")))
_t(train_classifier.TrainRegressor, lambda: TestObject(
    train_classifier.TrainRegressor().setLabelCol("rlabel")
    .setModel(classical.LinearRegression(**CPU).setMaxIter(5)),
    TAB.select("a", "b", "rlabel")))


def _stats_df():
    return DataFrame({"label": TAB.col("label").astype(np.float64),
                      "prediction": TAB.col("label").astype(np.float64)})


_t(model_statistics.ComputeModelStatistics, lambda: TestObject(
    model_statistics.ComputeModelStatistics().setLabelCol("label")
    .setScoredLabelsCol("prediction").setEvaluationMetric("classification"),
    _stats_df()))
_t(model_statistics.ComputePerInstanceStatistics, lambda: TestObject(
    model_statistics.ComputePerInstanceStatistics().setLabelCol("label")
    .setScoresCol("prediction"), _stats_df()))
_t(tune.TuneHyperparameters, lambda: TestObject(
    tune.TuneHyperparameters().setModels(
        (classical.NaiveBayes(**CPU).setModelType("gaussian"),))
    .setEvaluationMetric("accuracy").setNumFolds(2).setNumRuns(1)
    .setParallelism(1), TAB.select("features", "label")))


def _find_best():
    df = TAB.select("features", "label")
    m1 = classical.NaiveBayes(**CPU).setModelType("gaussian").fit(df)
    return TestObject(tune.FindBestModel().setModels((m1,))
                      .setEvaluationMetric("accuracy"), df)


_t(tune.FindBestModel, _find_best)
_t(Cacher, lambda: TestObject(Cacher(), TAB))
_t(CheckpointData, lambda: TestObject(CheckpointData(), TAB))
_t(DropColumns, lambda: TestObject(DropColumns().setCols(("a",)), TAB))
_t(SelectColumns, lambda: TestObject(SelectColumns().setCols(("a", "b")), TAB))
_t(RenameColumn, lambda: TestObject(
    RenameColumn().setInputCol("a").setOutputCol("a2"), TAB))
_t(Repartition, lambda: TestObject(Repartition().setN(3), TAB))
_t(UDFTransformer, lambda: TestObject(
    UDFTransformer().setInputCol("a").setOutputCol("a2").setUdf(_double), TAB))
_t(ClassBalancer, lambda: TestObject(
    ClassBalancer().setInputCol("label").setOutputCol("w"), TAB))
_t(MultiColumnAdapter, lambda: TestObject(
    MultiColumnAdapter().setBaseStage(
        RenameColumn()).setInputCols(("a",)).setOutputCols(("a9",)), TAB))
_t(Timer, lambda: TestObject(
    Timer().setStage(DropColumns().setCols(("a",))).setLogToConsole(False),
    TAB))
_t(Profiler, lambda: TestObject(
    Profiler().setStage(DropColumns().setCols(("a",))), TAB))
_t(FastVectorAssembler, lambda: TestObject(
    FastVectorAssembler().setInputCols(("a", "b", "features"))
    .setOutputCol("fv"), TAB))
_t(CleanMissingData, lambda: TestObject(
    CleanMissingData().setInputCols(("a",)).setCleaningMode("Median"), TAB))
_t(DataConversion, lambda: TestObject(
    DataConversion().setCols(("label",)).setConvertTo("double"), TAB))
_t(PartitionSample, lambda: TestObject(
    PartitionSample().setMode("RandomSample").setPercent(0.5), TAB))
_t(SummarizeData, lambda: TestObject(SummarizeData(), TAB.select("a", "b")))
_t(EnsembleByKey, lambda: TestObject(
    EnsembleByKey().setKeys(("cat",)).setCols(("a",)), TAB))
_t(TextPreprocessor, lambda: TestObject(
    TextPreprocessor().setInputCol("text").setOutputCol("t2")
    .setMap({"common": "rare"}), TAB))
_t(MiniBatchTransformer, lambda: TestObject(
    MiniBatchTransformer().setBatchSize(8), TAB.select("a", "label")))


def _flatten():
    batched = MiniBatchTransformer().setBatchSize(8).transform(
        TAB.select("a", "label"))
    return TestObject(FlattenBatch(), batched)


_t(FlattenBatch, _flatten)


# the HTTP client stages (slice 13). The JAX package exempts the two
# clients from fuzzing; here they run against a closed local port, where
# every row fails the same way (statusCode 0 and the connection error)
_REQ = DataFrame({"data": object_column([{"x": 1}, {"x": 2}])})
_RESP = DataFrame({"resp": object_column(
    [{"statusCode": 200, "body": '{"y": 2}'}])})
_CLOSED = "http://127.0.0.1:9/x"


def _ident(v):  # module-level so the UDF pickles by reference
    return v


_t(JSONInputParser, lambda: TestObject(
    JSONInputParser().setInputCol("data").setOutputCol("req")
    .setUrl(_CLOSED), _REQ))
_t(JSONOutputParser, lambda: TestObject(
    JSONOutputParser().setInputCol("resp").setOutputCol("out"), _RESP))
_t(StringOutputParser, lambda: TestObject(
    StringOutputParser().setInputCol("resp").setOutputCol("out"), _RESP))
_t(CustomInputParser, lambda: TestObject(
    CustomInputParser().setInputCol("data").setOutputCol("req")
    .setUdf(_ident), _REQ))
_t(CustomOutputParser, lambda: TestObject(
    CustomOutputParser().setInputCol("resp").setOutputCol("out")
    .setUdf(_ident), _RESP))
_t(HTTPTransformer, lambda: TestObject(
    HTTPTransformer().setInputCol("req").setOutputCol("resp")
    .setTimeout(2.0), JSONInputParser().setInputCol("data")
    .setOutputCol("req").setUrl(_CLOSED).transform(_REQ)))
_t(SimpleHTTPTransformer, lambda: TestObject(
    SimpleHTTPTransformer().setInputCol("data").setOutputCol("out")
    .setUrl(_CLOSED), _REQ))


# ------------------------------------------------------------ coverage gate

def _port_stages():
    return {qual: cls for qual, cls in registered_stages().items()
            if qual.startswith("mmlspark_tpu_torch.")
            and not issubclass(cls, Model)}


def test_every_stage_has_a_fuzzer():
    missing = [q for q in _port_stages() if q not in FUZZING_REGISTRY]
    assert not missing, f"stages without fuzzing TestObjects: {missing}"


def test_registry_holds_the_slice_11_stages():
    """The 22 classes of stages/ register, Models included."""
    names = {q.rsplit(".", 1)[-1] for q in registered_stages()
             if q.startswith("mmlspark_tpu_torch.stages.")}
    assert len(names) == 22, sorted(names)
    assert {"ClassBalancerModel", "CleanMissingDataModel"} <= names


FUZZ_KEYS = sorted(FUZZING_REGISTRY)


@pytest.mark.parametrize("key", FUZZ_KEYS)
def test_experiment_fuzzing(key):
    experiment_fuzz(FUZZING_REGISTRY[key]())


@pytest.mark.parametrize("key", FUZZ_KEYS)
def test_serialization_fuzzing(key):
    serialization_fuzz(FUZZING_REGISTRY[key]())
