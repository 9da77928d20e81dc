"""The port's core (Params, DataFrame, stages, serialization) against the
JAX package's: the same inputs through both give the same results."""

import numpy as np
import pytest

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.core.params import ParamValidationError as JaxPVE
from mmlspark_tpu_torch.core import serialize
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import (IntParam, ParamValidationError,
                                            StringParam)
from mmlspark_tpu_torch.core.pipeline import (STAGE_REGISTRY, Estimator,
                                              Model, Pipeline, PipelineModel,
                                              Transformer)


def _frames(seed=0, n=40):
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(0, 4, n), "x": rng.normal(size=n),
            "s": np.array(list("abcde") * (n // 5), dtype=object)}
    return DataFrame(data), JaxDataFrame(data)


def _same(a, b):
    assert a.columns == b.columns and a.count() == b.count()
    for c in a.columns:
        x, y = a.col(c), b.col(c)
        if x.dtype.kind == "f":
            np.testing.assert_array_equal(x, y)
        else:
            assert list(x) == list(y)


@pytest.mark.parametrize("op", [
    lambda d: d.groupBy("k").agg({"x": "mean"}),
    lambda d: d.groupBy("k", "s").count(),
    lambda d: d.filter(d.col("x") > 0).sort("x"),
    lambda d: d.join(d.select("k", "s").distinct(), on="k", how="left"),
    lambda d: d.randomSplit([0.3, 0.7], seed=3)[1],
    lambda d: d.withColumn("y", d.col("x") * 2).drop("s"),
])
def test_dataframe_ops_match_jax(op):
    port, ref = _frames()
    _same(op(port), op(ref))


def test_from_arrow_stream_names_roadmap():
    """``fromArrowStream`` waited for ROADMAP item 10's ingest half, which
    is ported: a record-batch stream materializes as the JAX package's
    frame does."""
    import pyarrow as pa
    port, ref = _frames(n=40)
    table = pa.table({"k": port.col("k"), "x": port.col("x")})
    batches = table.to_batches(max_chunksize=16)
    _same(DataFrame.fromArrowStream(batches),
          JaxDataFrame.fromArrowStream(batches))
    _same(DataFrame.fromArrowStream(table), ref.select("k", "x"))


class _Scale(Transformer):
    factor = IntParam("multiplier", default=2, min=1)
    col = StringParam("column", default="x")

    def transform(self, df):
        return df.withColumn(self.getCol(), df.col(self.getCol())
                             * self.getFactor())


class _MeanModel(Model):
    mean = IntParam("rounded mean", default=0)

    def transform(self, df):
        return df.withColumn("m", np.full(df.count(), self.getMean()))


class _Mean(Estimator):
    def fit(self, df):
        return _MeanModel(mean=int(round(df.col("x").mean())))


def test_params_validate_like_jax():
    with pytest.raises(ParamValidationError):
        _Scale(factor=0)
    with pytest.raises(ParamValidationError):
        _Scale(factor=True)
    assert issubclass(ParamValidationError, ValueError)
    assert issubclass(JaxPVE, ValueError)
    with pytest.raises(KeyError):
        _Scale(nope=1)


def test_pipeline_fit_transform_and_registry():
    df = DataFrame({"x": np.arange(6.0)})
    pm = Pipeline(stages=(_Scale(factor=3), _Mean())).fit(df)
    assert isinstance(pm, PipelineModel)
    out = pm.transform(df)
    np.testing.assert_array_equal(out.col("x"), np.arange(6.0) * 3)
    assert set(out.col("m")) == {8}
    assert any(k.endswith("._Scale") for k in STAGE_REGISTRY)
    assert all(not k.startswith("mmlspark_tpu.") for k in STAGE_REGISTRY)
    with pytest.raises(TypeError):
        Pipeline(stages=(_Mean(),)).transform(df)


def test_stage_save_load_round_trip(tmp_path):
    import torch
    stage = _Scale(factor=4, col="x")
    stage.save(str(tmp_path / "s"))
    back = serialize.load_stage(str(tmp_path / "s"))
    assert type(back) is _Scale and back.uid == stage.uid
    assert back.getFactor() == 4

    pm = PipelineModel(stages=(_Scale(factor=2), _MeanModel(mean=5)))
    pm.save(str(tmp_path / "pm"))
    back = serialize.load_stage(str(tmp_path / "pm"))
    df = DataFrame({"x": np.arange(3.0)})
    _same(back.transform(df), pm.transform(df))

    # complex tensor trees keep each leaf's kind and dtype
    tree = {"a": {"w": np.ones((2, 3), np.float32)},
            "b": torch.arange(4, dtype=torch.bfloat16)}
    tag = serialize._save_complex(tree, str(tmp_path / "tree"))
    got = serialize._load_complex(tag, str(tmp_path / "tree"))
    np.testing.assert_array_equal(got["a"]["w"], tree["a"]["w"])
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"], tree["b"])
