"""The port's pipeline stages against the JAX package's.

Each of the 22 stage classes of ``mmlspark_tpu_torch/stages`` gets the same
numpy-seeded frame as its ``mmlspark_tpu/stages`` counterpart and must give
the same output frame: the same columns in the same order, dtypes and
metadata, and values equal exactly (NaN where NaN). Both packages run the
same host numpy, so no tolerance is taken. Estimators are fitted and their
models applied; the two Model classes are also built directly, from the
same weight table and fill values. Timer runs with ``logToProfiler=True`` on both sides (a
``torch.profiler.record_function`` range in the port, a
``jax.profiler.TraceAnnotation`` in the JAX package); the port's Profiler
writes a Chrome trace into a temporary ``traceDir`` while the JAX one runs
its inner stage alone. The behavioural cases of tests/test_stages.py follow,
parametrised, against the port.
"""

import datetime
import json
import os

import numpy as np
import pytest

from mmlspark_tpu import stages as J
from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch import stages as P
from mmlspark_tpu_torch.core.schema import CategoricalUtilities
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.stages import udfs


def _cols(seed=0, n=40):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    a[rng.choice(n, 5, replace=False)] = np.nan
    vec = [rng.normal(size=3).astype(np.float32) for _ in range(n)]
    return {
        "a": a,
        "b": rng.integers(-5, 5, n).astype(np.int64),
        "c": rng.uniform(0, 10, n).astype(np.float32),
        "k": np.array(["x", "y", "z"], dtype=object)[rng.integers(0, 3, n)],
        "label": rng.integers(0, 3, n).astype(np.int64),
        "text": np.array([f"The Quick fox {i % 4} jumps" for i in range(n)],
                         dtype=object),
        "vec": object_column(vec),
        "date": np.array([f"2026-0{1 + i % 9}-1{i % 10} 0{i % 10}:30:00"
                          for i in range(n)], dtype=object),
    }


def _both(cols):
    """One dict of numpy columns as a port frame and a JAX frame."""
    copy = {k: (object_column(list(v)) if v.dtype == object else v.copy())
            for k, v in cols.items()}
    return DataFrame(cols), JaxDataFrame(copy)


def _same_value(u, v) -> bool:
    if isinstance(u, (list, tuple, np.ndarray)) or isinstance(
            v, (list, tuple, np.ndarray)):
        a, b = np.asarray(u), np.asarray(v)
        if a.dtype == object or b.dtype == object:
            return len(a) == len(b) and all(_same_value(x, y)
                                            for x, y in zip(a, b))
        return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)
    if isinstance(u, float) and isinstance(v, float):
        return u == v or (np.isnan(u) and np.isnan(v))
    return type(u) is type(v) and u == v


def assert_same_frame(got, want):
    assert got.columns == want.columns
    assert got.count() == want.count()
    for c in want.columns:
        g, w = got.col(c), want.col(c)
        assert g.dtype == w.dtype, c
        assert json.dumps(got.metadata(c), sort_keys=True, default=str) == \
            json.dumps(want.metadata(c), sort_keys=True, default=str), c
        if w.dtype != object:
            assert np.array_equal(g, w, equal_nan=w.dtype.kind in "fc"), c
        else:
            assert all(_same_value(x, y) for x, y in zip(g, w)), c


def _double(v):
    return float(v) * 2


#: class name -> (stage builder over a stages module, columns kept)
CASES = {
    "Cacher": (lambda S: S.Cacher(), None),
    "CheckpointData": (lambda S: S.CheckpointData().setRemoveCheckpoint(True),
                       None),
    "DropColumns": (lambda S: S.DropColumns().setCols(("b", "text")), None),
    "SelectColumns": (lambda S: S.SelectColumns().setCols(("c", "a")), None),
    "RenameColumn": (lambda S: S.RenameColumn().setInputCol("a")
                     .setOutputCol("a2"), None),
    "Repartition": (lambda S: S.Repartition().setN(4), None),
    "UDFTransformer": (lambda S: S.UDFTransformer().setInputCol("c")
                       .setOutputCol("c2").setUdf(_double), None),
    "ClassBalancer": (lambda S: S.ClassBalancer().setInputCol("label")
                      .setOutputCol("w"), None),
    "ClassBalancerModel": (lambda S: S.ClassBalancerModel()
                           .setInputCol("k").setOutputCol("w")
                           .setWeightTable({"x": 2.0, "y": 0.5}), None),
    "MultiColumnAdapter": (lambda S: S.MultiColumnAdapter()
                           .setBaseStage(S.ClassBalancer())
                           .setInputCols(("label", "k"))
                           .setOutputCols(("wl", "wk")), None),
    "Timer": (lambda S: S.Timer().setStage(S.ClassBalancer()
                                           .setInputCol("k")
                                           .setOutputCol("w"))
              .setLogToConsole(False).setLogToProfiler(True), None),
    "Profiler": (lambda S: S.Profiler().setStage(
        S.DropColumns().setCols(("vec",))), None),
    "FastVectorAssembler": (lambda S: S.FastVectorAssembler()
                            .setInputCols(("c", "vec", "b"))
                            .setOutputCol("fv"), "cat"),
    "CleanMissingData": (lambda S: S.CleanMissingData()
                         .setInputCols(("a", "c"))
                         .setCleaningMode("Median"), None),
    "CleanMissingDataModel": (lambda S: S.CleanMissingDataModel()
                              .setInputCols(("a",)).setOutputCols(("a0",))
                              .setFillValues({"a": -1.5}), None),
    "DataConversion": (lambda S: S.DataConversion().setCols(("a", "c"))
                       .setConvertTo("float"), None),
    "PartitionSample": (lambda S: S.PartitionSample()
                        .setMode("RandomSample").setPercent(0.4)
                        .setSeed(3), None),
    "SummarizeData": (lambda S: S.SummarizeData(), ("a", "b", "c", "k")),
    "EnsembleByKey": (lambda S: S.EnsembleByKey().setKeys(("k",))
                      .setCols(("a", "vec")), None),
    "TextPreprocessor": (lambda S: S.TextPreprocessor().setInputCol("text")
                         .setOutputCol("t2").setNormFunc("lowerCase")
                         .setMap({"quick": "slow", "qu": "Q", "fox": "dog"}),
                         None),
    "MiniBatchTransformer": (lambda S: S.MiniBatchTransformer()
                             .setBatchSize(7), ("a", "label", "vec")),
    "FlattenBatch": (lambda S: S.FlattenBatch(), "batched"),
}


def _frames(kind, seed=0):
    cols = _cols(seed)
    if kind is None:
        return _both(cols)
    if kind == "cat":
        df, jdf = _both(cols)
        return (CategoricalUtilities.setLevels(df, "b", list(range(-5, 5))),
                _jax_levels(jdf, "b"))
    if kind == "batched":
        df, jdf = _both({k: cols[k] for k in ("a", "label")})
        return (P.MiniBatchTransformer().setBatchSize(6).transform(df),
                J.MiniBatchTransformer().setBatchSize(6).transform(jdf))
    return _both({k: cols[k] for k in kind})


def _jax_levels(jdf, col):
    from mmlspark_tpu.core.schema import CategoricalUtilities as JaxCat
    return JaxCat.setLevels(jdf, col, list(range(-5, 5)))


def _apply(stage, df):
    if hasattr(stage, "fit") and not hasattr(stage, "transform"):
        return stage.fit(df).transform(df)
    return stage.transform(df)


def test_the_22_classes_are_covered():
    names = {n for n in P.__all__ if n[0].isupper()}
    assert names == set(CASES) and len(names) == 22


@pytest.mark.parametrize("name", sorted(CASES))
def test_stage_matches_jax(name, tmp_path):
    build, kind = CASES[name]
    df, jdf = _frames(kind)
    stage, jstage = build(P), build(J)
    assert type(stage).__name__ == type(jstage).__name__ == name
    if name == "Profiler":
        stage.setTraceDir(str(tmp_path / "trace"))
    got, want = _apply(stage, df), _apply(jstage, jdf)
    assert_same_frame(got, want)
    if name == "Profiler":
        (trace,) = os.listdir(tmp_path / "trace")
        assert stage._last_trace == str(tmp_path / "trace" / trace)
        with open(stage._last_trace) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "Timer/DropColumns"
                   or e.get("ph") == "X" for e in events)


def test_profiler_trace_holds_the_timer_range(tmp_path):
    """Profiler(Timer(logToProfiler=True)(stage)): the Chrome trace holds
    the Timer's range, named as in the JAX package."""
    df, _ = _both(_cols(1))
    prof = P.Profiler().setTraceDir(str(tmp_path)).setStage(
        P.Timer().setLogToConsole(False).setLogToProfiler(True)
        .setStage(P.ClassBalancer().setInputCol("k").setOutputCol("w")))
    out = prof.transform(df)
    assert "w" in out.columns
    with open(prof._last_trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "Timer/ClassBalancer" in names


def test_uses_cuda_walks_nested_stages():
    from mmlspark_tpu_torch.automl.train_classifier import TrainClassifier
    from mmlspark_tpu_torch.models.gbdt.stages import LightGBMClassifier
    inner = TrainClassifier().setModel(LightGBMClassifier())
    assert P.basic.uses_cuda(P.Timer().setStage(inner))
    cpu = TrainClassifier().setModel(LightGBMClassifier(device="cpu"))
    assert not P.basic.uses_cuda(P.Timer().setStage(cpu))
    assert not P.basic.uses_cuda(P.DropColumns())


@pytest.mark.parametrize("fn", ["get_value_at", "to_vector"])
def test_udfs_match_jax(fn):
    from mmlspark_tpu.stages import udfs as judfs
    df, jdf = _both(_cols(2))
    if fn == "get_value_at":
        got = udfs.get_value_at(df, "vec", 1)
        want = judfs.get_value_at(jdf, "vec", 1)
    else:
        lists = object_column([list(v) for v in _cols(2)["vec"]])
        got = udfs.to_vector(df.withColumn("l", lists), "l")
        want = judfs.to_vector(jdf.withColumn("l", object_column(
            [list(v) for v in _cols(2)["vec"]])), "l")
    assert_same_frame(got, want)
    assert udfs.get_value_at_fn(2)(np.arange(4.0)) == 2.0
    assert udfs.to_vector_fn()([1, 2]).dtype == np.float32


# ---------------------------------------------- tests/test_stages.py cases

def _class_balancer_weights():
    df = DataFrame({"y": [0, 0, 0, 1]})
    out = (P.ClassBalancer().setInputCol("y").setOutputCol("w")
           .fit(df).transform(df))
    np.testing.assert_allclose(out.col("w"), [1.0, 1.0, 1.0, 3.0])


def _clean_missing_median():
    df = DataFrame({"a": [1.0, np.nan, 3.0, 100.0]})
    out = (P.CleanMissingData().setInputCols(("a",))
           .setCleaningMode("Median").fit(df).transform(df))
    assert out.col("a")[1] == 3.0


def _data_conversion_casts():
    df = DataFrame({"a": [1.7, 2.2]})
    out = P.DataConversion().setCols(("a",)).setConvertTo("integer") \
        .transform(df)
    assert out.col("a").dtype == np.int32
    out2 = P.DataConversion().setCols(("a",)).setConvertTo("string") \
        .transform(df)
    assert out2.col("a")[0] == "1.7"


def _data_conversion_date():
    df = DataFrame({"d": np.array(["2026-07-29 10:00:00"], dtype=object)})
    out = P.DataConversion().setCols(("d",)).setConvertTo("date") \
        .transform(df)
    assert out.col("d")[0] == datetime.datetime(2026, 7, 29, 10)


def _ensemble_by_key_mean_and_collect():
    df = DataFrame({"k": np.array(["a", "a", "b"], dtype=object),
                    "v": [1.0, 3.0, 5.0]})
    out = P.EnsembleByKey().setKeys(("k",)).setCols(("v",)).transform(df)
    assert {r["k"]: r["v"] for r in out.collect()} == {"a": 2.0, "b": 5.0}
    out2 = (P.EnsembleByKey().setKeys(("k",)).setCols(("v",))
            .setStrategy("collect").transform(df))
    assert {r["k"]: r["v"] for r in out2.collect()}["a"] == [1.0, 3.0]


def _ensemble_by_key_vectors_broadcast():
    vs = object_column([np.full(2, float(i)) for i in range(4)])
    df = DataFrame({"k": [0, 0, 1, 1], "v": vs})
    out = (P.EnsembleByKey().setKeys(("k",)).setCols(("v",))
           .setCollapseGroup(False).transform(df))
    assert out.count() == 4
    np.testing.assert_allclose(out.col("v")[0], [0.5, 0.5])


def _text_preprocessor_longest_match():
    df = DataFrame({"t": np.array(["abcd"], dtype=object)})
    out = (P.TextPreprocessor().setInputCol("t").setOutputCol("o")
           .setMap({"ab": "1", "abc": "2"}).transform(df))
    assert out.col("o")[0] == "2d"  # longest key wins


def _minibatch_roundtrip():
    df = DataFrame({"a": np.arange(10.0), "b": np.arange(10)})
    batched = P.MiniBatchTransformer().setBatchSize(4).transform(df)
    assert batched.count() == 3
    assert len(batched.col("a")[0]) == 4 and len(batched.col("a")[2]) == 2
    flat = P.FlattenBatch().transform(batched)
    np.testing.assert_allclose(np.asarray(flat.col("a"), dtype=np.float64),
                               df.col("a"))


def _partition_sample_modes():
    df = DataFrame({"a": np.arange(100.0)})
    assert P.PartitionSample().setMode("Head").setCount(7) \
        .transform(df).count() == 7
    s = P.PartitionSample().setMode("RandomSample").setPercent(0.3) \
        .setSeed(1).transform(df)
    assert 10 < s.count() < 50
    p = (P.PartitionSample().setMode("AssignToPartition").setNumParts(4)
         .transform(df))
    assert set(np.unique(p.col("Partition"))) <= {0, 1, 2, 3}


def _summarize_data_values():
    df = DataFrame({"x": [1.0, 2.0, 3.0, np.nan]})
    row = P.SummarizeData().transform(df).first()
    assert row["Count"] == 4 and row["Missing Value Count"] == 1
    assert row["Mean"] == 2.0 and row["Median"] == 2.0


def _multi_column_adapter():
    df = DataFrame({"a": [1.0], "b": [2.0]})
    out = (P.MultiColumnAdapter().setBaseStage(P.RenameColumn())
           .setInputCols(("a", "b")).setOutputCols(("x", "y")).transform(df))
    assert set(out.columns) == {"x", "y"}


def _udf_vectorized():
    df = DataFrame({"a": np.arange(4.0)})
    out = (P.UDFTransformer().setInputCol("a").setOutputCol("o")
           .setVectorized(True).setUdf(lambda col: col * 10).transform(df))
    np.testing.assert_allclose(out.col("o"), df.col("a") * 10)


def _timer_records_seconds():
    df = DataFrame({"a": [1.0], "b": [2.0]})
    t = P.Timer().setStage(P.DropColumns().setCols(("a",))) \
        .setLogToConsole(False)
    out = t.transform(df)
    assert out.columns == ["b"]
    assert t._last_seconds >= 0


def _drop_missing_column_raises():
    with pytest.raises(ValueError):
        P.DropColumns().setCols(("zzz",)).transform(DataFrame({"a": [1.0]}))


SEMANTICS = [_class_balancer_weights, _clean_missing_median,
             _data_conversion_casts, _data_conversion_date,
             _ensemble_by_key_mean_and_collect,
             _ensemble_by_key_vectors_broadcast,
             _text_preprocessor_longest_match, _minibatch_roundtrip,
             _partition_sample_modes, _summarize_data_values,
             _multi_column_adapter, _udf_vectorized,
             _timer_records_seconds, _drop_missing_column_raises]


@pytest.mark.parametrize("case", SEMANTICS, ids=lambda f: f.__name__[1:])
def test_stage_semantics(case):
    case()
