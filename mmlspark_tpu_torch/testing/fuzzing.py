"""Generic stage contract fuzzing (reference: core/test/fuzzing/.../
Fuzzing.scala + FuzzingTest.scala:25-130).

The reference reflects over every PipelineStage in the built jars and fails
the build if any stage lacks a fuzzing TestObject, can't serialize, or breaks
the fit/transform contract. Here the stage registry
(core.pipeline.STAGE_REGISTRY) plays the jar-reflection role:

  * ``TestObject(stage, fit_df, trans_df)`` — one per stage class;
  * ``experiment_fuzz`` — fit/transform must run and keep row counts sane;
  * ``serialization_fuzz`` — save/load the stage AND its fitted model, then
    compare transform outputs with tolerant equality
    (Fuzzing.scala:158-221);
  * the coverage gate lives in tests/test_torch_fuzzing.py.

The port's own copy of ``mmlspark_tpu/testing/fuzzing.py``, over the port's
stage registry and its ``save_stage``/``load_stage``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional

import numpy as np

from ..core.dataframe import DataFrame
from ..core.pipeline import Estimator, PipelineStage, Transformer
from ..core.serialize import load_stage, save_stage

# qualified stage name -> factory() -> TestObject
FUZZING_REGISTRY: dict[str, Callable[[], "TestObject"]] = {}


class TestObject:
    def __init__(self, stage: PipelineStage, fit_df: DataFrame,
                 trans_df: Optional[DataFrame] = None):
        self.stage = stage
        self.fit_df = fit_df
        self.trans_df = trans_df if trans_df is not None else fit_df


def register_fuzzing(cls):
    """Decorator: @register_fuzzing(StageClass) over a zero-arg factory."""
    def deco(factory):
        key = f"{cls.__module__}.{cls.__qualname__}"
        FUZZING_REGISTRY[key] = factory
        return factory
    return deco


def frames_equal(a: DataFrame, b: DataFrame, rtol=1e-4, atol=1e-5) -> None:
    """Tolerant dataframe equality (Fuzzing.scala:33-80)."""
    assert set(a.columns) == set(b.columns), (a.columns, b.columns)
    assert a.count() == b.count()
    for c in a.columns:
        ca, cb = a.col(c), b.col(c)
        if ca.dtype.kind in "if" and cb.dtype.kind in "if":
            np.testing.assert_allclose(ca.astype(np.float64),
                                       cb.astype(np.float64),
                                       rtol=rtol, atol=atol, err_msg=c)
        elif ca.dtype.kind == "O" and len(ca) and \
                isinstance(ca[0], np.ndarray):
            for va, vb in zip(ca, cb):
                np.testing.assert_allclose(np.asarray(va, np.float64),
                                           np.asarray(vb, np.float64),
                                           rtol=rtol, atol=atol, err_msg=c)
        else:
            assert [str(v) for v in ca] == [str(v) for v in cb], c


def experiment_fuzz(to: TestObject) -> None:
    """Fit/transform must execute (ExperimentFuzzing, Fuzzing.scala:128-155)."""
    stage = to.stage.copy()
    if isinstance(stage, Estimator):
        model = stage.fit(to.fit_df)
        assert isinstance(model, Transformer), type(model)
        out = model.transform(to.trans_df)
    else:
        out = stage.transform(to.trans_df)
    assert isinstance(out, DataFrame)


def serialization_fuzz(to: TestObject, workdir: Optional[str] = None) -> None:
    """Save/load round trips for the raw stage and the fitted model, with
    output comparison (SerializationFuzzing, Fuzzing.scala:158-221)."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        stage = to.stage.copy()
        # raw stage round trip
        p1 = os.path.join(tmp, "stage")
        save_stage(stage, p1)
        stage2 = load_stage(p1)
        assert type(stage2) is type(stage)

        if isinstance(stage, Estimator):
            model = stage.fit(to.fit_df)
            model2 = stage2.fit(to.fit_df)
            p2 = os.path.join(tmp, "model")
            save_stage(model, p2)
            model3 = load_stage(p2)
            a = model.transform(to.trans_df)
            c = model3.transform(to.trans_df)
            frames_equal(a, c)
            frames_equal(a, model2.transform(to.trans_df))
        else:
            a = stage.transform(to.trans_df)
            b = stage2.transform(to.trans_df)
            frames_equal(a, b)
