"""Estimator / Transformer / Pipeline contract + stage registry.

The PyTorch port's copy of ``mmlspark_tpu/core/pipeline.py``: Spark ML's
stage algebra (every reference component is an Estimator or Transformer —
SURVEY.md §1) plus the reflective stage registry that serialization resolves
class names through. The port keeps its OWN ``STAGE_REGISTRY``, so its stage
names never collide with the JAX package's.

Not ported yet: the fused-fit path (``Pipeline._fit_fused`` and the
``fusePipeline`` params) and the ``capture`` hook. Both wait for the port of
``core/capture.py`` (ROADMAP.md Queue 1 item 11); until then every pipeline
runs staged.
"""

from __future__ import annotations

import uuid as _uuid

from .dataframe import DataFrame
from .params import ComplexParam, Params

# fully-qualified name -> class, for serialization lookup and fuzzing coverage
STAGE_REGISTRY: dict[str, type] = {}


def _qualname(cls: type) -> str:
    return f"{cls.__module__}.{cls.__qualname__}"


def registered_stages() -> dict[str, type]:
    """A copy of the registry: qualified name -> stage class (what the
    fuzzing coverage gate iterates)."""
    return dict(STAGE_REGISTRY)


def lookup_stage_class(name: str) -> type:
    """Resolve a stage class by fully-qualified name, or by bare class name
    when that is unambiguous across the registry."""
    if name in STAGE_REGISTRY:
        return STAGE_REGISTRY[name]
    matches = [c for q, c in STAGE_REGISTRY.items()
               if q.rsplit(".", 1)[-1] == name]
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise KeyError(f"stage class {name!r} not in registry")
    raise KeyError(f"stage class name {name!r} is ambiguous: "
                   f"{[_qualname(m) for m in matches]}")


class PipelineStage(Params):
    """Base of everything fit/transform-shaped. Subclasses auto-register."""

    _abstract = True  # subclasses default to concrete unless they re-declare

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if not cls.__dict__.get("_abstract", False):
            STAGE_REGISTRY[_qualname(cls)] = cls

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.uid = f"{type(self).__name__}_{_uuid.uuid4().hex[:12]}"

    def save(self, path: str, overwrite: bool = True):
        from . import serialize
        serialize.save_stage(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        from . import serialize
        return serialize.load_stage(path)

    def __repr__(self):
        shown = {k: v for k, v in self._paramMap.items()
                 if self._params[k].jsonable}
        return f"{type(self).__name__}({shown})"


class Transformer(PipelineStage):
    _abstract = True

    def transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, df: DataFrame) -> DataFrame:
        return self.transform(df)


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""
    _abstract = True


class Estimator(PipelineStage):
    _abstract = True

    def fit(self, df: DataFrame) -> Model:
        raise NotImplementedError


class Pipeline(Estimator):
    """Chain of stages; fit() fits estimators in order, threading transforms
    (same contract as Spark ML Pipeline, which reference notebooks rely on)."""

    stages = ComplexParam("ordered list of PipelineStages", default=())

    def fit(self, df: DataFrame) -> "PipelineModel":
        stages = list(self.getOrDefault("stages"))
        fitted = []
        cur = df
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
                if i < len(stages) - 1:
                    cur = model.transform(cur)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(stages) - 1:
                    cur = stage.transform(cur)
            else:
                raise TypeError(f"stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel().setStages(tuple(fitted))

    def transform(self, df: DataFrame) -> DataFrame:
        """Only valid for all-transformer pipelines; refitting estimators on
        the transform input would be silent train/test leakage."""
        bad = [type(s).__name__ for s in self.getOrDefault("stages")
               if isinstance(s, Estimator) and not isinstance(s, (Transformer, Pipeline))]
        if bad:
            raise TypeError(
                "Pipeline.transform called on a pipeline containing unfitted "
                f"Estimators {bad}; call fit() first")
        return self.fit(df).transform(df)


class PipelineModel(Model):
    stages = ComplexParam("ordered list of fitted Transformers", default=())

    def transform(self, df: DataFrame) -> DataFrame:
        cur = df
        for stage in self.getOrDefault("stages"):
            cur = stage.transform(cur)
        return cur
