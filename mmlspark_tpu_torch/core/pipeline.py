"""Estimator / Transformer / Pipeline contract + stage registry.

The PyTorch port's copy of ``mmlspark_tpu/core/pipeline.py``: Spark ML's
stage algebra (every reference component is an Estimator or Transformer —
SURVEY.md §1) plus the reflective stage registry that serialization resolves
class names through. The port keeps its OWN ``STAGE_REGISTRY``, so its stage
names never collide with the JAX package's.

``fusePipeline`` on either side routes through ``core/capture.py``: a
``PipelineModel`` runs maximal segments of capturable stages as one program
each (one CUDA graph per signature on a card), and a ``Pipeline`` fit folds
a fully capturable featurize prefix into the final learner's steps.
"""

from __future__ import annotations

import uuid as _uuid
from typing import Optional

from .dataframe import DataFrame
from .params import BooleanParam, ComplexParam, Params, StringParam

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

    #: explicit "host-only stage" marker: a Transformer whose transform
    #: dispatches device computation either exposes a capture() or sets
    #: this True
    _uncapturable = False

    def transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError

    def capture(self, columns):
        """This stage's device computation as a function of device
        tensors (:class:`~.capture.StageCapture`), given the incoming
        column names — or None when the stage cannot describe one (the
        default: stages opt IN to cross-stage fusion). Host-only stages
        set ``_uncapturable = True`` instead of overriding this."""
        return None

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
    fusePipeline = BooleanParam(
        "fuse the FIT side: compose the prefix of capturable featurize "
        "stages into ONE featurize body folded into the final estimator's "
        "per-step training work (core/capture.py fit-side capture) — raw "
        "wire-dtype rows are the only fit-time host->device traffic and "
        "intermediate featurized columns never touch the host. Engages only "
        "when EVERY stage ahead of the final estimator captures AND the "
        "estimator accepts a fused plan (TorchLearner, LightGBM*); anything "
        "else falls back to the staged fit "
        "(mmlspark_fit_fusion_fallbacks_total counts these). The returned "
        "PipelineModel has fusePipeline set so transform fuses too. Fused "
        "featurization computes in device dtypes (float32/int32)",
        default=False)

    def fit(self, df: DataFrame) -> "PipelineModel":
        stages = list(self.getOrDefault("stages"))
        if self.getOrDefault("fusePipeline") and len(stages) >= 2:
            fused = self._fit_fused(df, stages)
            if fused is not None:
                return fused
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
        return _with_device(PipelineModel().setStages(tuple(fitted)), stages)

    def _fit_fused(self, df: DataFrame, stages) -> Optional["PipelineModel"]:
        """The fused featurize->train fit, or None to fall back staged.

        The final stage must be an Estimator exposing ``_fit_captured``
        (the fused-fit hook: takes the raw frame plus a
        :class:`~.capture.FitCapturePlan`, may itself return None to
        decline — e.g. a GBDT configured for a path the fused binner
        does not cover). Every stage ahead of it must capture; a partial
        prefix would still stage the remainder and forfeit the raw-wire
        H2D win, so it is not worth the second code path."""
        from .capture import _m_fit_fallbacks, compose_fit_capture
        last = stages[-1]
        hook = getattr(last, "_fit_captured", None)
        if not isinstance(last, Estimator) or hook is None:
            _m_fit_fallbacks.inc()
            return None
        get_f = getattr(last, "getFeaturesCol", None)
        get_l = getattr(last, "getLabelCol", None)
        plan = compose_fit_capture(
            stages[:-1], df,
            get_f() if get_f else None, get_l() if get_l else None)
        if plan is None:
            _m_fit_fallbacks.inc()
            return None
        model = hook(df, plan)
        if model is None:
            _m_fit_fallbacks.inc()
            return None
        pm = PipelineModel().setStages(tuple(plan.fitted + [model]))
        return _with_device(pm, stages).setFusePipeline(True)

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


def _with_device(pm: "PipelineModel", stages) -> "PipelineModel":
    """``pm`` with the device the caller gave the pipeline's stages (the
    last stage whose ``device`` was set), so its fused segments run where
    the fit ran; unchanged when no stage names one."""
    for stage in reversed(stages):
        if stage.hasParam("device") and stage.isSet("device"):
            return pm.setDevice(stage.getOrDefault("device"))
    return pm


class PipelineModel(Model):
    #: as a STAGE of an outer pipeline a nested PipelineModel runs its
    #: own transform (which may itself fuse internally) — it does not
    #: flatten into the outer segment
    _uncapturable = True
    stages = ComplexParam("ordered list of fitted Transformers", default=())
    fusePipeline = BooleanParam(
        "compose consecutive capturable stages into maximal fused "
        "segments, each run as ONE program (core/capture.py: one CUDA "
        "graph per row count on a card): tensors stay on the device across "
        "stage boundaries inside a segment, so an N-stage chain pays "
        "number-of-segments dispatches instead of N, and zero host round "
        "trips between fused stages. Uncapturable stages split segments "
        "and run their own transform. Fused compute runs in device dtypes "
        "(float32/int32); stages whose host path computes in float64 "
        "differ at float32 precision", default=False)
    device = StringParam(
        "torch device the fused segments run on: 'cuda' (default), "
        "'cuda:N' or 'cpu'. Unset, the first stage that names a device "
        "(a fitted booster or net) decides. Asking for CUDA where there is "
        "none raises", default="cuda")

    def transform(self, df: DataFrame) -> DataFrame:
        stages = self.getOrDefault("stages")
        if self.getOrDefault("fusePipeline") and len(stages) >= 2:
            from .capture import run_fused_pipeline
            return run_fused_pipeline(self, stages, df)
        cur = df
        for stage in stages:
            cur = stage.transform(cur)
        return cur

    def __getstate__(self):
        # the fused segments' programs hold device tensors and graphs:
        # a pickled model (a serving bundle) rebuilds them where it loads
        state = dict(self.__dict__)
        state.pop("_seg_cache", None)
        return state
