"""TuneHyperparameters + FindBestModel — the port of
``mmlspark_tpu/automl/tune.py`` (reference: tune-hyperparameters/...
/TuneHyperparameters.scala:111-184, HyperparamBuilder.scala, ParamSpace.scala,
DefaultHyperparams.scala; find-best-model/.../FindBestModel.scala:50,
EvaluationUtils.scala:13).

Randomized k-fold search over declared param distributions, with the fold
fits on a thread pool like the reference (:78-94). The threads overlap the
parts of fits that release the GIL, but on a CUDA card the GBDT fits are
host-paced streams of short launches, and there 4 threads run
chip_smoke.py's search ~4.5x slower than 1 (ROADMAP.md Queue 3, measured
by ``tools/automl_tune_threads.py``). The best setting is refit on the full
data. In a world of more than one rank the search is fleet-parallel:
every rank holds the whole tuning frame (a sharded frame is gathered; a
plain one is gathered only when its digest differs between ranks), rank r
fits the jobs j with j % world == r inside ``local_fit_mode`` (no
collectives), one sum merges the results, and every rank refits the
winner locally. Not ported yet: the supervised ``backend="fleet"`` (ASHA
over ``trials.py``/``scheduler.py``, ROADMAP.md Queue 1 item 13b).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from ..core.dataframe import DataFrame
from ..core.params import ComplexParam, HasLabelCol, IntParam, StringParam
from ..core.pipeline import Estimator, Model
from . import metrics as M
from .model_statistics import ComputeModelStatistics


# ----------------------------------------------------------- param space

class DiscreteHyperParam:
    def __init__(self, values: Sequence):
        self.values = list(values)

    def sample(self, rng):
        return self.values[rng.integers(0, len(self.values))]


class RangeHyperParam:
    def __init__(self, lo, hi, is_int: bool = False, log: bool = False):
        self.lo, self.hi, self.is_int, self.log = lo, hi, is_int, log

    def sample(self, rng):
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))
        else:
            v = float(rng.uniform(self.lo, self.hi))
        return int(round(v)) if self.is_int else v


class HyperparamBuilder:
    """Collects (param name -> distribution) per estimator."""

    def __init__(self):
        self._dists: list[tuple[str, object]] = []

    def addHyperparam(self, name: str, dist) -> "HyperparamBuilder":
        self._dists.append((name, dist))
        return self

    def build(self):
        return list(self._dists)


class GridSpace:
    """Full cartesian grid over discrete values."""

    def __init__(self, dists: list[tuple[str, DiscreteHyperParam]]):
        self.dists = dists

    def settings(self, rng=None):
        import itertools
        names = [n for n, _ in self.dists]
        for combo in itertools.product(*[d.values for _, d in self.dists]):
            yield dict(zip(names, combo))


class RandomSpace:
    """Random samples from the declared distributions."""

    def __init__(self, dists: list[tuple[str, object]]):
        self.dists = dists

    def sample(self, rng):
        return {n: d.sample(rng) for n, d in self.dists}


class DefaultHyperparams:
    """Per-algorithm default search spaces (reference
    DefaultHyperparams.scala)."""

    @staticmethod
    def for_estimator(est) -> list[tuple[str, object]]:
        name = type(est).__name__
        if "LogisticRegression" in name or "LinearRegression" in name:
            return [("regParam", RangeHyperParam(1e-4, 1.0, log=True)),
                    ("maxIter", DiscreteHyperParam([100, 200]))]
        if "LightGBM" in name or "GBT" in name or "RandomForest" in name \
                or "DecisionTree" in name:
            return [("numLeaves", DiscreteHyperParam([8, 16, 32])),
                    ("learningRate", RangeHyperParam(0.02, 0.3, log=True)),
                    ("numIterations", DiscreteHyperParam([30, 60, 100]))]
        if "Perceptron" in name or "MLP" in name:
            return [("stepSize", RangeHyperParam(0.005, 0.1, log=True)),
                    ("maxIter", DiscreteHyperParam([20, 40]))]
        if "TorchLearner" in name:
            return [("learningRate", RangeHyperParam(0.005, 0.2, log=True)),
                    ("batchSize", DiscreteHyperParam([8, 16, 32]))]
        return []


# ------------------------------------------------------------ evaluation

def _metric_for(df_scored: DataFrame, label_col: str, metric: str) -> float:
    stats = (ComputeModelStatistics()
             .setLabelCol(label_col)
             .setEvaluationMetric("classification"
                                  if metric in M.CLASSIFICATION_METRICS
                                  else "regression")
             .transform(df_scored))
    if metric not in stats.columns:
        raise ValueError(f"metric {metric!r} not computed; have {stats.columns}")
    return float(stats.col(metric)[0])


def _kfold_indices(n: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return np.array_split(perm, k)


def _sample_candidates(models, num_runs: int, rng) -> list:
    """Sample `num_runs` distinct settings per estimator.

    A duplicate draw is resampled (not dropped) under a bounded retry
    budget; small discrete spaces that genuinely hold fewer than
    `num_runs` distinct settings warn once and yield what exists.
    """
    import logging

    from .. import telemetry

    candidates = []  # (estimator, setting)
    for est in models:
        dists = DefaultHyperparams.for_estimator(est)
        space = RandomSpace(dists)
        seen = set()
        budget = 20 * num_runs
        while len(seen) < num_runs and budget > 0:
            budget -= 1
            setting = space.sample(rng) if dists else {}
            key = tuple(sorted(setting.items()))
            if key in seen:
                continue
            seen.add(key)
            candidates.append((est, setting))
        if len(seen) < num_runs:
            telemetry.warn_once(
                logging.getLogger("mmlspark_tpu_torch.automl"),
                f"tune-space-exhausted:{type(est).__name__}",
                "param space for %s yielded only %d distinct settings "
                "(numRuns=%d); continuing with what exists",
                type(est).__name__, len(seen), num_runs)
    return candidates


class TuneHyperparametersModel(Model):
    bestModel = ComplexParam("refit best model", default=None)
    bestMetric = ComplexParam("cv metric of the winner", default=None)
    bestSetting = ComplexParam("winning param setting", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.getBestModel().transform(df)


class TuneHyperparameters(Estimator, HasLabelCol):
    models = ComplexParam("estimators to search over", default=None)
    paramSpace = ComplexParam("list of (estimator_idx, name, dist) or None "
                              "for per-algorithm defaults", default=None)
    evaluationMetric = StringParam("metric name", default="accuracy")
    numFolds = IntParam("cross-validation folds", default=3, min=2)
    numRuns = IntParam("random settings sampled per estimator", default=8, min=1)
    parallelism = IntParam("thread-pool width", default=4, min=1)
    seed = IntParam("seed", default=0)
    backend = StringParam("where trials run: 'local' thread pool or the "
                          "supervised 'fleet' ASHA scheduler (not ported "
                          "yet: ROADMAP.md Queue 1 item 13b)",
                          default="local", choices=("local", "fleet"))

    def fit(self, df: DataFrame) -> TuneHyperparametersModel:
        if self.getBackend() == "fleet":
            raise NotImplementedError(
                "TuneHyperparameters backend='fleet' (the supervised trial "
                "fleet over trials.py/scheduler.py) is not ported yet "
                "(ROADMAP.md Queue 1 item 13b)")
        metric = self.getEvaluationMetric()
        maximize = M.METRIC_MAXIMIZE[metric]
        rng = np.random.default_rng(self.getSeed())
        folds = _kfold_indices(df.count(), self.getNumFolds(), self.getSeed())
        label = self.getLabelCol()

        candidates = _sample_candidates(self.getModels(), self.getNumRuns(),
                                        rng)

        # fold masks are precomputed: eval_fold runs on a thread pool, and
        # a dict populated from inside the workers would race
        def _fold_masks(n):
            masks = {}
            for fi, val_idx in enumerate(folds):
                m = np.zeros(n, dtype=bool)
                m[val_idx] = True
                masks[fi] = m
            return masks

        mask_cache = _fold_masks(df.count())

        def eval_fold(est, setting, fold_i):
            val_mask = mask_cache[fold_i]
            train = df.filter(~val_mask)
            val = df.filter(val_mask)
            model = est.copy(dict(setting, labelCol=label)).fit(train)
            return _metric_for(model.transform(val), label, metric)

        jobs = [(ci, fi) for ci in range(len(candidates))
                for fi in range(self.getNumFolds())]
        results = np.zeros(len(jobs))
        from ..parallel import dataplane
        from ..parallel import mesh as meshlib
        width = self.getParallelism()
        nproc = meshlib.effective_process_count()
        if nproc > 1:
            # fleet-parallel search: each (candidate, fold) job goes to one
            # rank round-robin, and inside local_fit_mode its fits run with
            # no collectives (the reference's thread-pool trick,
            # TuneHyperparameters.scala:78-94, across the fleet). Every
            # rank needs the whole tuning frame for exact CV: the tuning
            # set fits one host by construction.
            if dataplane.is_sharded(df):
                df = dataplane._gather_frames(df.localFrame())
            elif len(set(dataplane.allgather_pyobj(_frame_digest(df)))) > 1:
                # a plain frame on a fleet is ambiguous: identical frames
                # everywhere are replicated (used as they are), differing
                # ones are shards (gathered)
                df = dataplane._gather_frames(df)
            folds = _kfold_indices(df.count(), self.getNumFolds(),
                                   self.getSeed())
            mask_cache = _fold_masks(df.count())
            rank = meshlib.process_index()
            mine = [j for j in range(len(jobs)) if j % nproc == rank]
            with meshlib.local_fit_mode(), ThreadPoolExecutor(width) as pool:
                futs = {pool.submit(eval_fold, candidates[jobs[j][0]][0],
                                    candidates[jobs[j][0]][1], jobs[j][1]): j
                        for j in mine}
                for fut, j in futs.items():
                    results[j] = fut.result()
            # merge: each job was computed by exactly one rank
            results = dataplane.allreduce_sum(results)
        else:
            with ThreadPoolExecutor(width) as pool:
                futs = {pool.submit(eval_fold, candidates[ci][0],
                                    candidates[ci][1], fi): j
                        for j, (ci, fi) in enumerate(jobs)}
                for fut, j in futs.items():
                    results[j] = fut.result()

        per_candidate = results.reshape(len(candidates), self.getNumFolds())
        means = per_candidate.mean(axis=1)
        best_i = int(np.argmax(means) if maximize else np.argmin(means))
        best_est, best_setting = candidates[best_i]
        best = best_est.copy(dict(best_setting, labelCol=label))
        if nproc > 1:
            # every rank holds the same whole tuning frame here: a local
            # deterministic refit gives the same model everywhere (the
            # collective path would read nproc copies as shards)
            with meshlib.local_fit_mode():
                best_model = best.fit(df)
        else:
            best_model = best.fit(df)
        return (TuneHyperparametersModel()
                .setBestModel(best_model)
                .setBestMetric(float(means[best_i]))
                .setBestSetting(dict(best_setting)))


def _frame_digest(df: DataFrame) -> str:
    """A content digest of a frame's columns (ranks compare theirs to tell
    a replicated frame from per-rank shards)."""
    import hashlib
    import pickle
    return hashlib.sha256(pickle.dumps(
        {k: np.asarray(v).tobytes() if v.dtype.kind != "O"
         else pickle.dumps(v.tolist())
         for k, v in df._cols.items()})).hexdigest()


# ---------------------------------------------------------- find best model

class BestModel(Model):
    bestModel = ComplexParam("winning fitted model", default=None)
    bestModelMetrics = ComplexParam("metric value of the winner", default=None)
    allModelMetrics = ComplexParam("metric per candidate", default=None)

    def transform(self, df: DataFrame) -> DataFrame:
        return self.getBestModel().transform(df)


class FindBestModel(Estimator, HasLabelCol):
    """Evaluate FITTED models on a dataframe, keep the best (reference:
    FindBestModel.scala:50)."""

    models = ComplexParam("fitted Transformers to compare", default=None)
    evaluationMetric = StringParam("metric name", default="accuracy")

    def fit(self, df: DataFrame) -> BestModel:
        metric = self.getEvaluationMetric()
        maximize = M.METRIC_MAXIMIZE[metric]
        scores = []
        for model in self.getModels():
            scored = model.transform(df)
            scores.append(_metric_for(scored, self.getLabelCol(), metric))
        best_i = int(np.argmax(scores) if maximize else np.argmin(scores))
        return (BestModel()
                .setBestModel(self.getModels()[best_i])
                .setBestModelMetrics(scores[best_i])
                .setAllModelMetrics(list(zip(
                    [type(m).__name__ for m in self.getModels()], scores))))
