"""Jobs of the sharded AutoML and GBDT tests (not a test file): each runs on
every rank of a gloo group started by ``torch_dist_workers.run_ranks(world,
"torch_sharded_jobs:<job>", tmp_path, **kw)``. The workers import torch and
the port only (no JAX); the tests hold the results against the JAX package.
"""

from __future__ import annotations

import numpy as np


def _frame(cols: dict):
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.parallel import dataplane
    return dataplane.ShardedDataFrame.fromLocal(DataFrame(dict(cols)))


def _set_caps(caps: dict):
    """Set the pooled-sample and sketch caps (``{(class, attr): value}``)
    of the data stages; small caps make small frames exercise the sampled
    merges."""
    from mmlspark_tpu_torch.stages import data_stages
    for (cls, attr), v in caps.items():
        setattr(getattr(data_stages, cls), attr, v)


def _stats(df) -> dict:
    from mmlspark_tpu_torch.automl.featurize import Featurize
    from mmlspark_tpu_torch.automl.value_indexer import ValueIndexer
    from mmlspark_tpu_torch.ops.text_stages import TextFeaturizer
    from mmlspark_tpu_torch.stages.basic import ClassBalancer
    from mmlspark_tpu_torch.stages.data_stages import (CleanMissingData,
                                                       SummarizeData)
    num = [c for c in df.columns if c.startswith("num")]
    out = {"levels": ValueIndexer(inputCol="cat", outputCol="i").fit(df)
           .getLevels()}
    fm = Featurize(inputCols=["num0", "cat", "text"], outputCol="f",
                   numberOfFeatures=16).fit(df)
    out["plans"] = fm.getInputPlans()
    feats = fm.transform(df.localFrame()).col("f")
    out["width"] = int(len(feats[0])) if len(feats) else None
    out["weights"] = ClassBalancer(inputCol="label", outputCol="w").fit(df) \
        .getWeightTable()
    for mode in ("Mean", "Median"):
        out[mode] = CleanMissingData(inputCols=num, cleaningMode=mode) \
            .fit(df).getFillValues()
    summary = SummarizeData().transform(df)
    out["summary"] = {c: summary.col(c).tolist() for c in summary.columns}
    out["idf"] = TextFeaturizer(inputCol="text", outputCol="t",
                                numFeatures=64).fit(df).getIdfWeights()
    return out


def stats_job(rank, world, shards, caps, f2_levels=None):
    """The fits of the AutoML half whose merges are host statistics, over
    this rank's shard (``shards[rank]``, a dict of columns; a shard may be
    empty): once at the stages' own caps, once at ``caps``. With
    ``f2_levels``, also ValueIndexer over a shard of those levels."""
    from mmlspark_tpu_torch.automl.value_indexer import ValueIndexer
    df = _frame(shards[rank])
    out = {"exact": _stats(df)}
    _set_caps(caps)
    out["sampled"] = _stats(df)
    if f2_levels is not None:
        f2 = _frame({"v": np.array(f2_levels[rank], dtype=object)})
        out["f2"] = ValueIndexer(inputCol="v", outputCol="i").fit(f2) \
            .getLevels()
    return out


def automl_job(rank, world, stats, learners):
    """Every AutoML site in one group: ``stats_job``'s and
    ``learners_job``'s keyword arguments."""
    return {"stats": stats_job(rank, world, **stats),
            "learners": learners_job(rank, world, **learners)}


def learners_job(rank, world, shards, search):
    """The MLP's pooled moments and the multi-process search, each rank
    holding ``shards[rank]``; returns the search's merged per-job results
    (the one-process reference search runs in the test's own process)."""
    from mmlspark_tpu_torch.automl import tune
    from mmlspark_tpu_torch.models import classical
    from mmlspark_tpu_torch.parallel import dataplane
    df = _frame(shards[rank])
    mlp = classical.MultilayerPerceptronClassifier(
        featuresCol="features", labelCol="label", layers=(4,), maxIter=1,
        batchSize=16, device="cpu").fit(df)
    inner = mlp.getInner().getModelParams()
    out = {"mu": mlp.getFeatureMean(), "sd": mlp.getFeatureScale(),
           "mlp_params": {k: np.asarray(v) for k, v in inner.items()}}
    merged = []
    real = dataplane.allreduce_sum

    def recording(x):
        res = real(x)
        merged.append(res)
        return res
    dataplane.allreduce_sum = recording
    try:
        model = tune.TuneHyperparameters(models=_search_models(),
                                         **search).fit(df)
    finally:
        dataplane.allreduce_sum = real
    out.update(best_setting=model.getBestSetting(),
               best_metric=model.getBestMetric(), results=merged[-1])
    return out


def _search_models():
    from mmlspark_tpu_torch.models import classical
    return (classical.LogisticRegression(device="cpu", maxIter=20),
            classical.NaiveBayes(device="cpu", modelType="gaussian"))


def _state(ens) -> dict:
    from mmlspark_tpu_torch.models.gbdt.stages import _ensemble_to_state
    return _ensemble_to_state(ens)


def gbdt_job(rank, world, fits, stage=None):
    """Engine fits over a mesh of the whole world: ``fits`` maps a name to
    {x, y, params (GBDTParams fields), rows (per-rank row slices for a data
    fit; None: every rank holds every row), score (rows to predict)}.
    ``stage`` (optional) adds the stage-side checks."""
    from mmlspark_tpu_torch.models.gbdt import engine
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    mesh = meshlib.create_mesh()
    out = {}
    for name, f in fits.items():
        x, y = f["x"], f["y"]
        if f.get("rows") is not None:
            lo, hi = f["rows"][rank]
            x, y = x[lo:hi], y[lo:hi]
        ens = engine.fit_gbdt(x, y, engine.GBDTParams(**f["params"]),
                              mesh=mesh, device="cpu")
        out[name] = {"state": _state(ens),
                     "pred": engine.predict(ens, f["score"],
                                            predict_impl="dense",
                                            device="cpu")}
    if stage is not None:
        out["stage"] = _stage_checks(rank, world, **stage)
    return out


def _stage_checks(rank, world, x, y, rows, sparse_seed):
    """The LightGBM stages in a multi-rank world: their mesh choice, a
    fit over a sharded frame, and the wide-sparse EFB plan."""
    from mmlspark_tpu_torch.core.utils import object_column
    from mmlspark_tpu_torch.models.gbdt.stages import LightGBMClassifier
    from mmlspark_tpu_torch.parallel import mesh as meshlib
    out = {}
    cases = {"default_small": (LightGBMClassifier(), 300),
             "default_large": (LightGBMClassifier(), 100_000),
             "explicit_feature_small": (LightGBMClassifier().setParallelism(
                 "feature_parallel"), 300),
             "explicit_serial_large": (LightGBMClassifier().setParallelism(
                 "serial"), 100_000)}
    out["mesh"] = {k: clf._mesh(n) is not None for k, (clf, n)
                   in cases.items()}
    with meshlib.local_fit_mode():
        out["mesh_local"] = {k: clf._mesh(n) is not None for k, (clf, n)
                             in cases.items()}
    try:
        LightGBMClassifier(device="cpu", parallelism="feature_parallel",
                           numIterations=1).fit(_frame(
                               {"features": object_column(list(x[:8])),
                                "label": y[:8]}))
    except ValueError as e:
        out["feature_error"] = str(e)
    lo, hi = rows[rank]
    df = _frame({"features": object_column(list(x[lo:hi])),
                 "label": y[lo:hi]})
    model = LightGBMClassifier(device="cpu", numIterations=5, maxBin=31,
                               growthPolicy="depthwise",
                               maxDepth=3).fit(df)
    out["fit_state"] = model.getBoosterState()
    out["fit_prob"] = np.stack(list(model.transform(df.localFrame()).col(
        "probability")))
    rows_sp, ys = _sparse_shard(sparse_seed + rank, 300 + 200 * rank, rank)
    sdf = _frame({"features": object_column(rows_sp),
                  "label": ys.astype(np.float64)})
    sparse = (LightGBMClassifier(device="cpu").setNumIterations(6)
              .setNumLeaves(15).setMaxBin(63).setMaxDenseFeatures(32)
              .fit(sdf))
    out["sparse_plan"] = (
        tuple(int(j) for j in sparse.getFeatureSelection()),
        tuple(tuple(int(j) for j in b)
              for b in (sparse.getFeatureBundles() or ())))
    out["sparse_state"] = sparse.getBoosterState()
    return out


def _sparse_shard(seed, n, rank, d=256):
    """Wide sparse rows whose column densities differ per rank (the JAX
    package's fleet-consistency case): a plan from local document
    frequencies would differ between ranks."""
    import scipy.sparse as sp
    signal = set(range(180, 192))
    rng = np.random.default_rng(seed)
    bias = np.roll(np.linspace(1.0, 8.0, d), rank * 97)
    bias[list(signal)] = 0.8
    p = bias / bias.sum()
    rows, ys = [], []
    for _ in range(n):
        cols = rng.choice(d, 12, replace=False, p=p)
        rows.append(sp.csr_matrix((np.ones(12, np.float32),
                                   (np.zeros(12, np.int64), cols)),
                                  shape=(1, d)))
        ys.append(bool(signal & set(int(c) for c in cols)))
    return rows, np.array(ys)
