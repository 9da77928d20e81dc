"""The AutoML fits of the port over sharded frames against the JAX
package's (the fleet-wide merges; ROADMAP Queue 3's F2).

Gloo groups of 2 and 4 ranks (``tests/torch_dist_workers.py``, the jobs in
``torch_sharded_jobs.py``) each fit, over a
``parallel.dataplane.ShardedDataFrame`` of their rows — one shard of the
4-rank group empty — ValueIndexer, Featurize, ClassBalancer,
CleanMissingData (Mean and Median), SummarizeData, TextFeaturizer, the
MLP learner and TuneHyperparameters' multi-process search. Held to:

* every rank fits the same model;
* it equals the JAX package's fit of the concatenated frame where the
  JAX semantics are exact (``tests/test_dataplane.py``'s assertions:
  ValueIndexer levels, the CleanMissingData mean at rtol 1e-6,
  ClassBalancer weights at 1e-9, SummarizeData count, mean and min, the
  TextFeaturizer IDF at 1e-6, the Featurize plan and width, the MLP's
  moments at 1e-6);
* the sampled statistics (the pooled median, the KMV distinct count, the
  percentiles) equal the JAX package's merges fed the same per-rank
  partials in this process, at the stages' own caps and at caps small
  enough that the samples and the sketch truncate;
* the multi-process search's best setting and merged per-job results
  equal the one-process search's.
"""

import numpy as np
import pytest

import mmlspark_tpu.parallel.dataplane as jdp
from mmlspark_tpu.automl.featurize import Featurize as JFeaturize
from mmlspark_tpu.automl.value_indexer import ValueIndexer as JValueIndexer
from mmlspark_tpu.core.dataframe import DataFrame as JDataFrame
from mmlspark_tpu.core.utils import object_column as jax_object_column
from mmlspark_tpu.models.classical import \
    MultilayerPerceptronClassifier as JMLP
from mmlspark_tpu.ops.text_stages import TextFeaturizer as JTextFeaturizer
from mmlspark_tpu.stages import data_stages as jds
from mmlspark_tpu.stages.basic import ClassBalancer as JClassBalancer
from mmlspark_tpu_torch.automl import tune
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.utils import object_column

import torch_sharded_jobs as jobs
from torch_dist_workers import run_ranks_async

WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]
CAPS = {("CleanMissingData", "_MEDIAN_SAMPLE"): 16,
        ("SummarizeData", "_PCTL_SAMPLE"): 16,
        ("SummarizeData", "_KMV_K"): 8}
SEARCH = dict(evaluationMetric="AUC", numFolds=2, numRuns=2, parallelism=1,
              seed=2, labelCol="label")
F2 = [["a", "b"], ["c", "d"]]


def _stats_shards(world):
    """120 rows over the ranks; in the 4-rank group rank 3's shard is
    empty. Each shard sees its own categorical levels and class mix."""
    rng = np.random.default_rng(5)
    n_ranks = 3 if world == 4 else world
    shards = []
    for r in range(n_ranks):
        n = 120 // n_ranks
        num0 = rng.normal(size=n) * (r + 1) + r
        num1 = rng.exponential(size=n)
        num0[rng.random(n) < 0.2] = np.nan
        num1[::5] = np.nan
        cats = np.array([f"c{(r * 2 + i) % 6}" for i in range(n)],
                        dtype=object)
        text = np.array([" ".join(rng.choice(WORDS, 3)) + f" doc{r}_{i}"
                         for i in range(n)], dtype=object)
        label = (rng.random(n) < 0.2 + 0.2 * r).astype(np.float64) \
            + (rng.random(n) < 0.1)
        shards.append({"num0": num0, "num1": num1, "cat": cats,
                       "text": text, "label": label})
    if world == 4:
        shards.append({"num0": np.zeros(0), "num1": np.zeros(0),
                       "cat": np.array([], dtype=object),
                       "text": np.array([], dtype=object),
                       "label": np.zeros(0)})
    return shards


def _learner_rows():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(96, 5)).astype(np.float32) * [1, 2, 3, 4, 5] \
        + [0, 1, 2, 3, 4]
    y = (x[:, 0] + 0.3 * x[:, 1] + rng.normal(size=96) > 0.5) \
        .astype(np.float64)
    return x.astype(np.float32), y


def _learner_shards(world):
    x, y = _learner_rows()
    cuts = np.linspace(0, len(x), world + 1).astype(int)
    return [{"features": object_column(list(x[a:b])), "label": y[a:b]}
            for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_automl")
    futs = {w: run_ranks_async(
        w, "torch_sharded_jobs:automl_job", tmp / f"w{w}", timeout=400,
        stats=dict(shards=_stats_shards(w), caps=CAPS,
                   f2_levels=F2 if w == 2 else None),
        learners=dict(shards=_learner_shards(w), search=SEARCH))
        for w in (2, 4)}
    return {w: f.result() for w, f in futs.items()}


WORLDS = [2, 4]


def _concat(shards) -> dict:
    return {c: np.concatenate([s[c] for s in shards]) for c in shards[0]}


def _jax_frame(cols) -> JDataFrame:
    return JDataFrame({k: (jax_object_column(list(v)) if v.dtype == object
                           else v) for k, v in cols.items()})


def _same_on_every_rank(ranks, pick):
    first = pick(ranks[0])
    for r in ranks[1:]:
        _assert_same(pick(r), first)
    return first


def _assert_same(a, b):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not (
            len(a) and isinstance(a[0], float)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_same(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _stats(groups, world, regime):
    """The rank-0 statistics, after checking every rank holds the same
    (but the featurized width, which only ranks with rows can read)."""
    return _same_on_every_rank(groups[world], lambda r: {
        k: v for k, v in r["stats"][regime].items() if k != "width"})


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("regime", ["exact", "sampled"])
def test_every_rank_fits_the_same_statistics(groups, world, regime):
    _stats(groups, world, regime)


def test_f2_value_indexer_levels_merge_across_ranks(groups):
    """ROADMAP F2: rank 0 holds 'a', 'b' and rank 1 'c', 'd'; both fit
    the JAX package's fleet-wide dictionary."""
    for r in groups[2]:
        assert r["stats"]["f2"] == ["a", "b", "c", "d"]


@pytest.mark.parametrize("world", WORLDS)
def test_exact_merges_equal_the_jax_fit_of_the_whole_frame(groups, world):
    got = _stats(groups, world, "exact")
    whole = _concat(_stats_shards(world))
    jdf = _jax_frame(whole)
    assert got["levels"] == JValueIndexer().setInputCol("cat") \
        .setOutputCol("i").fit(jdf).getLevels()
    jfm = (JFeaturize().setInputCols(("num0", "cat", "text"))
           .setOutputCol("f").setNumberOfFeatures(16).fit(jdf))
    assert [tuple(p) for p in got["plans"]] == \
        [tuple(p) for p in jfm.getInputPlans()]
    widths = {r["stats"]["exact"]["width"] for r in groups[world]}
    assert widths - {None} == {len(jfm.transform(jdf).col("f")[0])}
    want_w = JClassBalancer().setInputCol("label").setOutputCol("w") \
        .fit(jdf).getWeightTable()
    assert sorted(got["weights"]) == sorted(want_w)
    for k, v in want_w.items():
        np.testing.assert_allclose(got["weights"][k], v, rtol=1e-9)
    want_mean = jds.CleanMissingData().setInputCols(("num0", "num1")) \
        .setCleaningMode("Mean").fit(jdf).getFillValues()
    for c in ("num0", "num1"):
        np.testing.assert_allclose(got["Mean"][c], want_mean[c], rtol=1e-6)
    want_sum = jds.SummarizeData().transform(jdf)
    feats = list(want_sum.col("Feature"))
    assert got["summary"]["Feature"] == feats
    for col in ("Count", "Missing Value Count"):
        np.testing.assert_array_equal(got["summary"][col],
                                      np.asarray(want_sum.col(col)))
    for col in ("Mean", "Min", "Max"):
        np.testing.assert_allclose(got["summary"][col],
                                   np.asarray(want_sum.col(col)),
                                   rtol=1e-6, equal_nan=True)
    want_idf = JTextFeaturizer().setInputCol("text").setOutputCol("t") \
        .setNumFeatures(64).fit(jdf).getIdfWeights()
    np.testing.assert_allclose(got["idf"], np.asarray(want_idf), rtol=1e-6)
    # below the caps the pooled samples are every value: exact too
    want_med = jds.CleanMissingData().setInputCols(("num0", "num1")) \
        .setCleaningMode("Median").fit(jdf).getFillValues()
    assert got["Median"] == want_med
    for col in ("Unique Value Count", "P25", "Median", "P75"):
        np.testing.assert_allclose(got["summary"][col],
                                   np.asarray(want_sum.col(col)),
                                   rtol=1e-12, equal_nan=True)


def _jax_merged(fit, shards):
    """The JAX package's merge of ``fit`` over the per-rank shards, in this
    process: each rank's partials are recorded (its gather answered with
    its own), then every rank's fit merges the recorded list."""
    recorded = []
    orig = (jdp.is_sharded, jdp.allgather_pyobj)
    try:
        jdp.is_sharded = lambda df: True
        jdp.allgather_pyobj = lambda obj: (recorded.append(obj), [obj])[1]
        for s in shards:
            fit(_jax_frame(s))
        jdp.allgather_pyobj = lambda obj: list(recorded)
        return [fit(_jax_frame(s)) for s in shards]
    finally:
        jdp.is_sharded, jdp.allgather_pyobj = orig


@pytest.fixture
def jax_caps():
    """The JAX stages at the shrunk caps, restored afterwards."""
    cls = {"CleanMissingData": jds.CleanMissingData,
           "SummarizeData": jds.SummarizeData}
    old = {(c, a): getattr(cls[c], a) for c, a in CAPS}
    for (c, a), v in CAPS.items():
        setattr(cls[c], a, v)
    yield
    for (c, a), v in old.items():
        setattr(cls[c], a, v)


@pytest.mark.parametrize("world", WORLDS)
def test_sampled_merges_equal_the_jax_merges_of_the_same_partials(
        groups, world, jax_caps):
    got = _stats(groups, world, "sampled")
    shards = _stats_shards(world)
    meds = _jax_merged(lambda df: jds.CleanMissingData().setInputCols(
        ("num0", "num1")).setCleaningMode("Median").fit(df).getFillValues(),
        shards)
    for m in meds:
        assert got["Median"] == m
    sums = _jax_merged(lambda df: jds.SummarizeData().transform(df), shards)
    for s in sums:
        for col in ("Count", "Unique Value Count", "P25", "Median", "P75",
                    "Mean", "Min", "Max", "Standard Deviation"):
            np.testing.assert_array_equal(np.asarray(got["summary"][col]),
                                          np.asarray(s.col(col)),
                                          err_msg=col)
    # the caps truncated: the distinct counts of the float columns are KMV
    # estimates, not the exact counts
    exact = _stats(groups, world, "exact")["summary"]
    assert got["summary"]["Unique Value Count"] != exact["Unique Value Count"]


@pytest.mark.parametrize("world", WORLDS)
def test_mlp_moments_are_the_whole_frame_s(groups, world):
    ranks = groups[world]
    _same_on_every_rank(ranks, lambda r: r["learners"]["mlp_params"])
    mu = _same_on_every_rank(ranks, lambda r: r["learners"]["mu"])
    sd = _same_on_every_rank(ranks, lambda r: r["learners"]["sd"])
    x, y = _learner_rows()
    jdf = JDataFrame({"features": jax_object_column(list(x)), "label": y})
    want = (JMLP().setFeaturesCol("features").setLabelCol("label")
            .setLayers((4,)).setMaxIter(1).setBatchSize(16).fit(jdf))
    np.testing.assert_allclose(mu, np.asarray(want.getFeatureMean()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sd, np.asarray(want.getFeatureScale()),
                               rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_multi_process_search_equals_the_one_process_search(groups, world):
    ranks = groups[world]
    for key in ("best_setting", "best_metric", "results"):
        _same_on_every_rank(ranks, lambda r: r["learners"][key])
    x, y = _learner_rows()
    df = DataFrame({"features": object_column(list(x)), "label": y})
    seen = []
    real = tune._metric_for

    def recording(*a):
        seen.append(real(*a))
        return seen[-1]
    tune._metric_for = recording
    try:
        want = tune.TuneHyperparameters(models=jobs._search_models(),
                                        **SEARCH).fit(df)
    finally:
        tune._metric_for = real
    got = ranks[0]["learners"]
    assert got["best_setting"] == want.getBestSetting()
    assert got["best_metric"] == want.getBestMetric()
    np.testing.assert_array_equal(got["results"], np.asarray(seen))
