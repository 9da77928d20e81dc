"""Distributed GBDT fits of the port against its serial fits and the JAX
package's.

Every multi-rank fit runs in a gloo group of separate processes
(``tests/torch_dist_workers.py``, the jobs in ``torch_sharded_jobs.py``):
groups of 1, 2, 3 (uneven shards, as ``test_three_process_gbdt_fit``) and
4 ranks call ``fit_gbdt(mesh=create_mesh())`` on their rows:

* level-wise ``tree_learner="data"`` (each rank its own rows; histograms
  and leaf sums all-reduced) and ``"feature"`` (every rank every row, 10
  features over 4 ranks padded to 12), binary and multiclass;
* leaf-wise ``"data"`` with a categorical feature;
* early stopping and bagging (per-row draws from ``seed + rank``).

Held to: every rank's ensemble is the same bits; the one-rank group's fit
is bit-equal to the no-group fit; predictions agree with the port's serial
fit and the JAX package's fit of the same rows within the JAX tests' own
tolerances (``tests/test_gbdt.py``: atol 1e-3 level-wise, rtol 1e-4 and
atol 1e-5 leaf-wise), and one data-parallel case also with the JAX fit on
the conftest's 8-device CPU mesh. The 2-rank group also runs the
LightGBM stages over a sharded frame: the stage's mesh choice, the
feature_parallel refusal, a fit against the serial stage fit, and the
wide-sparse EFB plan (the same on every rank, ``tests/test_dataplane.py``).
"""

import functools

import numpy as np
import pytest
import torch
from sklearn.datasets import make_classification
from sklearn.metrics import roc_auc_score

from mmlspark_tpu.models.gbdt import engine as jeng
from mmlspark_tpu.parallel import create_mesh as jax_create_mesh
from mmlspark_tpu_torch import telemetry
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.models.gbdt import engine as teng
from mmlspark_tpu_torch.models.gbdt import stages as tstages
from mmlspark_tpu_torch.parallel import mesh as tmesh

from torch_dist_workers import run_ranks_async

JOB = "torch_sharded_jobs:gbdt_job"
LEVEL_TOL = dict(atol=1e-3, rtol=0)
LEAF_TOL = dict(rtol=1e-4, atol=1e-5)


def _binary():
    x, y = make_classification(n_samples=512, n_features=8, random_state=3)
    return x.astype(np.float32), y.astype(np.float32)


def _multiclass():
    x, y = make_classification(n_samples=384, n_features=10,
                               n_informative=6, n_classes=3, random_state=5)
    return x.astype(np.float32), y.astype(np.float32)


def _leafwise():
    """tests/test_gbdt.py's heterogeneously detailed target, with an
    integer-coded categorical column."""
    rng = np.random.default_rng(2)
    x = rng.random((1200, 4)).astype(np.float32)
    x0 = x[:, 0]
    y = np.where(x0 < 0.75, np.floor(x0 * 4) * 2.0,
                 np.floor((x0 - 0.75) * 64) * 0.9)
    y = (y + rng.normal(size=len(x)) * 0.05).astype(np.float32)
    x[:, 3] = np.random.default_rng(3).integers(0, 9, len(x))
    return x, y


def _es():
    x, y = make_classification(n_samples=300, n_features=6, random_state=1)
    return x.astype(np.float32), y.astype(np.float32)


def _bag():
    x, y = make_classification(n_samples=400, n_features=10, random_state=2)
    return x.astype(np.float32), y.astype(np.float32)


DATA = {"binary": _binary, "multiclass": _multiclass, "leafwise": _leafwise,
        "es": _es, "bag": _bag}
PARAMS = {
    "binary": dict(num_iterations=10, max_depth=3, max_bin=31),
    "multiclass": dict(num_iterations=8, max_depth=3, max_bin=31,
                       objective="multiclass", num_class=3),
    "leafwise": dict(num_iterations=10, num_leaves=10, max_depth=0,
                     objective="regression", categorical_feature=(3,)),
    "es": dict(num_iterations=40, early_stopping_round=5, max_depth=3,
               max_bin=31),
    "bag": dict(num_iterations=10, bagging_fraction=0.7, bagging_freq=1,
                feature_fraction=0.6, max_depth=3, max_bin=31),
}
# name -> (data, tree_learner, extra params)
CASES = {
    "data_binary": ("binary", "data", {}),
    "data_binary_mxu": ("binary", "data", {"hist_impl": "mxu"}),
    "data_binary_pallas": ("binary", "data", {"hist_impl": "pallas"}),
    "data_multiclass": ("multiclass", "data", {}),
    "feature_binary": ("binary", "feature", {}),
    "feature_multiclass": ("multiclass", "feature", {}),
    # a padded column's candidates pass every check but the feature mask
    "feature_multiclass_mcw0": ("multiclass", "feature",
                                {"min_child_weight": 0.0,
                                 "min_split_gain": -1.0}),
    "leaf_data": ("leafwise", "data", {}),
    "leaf_data_mxu": ("leafwise", "data", {"hist_impl": "mxu"}),
    "es_data": ("es", "data", {}),
    "bag_data": ("bag", "data", {}),
}
# the cases each group fits (the random ones run wherever a group runs)
GROUPS = {
    1: sorted(CASES),
    2: sorted(CASES),
    3: ["data_binary", "leaf_data", "feature_multiclass"],
    4: ["data_binary", "data_multiclass", "feature_multiclass",
        "feature_multiclass_mcw0", "leaf_data", "es_data", "bag_data"],
}
# uneven shards of a 3-rank group (as the JAX package's three-process fit)
UNEVEN = {"binary": [(0, 100), (100, 270), (270, 512)],
          "leafwise": [(0, 250), (250, 700), (700, 1200)]}


def _rows(n, world, data):
    if world == 3 and data in UNEVEN:
        return UNEVEN[data]
    cuts = np.linspace(0, n, world + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])]


def _fit_spec(name, world):
    data, learner, extra = CASES[name]
    x, y = DATA[data]()
    return {"x": x, "y": y,
            "params": dict(PARAMS[data], tree_learner=learner, **extra),
            "rows": None if learner == "feature" else _rows(len(x), world,
                                                           data),
            "score": x}


def _stage_spec():
    x, y = _binary()
    return {"x": x, "y": y, "rows": [(0, 200), (200, 512)],
            "sparse_seed": 31}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gbdt_sharded")
    futs = {w: run_ranks_async(
        w, JOB, tmp / f"w{w}", timeout=400,
        fits={n: _fit_spec(n, w) for n in names},
        stage=_stage_spec() if w == 2 else None)
        for w, names in GROUPS.items()}
    return {w: f.result() for w, f in futs.items()}


@functools.lru_cache(maxsize=None)
def _serial(name):
    data, _, extra = CASES[name]
    x, y = DATA[data]()
    p = teng.GBDTParams(**dict(PARAMS[data], tree_learner="serial", **extra))
    return teng.fit_gbdt(x, y, p, device="cpu"), x


@functools.lru_cache(maxsize=None)
def _jax_serial(name):
    data, _, extra = CASES[name]
    x, y = DATA[data]()
    # hist_impl picks the port's kernel, not the model
    extra = {k: v for k, v in extra.items() if k != "hist_impl"}
    p = jeng.GBDTParams(**dict(PARAMS[data], tree_learner="serial", **extra))
    return np.asarray(jeng.predict(jeng.fit_gbdt(x, y, p), x))


def _assert_state_equal(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{what}: {k}")


def _tol(name):
    return LEAF_TOL if CASES[name][0] == "leafwise" else LEVEL_TOL


@pytest.mark.parametrize("world,name", [(w, n) for w, ns in GROUPS.items()
                                        for n in ns])
def test_every_rank_grows_the_same_ensemble(groups, world, name):
    ranks = groups[world]
    for r in range(1, world):
        _assert_state_equal(ranks[r][name]["state"], ranks[0][name]["state"],
                            f"{name}: rank {r} vs rank 0")


@pytest.mark.parametrize("name", GROUPS[1])
def test_one_rank_group_is_bit_equal_to_the_no_group_fit(groups, name):
    ens, x = _serial(name)
    got = groups[1][0][name]
    _assert_state_equal(got["state"], tstages._ensemble_to_state(ens), name)
    np.testing.assert_array_equal(
        got["pred"], teng.predict(ens, x, predict_impl="dense",
                                  device="cpu"))


# the random cases draw per-row masks from seed + rank, so with more than
# one rank they are not the serial fit's draws
DETERMINISTIC = [(w, n) for w, ns in GROUPS.items() if w > 1 for n in ns
                 if CASES[n][0] not in ("es", "bag")]


@pytest.mark.parametrize("world,name", DETERMINISTIC)
def test_predictions_match_the_serial_fits(groups, world, name):
    pred = groups[world][0][name]["pred"]
    ens, x = _serial(name)
    np.testing.assert_allclose(
        pred, teng.predict(ens, x, predict_impl="dense", device="cpu"),
        err_msg=f"{name} over {world} ranks vs the port's serial fit",
        **_tol(name))
    np.testing.assert_allclose(
        pred, _jax_serial(name),
        err_msg=f"{name} over {world} ranks vs the JAX serial fit",
        **_tol(name))


def test_data_parallel_matches_the_jax_mesh_fit(groups):
    x, y = _binary()
    p = jeng.GBDTParams(**dict(PARAMS["binary"], tree_learner="data"))
    want = np.asarray(jeng.predict(
        jeng.fit_gbdt(x, y, p, mesh=jax_create_mesh()), x))
    for world in (2, 4):
        np.testing.assert_allclose(groups[world][0]["data_binary"]["pred"],
                                   want, **LEVEL_TOL)


@pytest.mark.parametrize("name", ["feature_multiclass",
                                  "feature_multiclass_mcw0"])
def test_feature_parallel_pads_the_feature_axis(groups, name):
    """10 features over 4 ranks: padded to 12, no padded feature splits,
    and every rank's ensemble names only real features — also with
    min_child_weight=0 and a negative min_split_gain, where a padded
    column's candidates (gain 0) pass every check but the feature mask."""
    st = groups[4][0][name]["state"]
    assert st["bin_edges"].shape[0] == 10
    real = st["threshold"] < st["bin_edges"].shape[1] + 1
    assert st["feature"][real].max() < 10
    ens, x = _serial(name)
    # the slices' candidates are the serial ones: the same bits
    _assert_state_equal(st, tstages._ensemble_to_state(ens),
                        "feature-parallel over 4 ranks vs serial")


@pytest.mark.parametrize("world", [2, 4])
def test_early_stopping_and_bagging_over_ranks(groups, world):
    x, y = _es()
    st = groups[world][0]["es_data"]["state"]
    assert st["feature"].shape[0] < PARAMS["es"]["num_iterations"]
    assert roc_auc_score(y, groups[world][0]["es_data"]["pred"][:, 1]) > 0.9
    x, y = _bag()
    assert roc_auc_score(y, groups[world][0]["bag_data"]["pred"][:, 1]) > 0.9


def test_stage_mesh_selection_follows_the_world_size(groups):
    """tests/test_gbdt.py's TestMeshSelection with the world size in place
    of the device count: a world of one rank fits serially whatever the
    size or the parallelism; a world of more always runs the collective
    program (every rank must choose alike), but inside local_fit_mode."""
    cases = {"default_small": (tstages.LightGBMClassifier(), 300),
             "default_large": (tstages.LightGBMClassifier(), 100_000),
             "explicit_feature_small": (tstages.LightGBMClassifier()
                                        .setParallelism("feature_parallel"),
                                        300),
             "explicit_serial_large": (tstages.LightGBMClassifier()
                                       .setParallelism("serial"), 100_000)}
    assert tmesh.effective_process_count() == 1
    assert all(clf._mesh(n) is None for clf, n in cases.values())
    for rank in groups[2]:
        st = rank["stage"]
        assert st["mesh"] == {k: True for k in cases}
        assert st["mesh_local"] == {k: False for k in cases}
        assert "parallelism=data_parallel" in st["feature_error"]


def test_stage_fit_over_a_sharded_frame(groups):
    ranks = groups[2]
    _assert_state_equal(ranks[1]["stage"]["fit_state"],
                        ranks[0]["stage"]["fit_state"], "stage fit")
    x, y = _binary()
    df = DataFrame({"features": object_column(list(x)), "label": y})
    serial = tstages.LightGBMClassifier(
        device="cpu", numIterations=5, maxBin=31, growthPolicy="depthwise",
        maxDepth=3).fit(df)
    want = np.stack(list(serial.transform(df).col("probability")))
    got = np.concatenate([r["stage"]["fit_prob"] for r in ranks])
    np.testing.assert_allclose(got, want, **LEVEL_TOL)


def test_wide_sparse_plan_is_the_same_on_every_rank(groups):
    ranks = groups[2]
    assert ranks[0]["stage"]["sparse_plan"] == \
        ranks[1]["stage"]["sparse_plan"]
    assert ranks[0]["stage"]["sparse_plan"][1], "no EFB bundle planned"
    _assert_state_equal(ranks[1]["stage"]["sparse_state"],
                        ranks[0]["stage"]["sparse_state"], "sparse fit")


@pytest.mark.parametrize("learner", ["data", "feature"])
def test_sharded_spans_and_a_group_less_mesh(learner):
    """A mesh with no process group runs the sharded builder with no
    collective: the same bits as the serial fit, timed as the sharded
    path's grad/build/apply spans."""
    x, y = _binary()
    p = teng.GBDTParams(**dict(PARAMS["binary"], tree_learner=learner))
    want = teng.fit_gbdt(x, y, p, device="cpu")
    telemetry.enable()
    telemetry.trace.clear()
    try:
        got = teng.fit_gbdt(x, y, p, mesh=tmesh.create_mesh(), device="cpu")
        names = [e["name"] for e in telemetry.trace.events()]
    finally:
        telemetry.disable()
        telemetry.trace.clear()
    _assert_state_equal(tstages._ensemble_to_state(got),
                        tstages._ensemble_to_state(want), learner)
    for span in ("gbdt/iter/grad", "gbdt/iter/build", "gbdt/iter/apply"):
        assert names.count(span) == p.num_iterations, span
    assert "gbdt/iter/step" not in names


def test_sharded_fit_refusals():
    x, y = _binary()
    mesh = tmesh.create_mesh()
    with pytest.raises(ValueError, match="feature"):
        teng.fit_gbdt(x, y, teng.GBDTParams(num_leaves=8,
                                            tree_learner="feature"),
                      mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="data axis"):
        teng.fit_gbdt(x, y, teng.GBDTParams(num_iterations=1),
                      mesh=tmesh.Mesh({"data": 1, "model": 2},
                                      torch.device("cpu")), device="cpu")
