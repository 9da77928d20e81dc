"""The port's leaf-wise GBDT (``leafwise.py``, ``efb.py`` and the leaf-wise
stages) against the JAX package's, on the CPU.

Same numpy-seeded inputs through both packages (300-1500 rows, a 5000-row
predict, maxBin 16-64, <= 31 leaves but one 300-leaf case, <= 6
iterations); the port runs with ``device="cpu"``, so its kernels' plain
versions do the work. JAX fits shared by several tests are made once per
module.

Tolerances: split choices are integers and are held exactly — split_leaf
everywhere; feature, threshold, is_cat and cat_bitset on the rounds that
split (a no-op round records the cached candidate of a retired leaf, picked
among gains that tie at ~0 up to rounding; prediction never reads it).
Leaves and scores within 1e-5 (float32 sums in another order: the port sums
every histogram in float64 and rounds once, the JAX package sums in
float32). Where gradients take few distinct values, gains tie exactly and
the last bit decides, so the engine cases weight their rows. The quantized
predict against a numpy replay of the same tables within 1e-6, and against
the dense scores within the leaf round's own bound (per tree 2^-9 of its
largest leaf for bf16, max/254 for int8).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.models.gbdt import engine as jeng
from mmlspark_tpu.models.gbdt import leafwise as jlw
from mmlspark_tpu.models.gbdt import stages as jstages
from mmlspark_tpu_torch.core import serialize
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.utils import object_column
from mmlspark_tpu_torch.models.gbdt import engine as teng
from mmlspark_tpu_torch.models.gbdt import leafwise as tlw
from mmlspark_tpu_torch.models.gbdt import stages as tstages


def _data(seed=0, n=400, d=5, kind="binary"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    signal = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2]
    if kind == "binary":
        y = (signal + rng.normal(0, 0.3, n) > 0).astype(np.float32)
    elif kind == "multiclass":
        y = np.digitize(signal, [-0.5, 0.5]).astype(np.float32)
    else:
        y = (signal + rng.normal(0, 0.3, n)).astype(np.float32)
    return x, y


def _cat_data(seed=1, n=400):
    """A categorical column whose class set {3, 7, 9} is no interval."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    cat = rng.integers(0, 12, n)
    x[:, 2] = cat
    y = (np.isin(cat, [3, 7, 9]) ^ (rng.random(n) < 0.05)).astype(np.float32)
    return x, y


def _weights(n, seed=9):
    return np.random.default_rng(seed).uniform(0.5, 1.5, n).astype(np.float32)


# ------------------------------------------------------------- candidates

@pytest.mark.parametrize("has_cats", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_candidates_2_match_jax(has_cats, seed):
    """Random (2, d, B) histograms with empty bins (all at ratio 0 in the
    categorical sort, so the sort must be stable), a masked feature and two
    categorical features."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    d, B = 6, 16
    hg = rng.normal(size=(2, d, B)).astype(np.float32)
    hh = rng.random(size=(2, d, B)).astype(np.float32)
    empty = rng.random(size=(2, d, B)) < 0.3
    hg[empty] = 0.0
    hh[empty] = 0.0
    mask = np.ones(d, np.float32)
    mask[4] = 0.0
    cats = np.zeros(d, np.float32)
    cats[[1, 3]] = 1.0
    kw = dict(n_bins=B, l2=1.0, l1=0.1, min_child_weight=1e-3,
              cat_smooth=10.0, has_cats=has_cats)
    jg, jf, jt, jw = jlw._candidates_2(jnp.asarray(hg), jnp.asarray(hh),
                                       jnp.asarray(mask), jnp.asarray(cats),
                                       **kw)
    tg, tf, tt, tw = tlw._candidates_2(torch.from_numpy(hg),
                                       torch.from_numpy(hh),
                                       torch.from_numpy(mask),
                                       torch.from_numpy(cats), **kw)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))


# --------------------------------------------------------------- fitting

def _same_lw(t, j, atol=1e-5):
    """Identical trees: split_leaf, feature, threshold, is_cat and
    cat_bitset everywhere, no-op rounds included; leaves within ``atol``."""
    for name in ("split_leaf", "feature", "threshold", "is_cat"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.cat_bitset.numpy(),
                                  np.asarray(j.cat_bitset).astype(np.int64))
    np.testing.assert_allclose(t.leaf.numpy(), np.asarray(j.leaf), atol=atol)
    np.testing.assert_array_equal(t.bin_edges, j.bin_edges)
    np.testing.assert_array_equal(t.cat_features, j.cat_features)
    np.testing.assert_array_equal(t.base, j.base)


_LW = dict(num_iterations=4, num_leaves=8, max_depth=0, max_bin=16,
           hist_impl="segment")
LW_CASES = {
    "binary_8": ("binary", dict(objective="binary")),
    "binary_31": ("binary", dict(objective="binary", num_leaves=31)),
    "binary_auto_hist": ("binary", dict(objective="binary",
                                        hist_impl="auto")),
    "regression": ("regression", dict(objective="regression")),
    "multiclass": ("multiclass", dict(objective="multiclass", num_class=3)),
    # test_gbdt.py:466: depth 2 allows at most 3 real splits
    "max_depth": ("binary", dict(objective="binary", num_leaves=31,
                                 max_depth=2)),
    # leaves retire below the gain floor: no-op rounds appear
    "min_split_gain": ("binary", dict(objective="binary", num_leaves=31,
                                      min_split_gain=2.0)),
    "categorical": ("categorical", dict(objective="binary", num_leaves=6,
                                        categorical_feature=(2,))),
    "bagging_feature_fraction": ("binary", dict(
        objective="binary", bagging_fraction=0.7, bagging_freq=2,
        feature_fraction=0.6, num_iterations=5)),
    "early_stopping": ("binary", dict(
        objective="binary", early_stopping_round=2, num_iterations=6,
        learning_rate=0.5)),
    "rf": ("regression", dict(objective="regression", boosting_type="rf",
                              bagging_fraction=0.6, bagging_freq=1,
                              feature_fraction=0.8)),
}


def _case_data(kind):
    """1000 rows: 31-leaf trees on a few hundred rows cut leaves of ~5 rows,
    where two features split off the same rows (on mirrored sides) and the
    exactly tied gains break by rounding."""
    if kind == "categorical":
        return _cat_data(n=1000)
    return _data(n=1000, kind=kind)


@pytest.fixture(scope="module")
def jax_fits():
    """Each case's JAX fit, made once (keyed by case name)."""
    fits = {}
    for name, (kind, kw) in LW_CASES.items():
        x, y = _case_data(kind)
        w = _weights(len(x))
        fits[name] = jeng.fit_gbdt(x, y, jeng.GBDTParams(**dict(_LW, **kw)),
                                   sample_weight=w)
    return fits


@pytest.mark.parametrize("name", sorted(LW_CASES))
def test_fit_gbdt_leafwise_grows_the_jax_trees(name, jax_fits):
    kind, kw = LW_CASES[name]
    x, y = _case_data(kind)
    w = _weights(len(x))
    t = teng.fit_gbdt(x, y, teng.GBDTParams(**dict(_LW, **kw)),
                      sample_weight=w, device="cpu")
    j = jax_fits[name]
    assert isinstance(t, tlw.LeafwiseEnsemble)
    _same_lw(t, j)
    np.testing.assert_allclose(
        teng.predict_raw(t, x, predict_impl="dense"),
        jeng.predict_raw(j, x, predict_impl="dense"), atol=1e-5)
    S = t.split_leaf.numpy()
    if name == "max_depth":
        assert ((S >= 0).sum(axis=2) <= 3).all()
    if name == "min_split_gain":
        assert (S < 0).any() and (S >= 0).any()
    if name == "categorical":
        assert t.is_cat.numpy().any()
    if name == "early_stopping":
        assert t.leaf.shape[0] < kw["num_iterations"]


def test_sample_weight_and_binned_leafwise_fits_match_jax():
    """Weight-0 rows neither train nor enter the edges; a binned fit (the
    categorical column identity-binned) grows the raw fit's trees."""
    x, y = _cat_data(seed=2, n=1000)
    w = _weights(len(x), seed=3)
    w[::5] = 0.0
    # leaves of >= ~25 rows: no two features isolate the same few rows
    p = dict(_LW, objective="binary", categorical_feature=(2,),
             min_child_weight=5.0)
    j = jeng.fit_gbdt(x, y, jeng.GBDTParams(**p), sample_weight=w)
    t = teng.fit_gbdt(x, y, teng.GBDTParams(**p), sample_weight=w,
                      device="cpu")
    _same_lw(t, j)
    cat = np.zeros(x.shape[1], bool)
    cat[2] = True
    edges = jeng.compute_bin_edges(x, 16)
    bins = jeng.bin_data(x, edges, cat, 16)
    w = _weights(len(x), seed=3)
    jb = jeng.fit_gbdt(None, y, jeng.GBDTParams(**p), sample_weight=w,
                       binned=(bins, edges))
    tb = teng.fit_gbdt(None, y, teng.GBDTParams(**p), sample_weight=w,
                       binned=(bins, edges), device="cpu")
    _same_lw(tb, jb)


def test_leafwise_validation_matches_jax():
    x, y = _data(n=60)
    for bad in (dict(num_leaves=1 << 13), dict(num_leaves=8,
                                               categorical_feature=(9,)),
                dict(categorical_feature=(1,))):
        with pytest.raises(ValueError):
            jeng.fit_gbdt(x, y, jeng.GBDTParams(**bad))
        with pytest.raises(ValueError):
            teng.fit_gbdt(x, y, teng.GBDTParams(**bad), device="cpu")
    with pytest.raises(ValueError, match="feature"):
        teng.fit_gbdt(x, y, teng.GBDTParams(num_leaves=8,
                                            tree_learner="feature"),
                      device="cpu")


def test_categorical_top_code_warns(caplog):
    x, y = _cat_data(seed=4, n=80)
    x[0, 2] = 40.0
    import logging
    logger = logging.getLogger("mmlspark_tpu_torch.gbdt")
    teng.get_logger("gbdt")
    logger.addHandler(caplog.handler)
    try:
        teng.fit_gbdt(x, y, teng.GBDTParams(
            num_iterations=1, num_leaves=4, max_bin=16,
            categorical_feature=(2,)), device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    assert "alias into one bin" in caplog.text


# --------------------------------------------------------------- predict

def _walk_leafwise(bins, split, feat, thr, leaf):
    """numpy replay of the split sequence (tests/test_pallas_kernels.py:
    313-327)."""
    n = bins.shape[0]
    T, K, R = split.shape
    out = np.zeros((n, K), np.float32)
    for t in range(T):
        for k in range(K):
            pos = np.zeros(n, np.int64)
            for r in range(R):
                right = (pos == split[t, k, r]) & (
                    bins[np.arange(n), feat[t, k, r]].astype(np.int64)
                    > thr[t, k, r])
                pos[right] = r + 1
            out[:, k] += leaf[t, k][pos]
    return out


@pytest.fixture(scope="module")
def jax_multiclass():
    x, y = _data(seed=5, n=500, kind="multiclass")
    p = dict(_LW, objective="multiclass", num_class=3, num_iterations=5,
             num_leaves=12)
    return x, jeng.fit_gbdt(x, y, jeng.GBDTParams(**p),
                            sample_weight=_weights(len(x)))


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8"])
def test_quantized_leafwise_predict_matches_numpy_walk_and_dense(
        impl, jax_multiclass):
    """predict_impl 'pallas' / 'pallas_int8' on the CPU (the kernel's plain
    version) against the numpy replay of the JAX package's quantized tables
    (within 1e-6) and against the JAX dense path (within the leaf round's
    bound; argmax exact where the margin exceeds twice it)."""
    x, j = jax_multiclass
    leaf_dtype = "int8" if impl == "pallas_int8" else "bf16"
    S, F, Th, leaf = jlw.quantize_ensemble_lw(j, leaf_dtype=leaf_dtype)
    leaf = np.asarray(jeng.dequant_leaf(leaf), np.float32)
    bins = jeng.bin_data(x, j.bin_edges, None, j.bin_edges.shape[1] + 1)
    walk = _walk_leafwise(bins, S, F, Th, leaf) + j.base[None, :]
    state = jstages._ensemble_to_state(j)
    t = tstages._state_to_ensemble(state, "multiclass", "cpu")
    got = teng.predict_raw(t, x, predict_impl=impl)
    np.testing.assert_allclose(got, walk, atol=1e-6)
    # the leaf round is the one lossy step: per tree at most 2^-9 of its
    # largest leaf (bf16) or half its int8 step (max/254)
    dense = jeng.predict_raw(j, x, predict_impl="dense")
    per_tree = np.abs(np.asarray(j.leaf)).max(axis=2).sum(axis=0)     # (K,)
    bound = per_tree * (2.0 ** -9 if leaf_dtype == "bf16" else 1 / 254)
    assert (np.abs(got - dense) <= bound[None, :] + 1e-6).all()
    top2 = np.sort(dense, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * bound.max()
    np.testing.assert_array_equal(got.argmax(1)[clear],
                                  dense.argmax(1)[clear])
    ts, tf, tt, _ = tlw.quantize_ensemble_lw(t, leaf_dtype=leaf_dtype)
    np.testing.assert_array_equal(ts.numpy(), S)
    np.testing.assert_array_equal(tf.numpy(), F)
    np.testing.assert_array_equal(tt.numpy(), Th)


def test_quantized_predict_refuses_categorical_ensembles():
    x, y = _cat_data(seed=6, n=120)
    t = teng.fit_gbdt(x, y, teng.GBDTParams(
        num_iterations=2, num_leaves=4, max_bin=16,
        categorical_feature=(2,)), device="cpu")
    with pytest.raises(ValueError, match="categorical"):
        teng.predict_raw(t, x, predict_impl="pallas")
    cuda = torch.device("cuda")
    ok, _ = tlw._quant_eligible_lw(t, has_cats=True)
    assert not ok
    assert teng._resolve_predict_impl("auto", ok, "", cuda) == "dense"


def test_streaming_replay_past_255_splits_matches_jax():
    """test_gbdt.py:801: 300-leaf trees replay without the test table."""
    x, y = _data(seed=7, n=700)
    p = dict(num_iterations=2, num_leaves=300, max_depth=0, max_bin=16,
             hist_impl="segment")
    w = _weights(len(x))
    j = jeng.fit_gbdt(x, y, jeng.GBDTParams(**p), sample_weight=w)
    t = teng.fit_gbdt(x, y, teng.GBDTParams(**p), sample_weight=w,
                      device="cpu")
    assert t.split_leaf.shape[2] > tlw._TEST_TABLE_MAX_SPLITS
    raw = teng.predict_raw(t, x, predict_impl="dense")
    np.testing.assert_allclose(
        raw, jeng.predict_raw(j, x, predict_impl="dense"), atol=1e-5)
    # the streaming replay and the test-table replay agree tree by tree
    bins_t = teng.bin_data_auto(x, t.bin_edges, device="cpu").T.contiguous()
    args = [a[0, 0] for a in (t.split_leaf, t.feature, t.threshold,
                              t.cat_bitset, t.is_cat, t.leaf)]
    np.testing.assert_array_equal(
        tlw._replay_lw_streaming(bins_t, *args).numpy(),
        tlw._replay_lw(tlw._tree_tests_lw(bins_t, *args[1:5]), args[0],
                       args[5]).numpy())


def test_row_batched_leafwise_predict_matches(monkeypatch):
    """test_gbdt.py:823: scoring in 4096-row chunks equals one chunk."""
    x, y = _cat_data(seed=8, n=5000)
    t = teng.fit_gbdt(x, y, teng.GBDTParams(
        num_iterations=3, num_leaves=15, max_bin=16,
        categorical_feature=(2,)), device="cpu")
    whole = teng.predict_raw(t, x)
    monkeypatch.setattr(teng, "_PREDICT_TABLE_BYTES_CAP", 1)
    np.testing.assert_array_equal(teng.predict_raw(t, x), whole)


# ---------------------------------------------------------------- stages

def _vec_df(x, y, cls):
    return cls({"features": object_column(list(x)), "label": y})


def _raw_or_pred(df):
    col = "rawPrediction" if "rawPrediction" in df.columns else "prediction"
    a = df.col(col)
    return np.stack(list(a)) if a.dtype == object else np.asarray(a)


@pytest.mark.parametrize("cls_name,kind", [("LightGBMClassifier", "binary"),
                                           ("LightGBMRegressor",
                                            "regression")])
def test_default_params_fit_leafwise_and_match_jax(cls_name, kind):
    """Default Params below 262144 rows grow 31-leaf best-first trees in
    both packages; the transforms agree within 1e-5."""
    x, y = _data(seed=10, n=600, kind=kind)
    jst = getattr(jstages, cls_name)(numIterations=4, maxBin=16)
    tst = getattr(tstages, cls_name)(numIterations=4, maxBin=16,
                                     device="cpu")
    p = tst._engine_params(kind, 1, n_rows=len(x))
    assert p.num_leaves == 31 and p.max_depth == 0
    jm = jst.fit(_vec_df(x, y, JaxDataFrame))
    tm = tst.fit(_vec_df(x, y, DataFrame))
    state = tm.getBoosterState()
    assert state["kind"] == "leafwise" and state["split_leaf"].shape[2] == 30
    jout = jm.transform(_vec_df(x, y, JaxDataFrame))
    tout = tm.transform(_vec_df(x, y, DataFrame))
    assert tout.columns == jout.columns
    np.testing.assert_allclose(_raw_or_pred(tout), _raw_or_pred(jout),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(tout.col("prediction"))
                                  if kind == "binary" else 0,
                                  np.asarray(jout.col("prediction"))
                                  if kind == "binary" else 0)


def _categorical_df(cls):
    """test_gbdt.py:482: a numeric and a categorical column assembled with
    categorical levels, so the stage finds the categorical slot itself."""
    rng = np.random.default_rng(11)
    n = 600
    a = rng.normal(size=n).astype(np.float32)
    cat = rng.integers(0, 12, n).astype(np.float32)
    y = (np.isin(cat, [2, 7, 9]) ^ (rng.random(n) < 0.05)).astype(np.float64)
    x = np.stack([a, cat], axis=1)
    df = cls({"features": object_column(list(x)), "label": y})
    meta = {"mml": {"assembled": {"slots": {
        "a": {"start": 0, "width": 1, "categorical": None},
        "c": {"start": 1, "width": 1, "categorical": list(range(12))}}}}}
    return df.withColumn("features", df.col("features"), metadata=meta), y


def test_categorical_slots_autodetected_and_match_jax():
    tdf, y = _categorical_df(DataFrame)
    jdf, _ = _categorical_df(JaxDataFrame)
    assert tstages._categorical_slots(tdf, "features", (), None) == (1,)
    kw = dict(numIterations=5, numLeaves=6, maxBin=16)
    tm = tstages.LightGBMClassifier(device="cpu", **kw).fit(tdf)
    jm = jstages.LightGBMClassifier(**kw).fit(jdf)
    ts_, js_ = tm.getBoosterState(), jm.getBoosterState()
    assert ts_["cat_features"][1] and ts_["is_cat"].any()
    np.testing.assert_array_equal(ts_["cat_features"], js_["cat_features"])
    prob = np.stack(list(tm.transform(tdf).col("probability")))
    ref = np.stack(list(jm.transform(jdf).col("probability")))
    np.testing.assert_allclose(prob, ref, atol=1e-5)
    assert ((prob[:, 1] > 0.5) == y).mean() > 0.9


@pytest.fixture(scope="module")
def jax_leafwise_model():
    x, y = _cat_data(seed=12, n=500)
    tdf = _vec_df(x, y, JaxDataFrame)
    return x, y, jstages.LightGBMClassifier(
        numIterations=6, numLeaves=10, maxBin=16,
        categoricalSlotIndexes=[2]).fit(tdf)


@pytest.mark.parametrize("impl", ["auto", "dense"])
def test_jax_leafwise_booster_state_scores_the_same(impl, jax_leafwise_model):
    """A JAX-fitted leaf-wise boosterState (uint32 bitsets) taken as it is:
    the same raw scores within 1e-5, labels and importances exact."""
    x, y, jm = jax_leafwise_model
    state = jm.getBoosterState()
    assert state["kind"] == "leafwise"
    assert np.asarray(state["cat_bitset"]).dtype == np.uint32
    tm = tstages.LightGBMClassificationModel(
        boosterState=state, objective=jm.getObjective(), predictImpl=impl,
        device="cpu")
    got = tm.transform(_vec_df(x, y, DataFrame))
    ref = jm.transform(_vec_df(x, y, JaxDataFrame))
    np.testing.assert_allclose(_raw_or_pred(got), _raw_or_pred(ref),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.col("prediction")),
                                  np.asarray(ref.col("prediction")))
    np.testing.assert_array_equal(tm.featureImportances(6),
                                  jm.featureImportances(6))
    # and the port's state of that ensemble is the JAX state again
    back = tstages._ensemble_to_state(tm._ensemble())
    for k, v in state.items():
        assert np.asarray(back[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v)


def test_leafwise_save_load_round_trips(tmp_path):
    x, y = _cat_data(seed=13, n=300)
    model = tstages.LightGBMClassifier(
        numIterations=3, numLeaves=8, maxBin=16, categoricalSlotIndexes=[2],
        device="cpu").fit(_vec_df(x, y, DataFrame))
    model.save(str(tmp_path / "lgbm_lw"))
    loaded = serialize.load_stage(str(tmp_path / "lgbm_lw"))
    assert loaded.getBoosterState()["kind"] == "leafwise"
    for k, v in model.getBoosterState().items():
        np.testing.assert_array_equal(loaded.getBoosterState()[k], v)
    a = model.transform(_vec_df(x, y, DataFrame))
    b = loaded.transform(_vec_df(x, y, DataFrame))
    np.testing.assert_array_equal(np.stack(list(a.col("probability"))),
                                  np.stack(list(b.col("probability"))))


def _sparse_df(cls, seed=14, n=1500, d=4096):
    """bench_efb.py's shape at a small size: zipf(1.3) hashed tokens, 8 per
    row, plus one signal token of four; the label is the token's parity."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 8)
    cols = np.minimum(d - 1, rng.zipf(1.3, size=n * 8) - 1)
    sig = np.array([500, 900, 1400, 2000])
    pick = rng.integers(0, len(sig), n)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, sig[pick]])
    x = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                      shape=(n, d))
    y = (pick % 2).astype(np.float64)
    return cls({"features": object_column(list(x)), "label": y}), y


def test_efb_fit_matches_jax():
    """A wide sparse fit below 262144 rows bundles its tail (leaf-wise via
    auto): the same dense columns, bundles, trees, importances and
    scores as the JAX stage's."""
    kw = dict(numIterations=3, maxDenseFeatures=32, maxBin=64, numLeaves=8)
    tdf, y = _sparse_df(DataFrame)
    jdf, _ = _sparse_df(JaxDataFrame)
    tm = tstages.LightGBMClassifier(device="cpu", **kw).fit(tdf)
    jm = jstages.LightGBMClassifier(**kw).fit(jdf)
    np.testing.assert_array_equal(tm.getFeatureSelection(),
                                  jm.getFeatureSelection())
    tb, jb = tm.getFeatureBundles(), jm.getFeatureBundles()
    assert len(tb) == len(jb) > 0
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    ts_, js_ = tm.getBoosterState(), jm.getBoosterState()
    assert ts_["cat_features"][32:].all() and not ts_["cat_features"][:32].any()
    np.testing.assert_array_equal(ts_["split_leaf"], js_["split_leaf"])
    np.testing.assert_array_equal(ts_["is_cat"], js_["is_cat"])
    # the signal token separates the labels after two splits, so the
    # remaining rounds are no-ops; each records the best candidate among
    # gains that tie near 0, which float64 (port) and float32 (JAX) sums
    # break differently. Prediction never reads a no-op round.
    real = js_["split_leaf"] >= 0
    for k in ("feature", "threshold", "cat_bitset"):
        np.testing.assert_array_equal(ts_[k][real], js_[k][real])
    np.testing.assert_allclose(ts_["leaf"], js_["leaf"], atol=1e-5)
    np.testing.assert_array_equal(tm.featureImportances(),
                                  jm.featureImportances())
    raw = np.stack(list(tm.transform(tdf).col("rawPrediction")))
    ref = np.stack(list(jm.transform(jdf).col("rawPrediction")))
    np.testing.assert_allclose(raw, ref, atol=1e-5)
    assert ((raw[:, 0] > 0) == y).mean() > 0.95
