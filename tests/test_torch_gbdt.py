"""The port's level-wise GBDT slice against the JAX package's, on the CPU.

Binning, the split search, ``fit_gbdt`` and the LightGBM stages of
``mmlspark_tpu_torch.models.gbdt`` are held against
``mmlspark_tpu.models.gbdt`` on the same numpy-seeded data (a few hundred
rows, maxBin 16, depth <= 3, <= 10 iterations). The port runs with
``device="cpu"``, so its kernels' plain versions do the work; the JAX
package's Pallas histograms run in interpret mode.

Tolerances: binning and split choices are integers and are held exactly;
the trees' feature and threshold arrays exactly; leaves and scores within
1e-5 (float32 sums in another order, e.g. the gradient sigmoid and the
one-hot leaf sums). The quantized predict (bf16 leaves) within 1e-3 of the
largest raw score, the JAX package's own bar (tests/test_gbdt.py:881-901),
with argmax exact.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxDataFrame
from mmlspark_tpu.models.gbdt import engine as jeng
from mmlspark_tpu.models.gbdt import stages as jstages
from mmlspark_tpu_torch.core import serialize
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.models.gbdt import engine as teng
from mmlspark_tpu_torch.models.gbdt import stages as tstages


def _data(seed=0, n=240, d=5, kind="binary"):
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


def _edges_case(seed=0, n=500, d=6):
    """Rows with NaNs, values tied with an edge, a constant column, +-inf
    and a categorical column of small codes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[::11, 2] = np.nan
    x[:, 4] = 1.5
    x[::13, 0] = np.inf
    x[::17, 0] = -np.inf
    x[:, 5] = np.round(np.abs(x[:, 5]) * 9)
    edges = jeng.compute_bin_edges(x, 16)
    x[::7, 3] = edges[3, 4]
    cat = np.zeros(d, bool)
    cat[5] = True
    return x, edges, cat


def test_bin_edges_and_host_binning_match_jax():
    x, edges, cat = _edges_case()
    np.testing.assert_array_equal(teng.compute_bin_edges(x, 16),
                                  jeng.compute_bin_edges(x, 16))
    for c in (None, cat):
        np.testing.assert_array_equal(teng.bin_data(x, edges, c, 16),
                                      jeng.bin_data(x, edges, c, 16))


@pytest.mark.parametrize("slab", [128, 1 << 20])
def test_device_binning_matches_jax_bit_for_bit(slab):
    """torch.searchsorted binning (side='left', NaN -> 0, categorical
    identity), in slabs that split the rows unevenly or not at all."""
    x, edges, cat = _edges_case(seed=1)
    got = teng.bin_data_device(x, edges, cat, 16, device="cpu", slab=slab)
    assert got.dtype == torch.uint8 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), jeng.bin_data(x, edges, cat,
                                                             16))


@pytest.mark.parametrize("mode", ["host", "device", "auto"])
def test_bin_data_auto_modes_agree(monkeypatch, mode):
    x, edges, _ = _edges_case(seed=2)
    monkeypatch.setenv("MMLTPU_GBDT_BINNING", mode)
    got = teng.bin_data_auto(x, edges, None, 16, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  jeng.bin_data(x, edges, None, 16))


def _split_case(case):
    rng = np.random.default_rng(3)
    hg = rng.normal(size=(4, 3, 8)).astype(np.float32)
    hh = rng.random(size=(4, 3, 8)).astype(np.float32)
    hg[:, :, :2] = 0.0          # empty leading bins: 0/0 at lambda_l2 = 0
    hh[:, :, :2] = 0.0
    mask = np.ones(3, np.float32)
    kw = dict(lambda_l2=1.0, lambda_l1=0.0, min_child_weight=1e-3)
    if case == "all_inf":
        mask[:] = 0.0
    elif case == "l2_zero":
        kw.update(lambda_l2=0.0)
    elif case == "l2_zero_nan":
        kw.update(lambda_l2=0.0, min_child_weight=0.0)
    elif case == "l1":
        kw.update(lambda_l1=0.2)
    elif case == "masked":
        mask[1] = 0.0
    return hg, hh, mask, kw


@pytest.mark.parametrize("case", ["plain", "all_inf", "l2_zero",
                                  "l2_zero_nan", "l1", "masked"])
def test_best_splits_match_jax(case):
    """Ties and NaN gains take the first index in both argmaxes; a node
    with no valid split gets -inf at index 0."""
    import jax.numpy as jnp
    hg, hh, mask, kw = _split_case(case)
    jg, jf, jb = jeng._best_splits(jnp.asarray(hg), jnp.asarray(hh),
                                   jnp.asarray(mask), 8, **kw)
    tg, tf, tb = teng._best_splits(torch.from_numpy(hg), torch.from_numpy(hh),
                                   torch.from_numpy(mask), 8, **kw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               equal_nan=True)
    if case == "all_inf":
        assert (tf.numpy() == 0).all() and (tb.numpy() == 0).all()
        assert np.isneginf(tg.numpy()).all()


_BASE = dict(num_iterations=5, max_depth=3, max_bin=16)
# The objectives and sampling modes run the segment histograms (the
# JAX package sums them row by row on the CPU, as its compare path does
# not); each histogram backend runs on binary.
FIT_CASES = {
    "binary": ("binary", dict(objective="binary")),
    "multiclass": ("multiclass", dict(objective="multiclass", num_class=3,
                                      hist_impl="segment")),
    "regression": ("regression", dict(objective="regression",
                                      hist_impl="segment")),
    # quantile gradients take two values whatever raw is, so their gains
    # tie exactly unless the rows carry distinct weights
    "quantile": ("regression", dict(objective="quantile", alpha=0.8,
                                    hist_impl="segment"), "weighted"),
    "mae": ("regression", dict(objective="mae", hist_impl="segment")),
    "bagging_feature_fraction": ("binary", dict(
        objective="binary", bagging_fraction=0.7, bagging_freq=2,
        feature_fraction=0.6, num_iterations=6, hist_impl="segment")),
    "early_stopping": ("binary", dict(
        objective="binary", early_stopping_round=2, num_iterations=10,
        learning_rate=0.5, hist_impl="segment")),
    # rf keeps raw at the base score, so binary gradients would take two
    # values: regression keeps them distinct
    "rf": ("regression", dict(objective="regression", boosting_type="rf",
                              bagging_fraction=0.6, bagging_freq=1,
                              feature_fraction=0.8, hist_impl="segment")),
    "hist_segment": ("binary", dict(objective="binary",
                                    hist_impl="segment")),
    "hist_compare": ("binary", dict(objective="binary",
                                    hist_impl="compare")),
    "hist_mxu": ("binary", dict(objective="binary", hist_impl="mxu")),
    "hist_pallas": ("binary", dict(objective="binary", hist_impl="pallas")),
}


def _same_ensembles(t, j):
    np.testing.assert_array_equal(t.feature.numpy(), np.asarray(j.feature))
    np.testing.assert_array_equal(t.threshold.numpy(),
                                  np.asarray(j.threshold))
    np.testing.assert_allclose(t.leaf.numpy(), np.asarray(j.leaf), atol=1e-5)
    np.testing.assert_array_equal(t.bin_edges, j.bin_edges)
    np.testing.assert_array_equal(t.base, j.base)


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_gbdt_grows_the_jax_trees(name):
    """test_pallas_kernels.py:92 and :218 for every histogram backend, and
    each objective and sampling mode: identical split features and
    thresholds, leaves within 1e-5, the same number of trees (early
    stopping's best_iter)."""
    kind, kw, *weighted = FIT_CASES[name]
    x, y = _data(kind=kind)
    w = (np.random.default_rng(9).uniform(0.5, 1.5, len(x)).astype(
        np.float32) if weighted else None)
    params = dict(_BASE, **kw)
    j = jeng.fit_gbdt(x, y, jeng.GBDTParams(**params), sample_weight=w)
    t = teng.fit_gbdt(x, y, teng.GBDTParams(**params), sample_weight=w,
                      device="cpu")
    _same_ensembles(t, j)
    np.testing.assert_allclose(
        teng.predict_raw(t, x, predict_impl="dense"),
        jeng.predict_raw(j, x, predict_impl="dense"), atol=1e-5)


def test_sample_weight_and_binned_fits_match_jax():
    x, y = _data(seed=4)
    w = np.ones(len(x), np.float32)
    w[::5] = 0.0
    p = dict(_BASE, objective="binary")
    j = jeng.fit_gbdt(x, y, jeng.GBDTParams(**p), sample_weight=w)
    t = teng.fit_gbdt(x, y, teng.GBDTParams(**p), sample_weight=w,
                      device="cpu")
    _same_ensembles(t, j)
    edges = jeng.compute_bin_edges(x, 16)
    bins = jeng.bin_data(x, edges, None, 16)
    jb = jeng.fit_gbdt(None, y, jeng.GBDTParams(**p), binned=(bins, edges))
    tb = teng.fit_gbdt(None, y, teng.GBDTParams(**p), binned=(bins, edges),
                       device="cpu")
    _same_ensembles(tb, jb)


def _vec_df(x, y, cls):
    feats = np.empty(len(x), dtype=object)
    for i in range(len(x)):
        feats[i] = x[i]
    return cls({"features": feats, "label": y})


STAGE_CASES = {
    "binary": ("LightGBMClassifier", "binary", {}),
    "multiclass": ("LightGBMClassifier", "multiclass", {}),
    "regression": ("LightGBMRegressor", "regression", {}),
    "quantile": ("LightGBMRegressor", "regression",
                 {"application": "quantile", "alpha": 0.7}),
}


def _stage_pair(name, **extra):
    cls_name, kind, kw = STAGE_CASES[name]
    params = dict(growthPolicy="depthwise", numIterations=5, maxBin=16,
                  maxDepth=3, **kw)
    params.update(extra)
    return (getattr(jstages, cls_name)(**params),
            getattr(tstages, cls_name)(device="cpu", **params), kind)


@pytest.mark.parametrize("name", sorted(STAGE_CASES))
def test_stage_fit_transform_matches_jax(name):
    jst, tst, kind = _stage_pair(name)
    x, y = _data(seed=5, kind=kind)
    jout = jst.fit(_vec_df(x, y, JaxDataFrame)).transform(
        _vec_df(x, y, JaxDataFrame))
    tmodel = tst.fit(_vec_df(x, y, DataFrame))
    assert tmodel.getDevice() == "cpu"
    tout = tmodel.transform(_vec_df(x, y, DataFrame))
    assert tout.columns == jout.columns
    for col in tout.columns:
        a, b = tout.col(col), jout.col(col)
        if col in ("features", "label"):
            continue
        if a.dtype == object:
            a, b = np.stack(list(a)), np.stack(list(b))
        np.testing.assert_allclose(a, b, atol=1e-5)
        assert tout.metadata(col) == jout.metadata(col)


def _walk_quantized(ens, x, leaf_dtype):
    """The JAX package's quantized predict, computed in numpy: its
    quantize_ensemble tables walked by heap descent, tree by tree from 0,
    plus the base (what gbdt_predict_quant_levelwise computes; the Pallas
    kernel itself raises on this jax, which lost ``pl.load``)."""
    feat, thr, leaf = jeng.quantize_ensemble(ens, leaf_dtype=leaf_dtype)
    leaf = np.asarray(jeng.dequant_leaf(leaf), np.float32)
    bins = jeng.bin_data(x, ens.bin_edges)
    T, K, _ = feat.shape
    depth = int(np.log2(leaf.shape[2]))
    out = np.zeros((len(x), K), np.float32)
    rows = np.arange(len(x))
    for t in range(T):
        for k in range(K):
            pos = np.zeros(len(x), np.int64)
            for level in range(depth):
                node = 2 ** level - 1 + pos
                right = bins[rows, feat[t, k, node]].astype(np.int64) \
                    > thr[t, k, node]
                pos = pos * 2 + right
            out[:, k] += leaf[t, k][pos]
    return out + np.asarray(ens.base, np.float32)[None, :]


@pytest.mark.parametrize("impl", ["dense", "pallas", "pallas_int8"])
@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_jax_booster_state_scores_the_same(name, impl):
    """A JAX-fitted boosterState, taken as it is, gives the JAX transform
    in the port: under "dense" the JAX stage's raw scores, under the
    quantized impls the JAX package's quantized tables walked; raw within
    1e-3 of the largest score (1e-5 dense), argmax exact."""
    jst, _, kind = _stage_pair(name, numIterations=10, maxDepth=4)
    x, y = _data(seed=6, n=600, kind=kind)
    jmodel = jst.fit(_vec_df(x, y, JaxDataFrame))
    if impl == "dense":
        ref = np.stack(list(jmodel.transform(_vec_df(x, y, JaxDataFrame))
                            .col("rawPrediction")))
    else:
        ref = _walk_quantized(jmodel._ensemble(), x,
                              "int8" if impl == "pallas_int8" else "bf16")
    tmodel = tstages.LightGBMClassificationModel(
        boosterState=jmodel.getBoosterState(),
        objective=jmodel.getObjective(), predictImpl=impl, device="cpu")
    got = tmodel.transform(_vec_df(x, y, DataFrame))
    raw = np.stack(list(got.col("rawPrediction")))
    tol = 1e-5 if impl == "dense" else 1e-3
    assert np.abs(raw - ref).max() <= tol * np.abs(ref).max()
    want = (ref.argmax(1) if ref.shape[1] > 1 else (ref[:, 0] > 0))
    np.testing.assert_array_equal(np.asarray(got.col("prediction")),
                                  want.astype(np.float64))
    np.testing.assert_array_equal(tmodel.featureImportances(8),
                                  jmodel.featureImportances(8))


def test_save_load_round_trips(tmp_path):
    _, tst, kind = _stage_pair("multiclass")
    x, y = _data(seed=7, kind=kind)
    model = tst.fit(_vec_df(x, y, DataFrame))
    model.save(str(tmp_path / "lgbm"))
    loaded = serialize.load_stage(str(tmp_path / "lgbm"))
    assert type(loaded) is tstages.LightGBMClassificationModel
    assert loaded.getDevice() == "cpu"
    for k, v in model.getBoosterState().items():
        np.testing.assert_array_equal(loaded.getBoosterState()[k], v)
    a = model.transform(_vec_df(x, y, DataFrame))
    b = loaded.transform(_vec_df(x, y, DataFrame))
    np.testing.assert_array_equal(np.stack(list(a.col("probability"))),
                                  np.stack(list(b.col("probability"))))


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y = _data()
    with pytest.raises(RuntimeError, match="CUDA"):
        tstages.LightGBMClassifier(growthPolicy="depthwise",
                                   numIterations=2).fit(
            _vec_df(x, y, DataFrame))
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.fit_gbdt(x, y, teng.GBDTParams(num_iterations=1))
    _, tst, _ = _stage_pair("binary")
    model = tst.fit(_vec_df(x, y, DataFrame)).setDevice("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.transform(_vec_df(x, y, DataFrame))


def test_leafwise_requests_raise_naming_slice_4():
    x, y = _data()
    df = _vec_df(x, y, DataFrame)
    for stage in (tstages.LightGBMClassifier(device="cpu"),   # auto, small n
                  tstages.LightGBMRegressor(device="cpu").setNumLeaves(7),
                  tstages.LightGBMClassifier(device="cpu",
                                             growthPolicy="leafwise")):
        with pytest.raises(NotImplementedError, match="slice 4"):
            stage.fit(df)
    with pytest.raises(NotImplementedError, match="slice 4"):
        teng.fit_gbdt(x, y, teng.GBDTParams(num_leaves=7), device="cpu")
    with pytest.raises(NotImplementedError, match="slice 4"):
        tstages.LightGBMClassificationModel(
            boosterState={"kind": "leafwise"}, device="cpu").transform(df)


def test_unported_paths_raise_naming_their_roadmap_items():
    x, y = _data()
    p = teng.GBDTParams(num_iterations=1)
    with pytest.raises(NotImplementedError, match="item 12"):
        teng.fit_gbdt(x, y, p, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        teng.fit_gbdt_elastic(x, y, p, checkpoint_dir="unused")
    with pytest.raises(NotImplementedError, match="item 11"):
        teng.traced_raw_levelwise({}, x, 3, 1)
    with pytest.raises(NotImplementedError, match="item 13"):
        tstages.LightGBMClassifier(
            device="cpu", growthPolicy="depthwise",
            elasticConfig={"checkpointDir": "unused"}).fit(
                _vec_df(x, y, DataFrame))


def test_predict_impl_resolution_and_eligibility():
    """'auto' takes the kernel only on CUDA and for an eligible ensemble;
    an explicit 'pallas' on a too-deep ensemble raises, as in JAX."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert teng._resolve_predict_impl("auto", True, "", cuda) == "pallas"
    assert teng._resolve_predict_impl("auto", True, "", cpu) == "dense"
    assert teng._resolve_predict_impl("auto", False, "deep", cuda) == "dense"
    x, y = _data()
    deep = teng.fit_gbdt(x, y, teng.GBDTParams(num_iterations=1, max_depth=8,
                                               max_bin=16), device="cpu")
    with pytest.raises(ValueError, match="unroll cap"):
        teng.predict_raw(deep, x, predict_impl="pallas")
    with pytest.raises(ValueError, match="auto|dense|pallas"):
        teng.predict_raw(deep, x, predict_impl="quantum")


def test_quantize_ensemble_matches_jax():
    import jax.numpy as jnp
    x, y = _data(seed=8)
    j = jeng.fit_gbdt(x, y, jeng.GBDTParams(**_BASE))
    t = teng.fit_gbdt(x, y, teng.GBDTParams(**_BASE), device="cpu")
    jf, jt, jl = jeng.quantize_ensemble(j)
    tf, tt, tl = teng.quantize_ensemble(t)
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(tt.numpy(), jt)
    assert (tt.numpy() <= 255).all() and tl.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)), atol=1e-5)
    jq, js = jeng.quantize_leaves_int8(np.asarray(j.leaf))
    tq, ts = teng.quantize_leaves_int8(t.leaf.numpy())
    # the leaves agree within float32 sums of another order: a scale within
    # the same, a code within one step of the rounding
    np.testing.assert_allclose(tq, jq, atol=1)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    np.testing.assert_array_equal(teng.quantize_leaves_int8(
        np.asarray(j.leaf))[0], jq)


def test_auto_histograms_on_cpu_take_the_compare_path(monkeypatch):
    """hist_impl='auto' is the compare hybrid on the CPU (the kernel on
    CUDA), and 'segment' never routes elsewhere."""
    from mmlspark_tpu_torch.ops import gbdt_kernels as gk
    calls = {"compare": 0, "node": 0}
    orig_cr, orig_node = gk.compare_reduce_histogram, gk.mxu_node_histogram

    def spy_cr(*a, **k):
        calls["compare"] += 1
        return orig_cr(*a, **k)

    def spy_node(*a, **k):
        calls["node"] += 1
        return orig_node(*a, **k)
    monkeypatch.setattr(gk, "compare_reduce_histogram", spy_cr)
    monkeypatch.setattr(gk, "mxu_node_histogram", spy_node)
    x, y = _data()
    teng.fit_gbdt(x, y, teng.GBDTParams(num_iterations=2, max_depth=2,
                                        max_bin=15, hist_impl="segment"),
                  device="cpu")
    assert calls == {"compare": 0, "node": 0}
    teng.fit_gbdt(x, y, teng.GBDTParams(num_iterations=2, max_depth=2,
                                        max_bin=15), device="cpu")
    assert calls["compare"] >= 1 and calls["node"] == 0
