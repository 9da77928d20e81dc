"""The port's GBDT kernels' plain versions against the JAX package's.

``ops/gbdt_kernels.py`` runs each kernel's plain PyTorch version on CPU
tensors (the CUDA kernels run only on a card). Inputs come from seeded numpy
generators and go through both packages; the Pallas kernels run in interpret
mode on the CPU, as the JAX package's own tests run them.

Tolerances: the histograms at rtol 1e-5 / atol 1e-4 against the Pallas node
histogram and atol 1e-4 against the fused one (float32 sums in another
order; tests/test_pallas_kernels.py:191, :45); the port's plain versions
accumulate in float64 and round once, the JAX package sums in float32. The
histogram kernels sum in integer fixed point: their arithmetic, repeated in
plain PyTorch (``*_kernel_arithmetic``), is held against the float64 plain
versions at the chip smoke run's gate (|d| <= 1e-4 + 1e-5 |plain|) and at
one float32 ulp, and against the Pallas kernels at the tolerances above;
under a row permutation it must give the same bits. The
quantized predicts are held at atol 1e-6 against numpy walks copied from
tests/test_pallas_kernels.py:295-327 (a heap descent, a split-sequence
replay); the JAX kernels themselves raise on this jax, which lost
``pl.load``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import pallas_kernels as pk
from mmlspark_tpu_torch.ops import gbdt_kernels as gk


def _hist_inputs(seed, N, F, n_bins, n_nodes):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, n_bins, size=(N, F)).astype(np.int32)
    node = rng.integers(-1, n_nodes + 2, size=N).astype(np.int32)  # some OOR
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    return bins, node, g, h


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


# (N, F, n_bins, n_nodes): test_pallas_kernels.py:191, rows off every block,
# and the engine's 255-bin width at a few nodes
NODE_SHAPES = [(333, 5, 16, 3), (200, 3, 255, 1), (517, 4, 255, 6)]


@pytest.mark.parametrize("N,F,n_bins,n_nodes", NODE_SHAPES)
def test_node_histogram_matches_jax(N, F, n_bins, n_nodes):
    bins, node, g, h = _hist_inputs(1, N, F, n_bins, n_nodes)
    jg, jh = pk.mxu_node_histogram(
        jnp.asarray(bins.T), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), n_nodes=n_nodes, n_bins=n_bins, block_n=128)
    tg, th = gk.mxu_node_histogram(*_t(bins.T.astype(np.uint8), node, g, h),
                                   n_nodes=n_nodes, n_bins=n_bins)
    assert tg.shape == (n_nodes, F, n_bins)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-4)
    # and against segment_sum over combined ids, out-of-range rows masked
    ok = (node >= 0) & (node < n_nodes)
    comb = np.where(ok, node, n_nodes)[:, None] * n_bins + bins
    sg, sh = pk.segment_histogram(jnp.asarray(comb), jnp.asarray(g * ok),
                                  jnp.asarray(h * ok),
                                  n_bins=(n_nodes + 1) * n_bins)
    sg = np.asarray(sg).reshape(F, n_nodes + 1, n_bins)[:, :n_nodes]
    np.testing.assert_allclose(tg.numpy(), sg.transpose(1, 0, 2), rtol=1e-5,
                               atol=1e-4)


def test_node_histogram_drops_bins_past_n_bins():
    """uint8 bins at or above n_bins add nothing (the TPU kernel's one-hot
    has no column for them)."""
    bins, node, g, h = _hist_inputs(2, 300, 3, 16, 2)
    bins[::3, 1] = 200
    tg, _ = gk.mxu_node_histogram(*_t(bins.T.astype(np.uint8), node, g, h),
                                  n_nodes=2, n_bins=16)
    keep = (bins[:, 1] < 16) & (node >= 0) & (node < 2)
    assert float(tg[:, 1].sum()) == pytest.approx(float(g[keep].sum()),
                                                  abs=1e-4)


@pytest.mark.parametrize("N,F,n_bins,block_n", [(100, 5, 16, 32),
                                                (33, 3, 8, 16),
                                                (257, 4, 300, 128)])
def test_fused_histogram_matches_jax_and_numpy(N, F, n_bins, block_n):
    """test_pallas_kernels.py:45 and :63 (row padding), and a combined-id
    width past 256 as the engine passes it."""
    rng = np.random.default_rng(3)
    bins = rng.integers(0, n_bins, size=(N, F)).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    jg, jh = pk.histogram_fused(jnp.asarray(bins), jnp.asarray(g),
                                jnp.asarray(h), n_bins=n_bins,
                                block_n=block_n)
    tg, th = gk.histogram_fused(*_t(bins, g, h), n_bins=n_bins)
    ref_g = np.zeros((F, n_bins), np.float32)
    ref_h = np.zeros((F, n_bins), np.float32)
    for f in range(F):
        for b in range(n_bins):
            sel = bins[:, f] == b
            ref_g[f, b] = g[sel].sum()
            ref_h[f, b] = h[sel].sum()
    for got, jax_out, ref in ((tg, jg, ref_g), (th, jh, ref_h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out),
                                   atol=1e-4)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_fused_histogram_drops_out_of_range_ids():
    rng = np.random.default_rng(4)
    bins = rng.integers(-2, 19, size=(90, 3)).astype(np.int32)
    g = rng.normal(size=90).astype(np.float32)
    tg, th = gk.histogram_fused(*_t(bins, g, np.ones(90, np.float32)),
                                n_bins=16)
    ok = (bins >= 0) & (bins < 16)
    np.testing.assert_allclose(th.sum(1).numpy(), ok.sum(0), atol=1e-4)
    jg, _ = pk.histogram_fused(jnp.asarray(bins), jnp.asarray(g),
                               jnp.ones(90, jnp.float32), n_bins=16,
                               block_n=32)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4)


def test_segment_and_compare_histograms_match_jax():
    bins, _, g, h = _hist_inputs(5, 400, 6, 32, 1)
    jsg, jsh = pk.segment_histogram(jnp.asarray(bins), jnp.asarray(g),
                                    jnp.asarray(h), 32)
    tsg, tsh = gk.segment_histogram(*_t(bins, g, h), 32)
    np.testing.assert_allclose(tsg.numpy(), np.asarray(jsg), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(tsh.numpy(), np.asarray(jsh), rtol=1e-6,
                               atol=1e-5)
    jcg, jch = pk.compare_reduce_histogram(jnp.asarray(bins), jnp.asarray(g),
                                           jnp.asarray(h), 32)
    tcg, tch = gk.compare_reduce_histogram(*_t(bins, g, h), 32)
    np.testing.assert_allclose(tcg.numpy(), np.asarray(jcg), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(tch.numpy(), np.asarray(jch), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "mxu", "segment", "compare",
                                  "pallas"])
def test_node_sums_matches_jax(impl):
    """test_pallas_kernels.py:239: the one-hot product ("auto"/"mxu") and
    the segment reduction of the pinned impls."""
    rng = np.random.default_rng(6)
    node = rng.integers(0, 7, 1000).astype(np.int32)
    g = rng.normal(size=1000).astype(np.float32)
    h = rng.random(1000).astype(np.float32)
    jl = pk.node_sums(jnp.asarray(node), jnp.asarray(g), jnp.asarray(h), 7,
                      impl=impl)
    tl = gk.node_sums(*_t(node, g, h), 7, impl=impl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-5)


def _walk_levelwise(bins, feat, thr, leaf, depth):
    """numpy reference: heap descent over the quantized tables
    (tests/test_pallas_kernels.py:295-310)."""
    n = bins.shape[0]
    T, K, _ = feat.shape
    out = np.zeros((n, K), np.float32)
    for t in range(T):
        for k in range(K):
            pos = np.zeros(n, np.int64)
            for level in range(depth):
                node = 2 ** level - 1 + pos
                f = feat[t, k, node]
                go_right = bins[np.arange(n), f].astype(np.int64) \
                    > thr[t, k, node]
                pos = pos * 2 + go_right
            out[:, k] += leaf[t, k][pos]
    return out


@pytest.mark.parametrize("int8_leaves", [False, True])
def test_quant_predict_matches_numpy_walk(int8_leaves):
    """test_pallas_kernels.py:330: the 255 route-all-left sentinel and
    (n, d) aligned to nothing; bf16 leaves, or int8 times a per-tree scale
    (engine.quantize_leaves_int8), widened to float32."""
    from mmlspark_tpu_torch.models.gbdt.engine import quantize_leaves_int8
    rng = np.random.default_rng(7)
    T, K, depth, d, n = 7, 3, 4, 11, 777
    nodes, leaves = 2 ** depth - 1, 2 ** depth
    bins = rng.integers(0, 32, size=(n, d)).astype(np.uint8)
    feat = rng.integers(0, d, size=(T, K, nodes)).astype(np.uint8)
    thr = rng.integers(0, 32, size=(T, K, nodes)).astype(np.uint8)
    thr[0, 0, 0] = 255
    thr[3, 1, 2:9] = 255
    leaf32 = rng.normal(size=(T, K, leaves)).astype(np.float32)
    if int8_leaves:
        q, scale = quantize_leaves_int8(leaf32)
        leaf = (q.astype(np.float32) * scale).astype(np.float32)
    else:
        leaf = torch.from_numpy(leaf32).to(torch.bfloat16).float().numpy()
    out = gk.gbdt_predict_quant_levelwise(*_t(bins.T, feat, thr, leaf),
                                          depth=depth)
    assert out.shape == (n, K) and out.dtype == torch.float32
    ref = _walk_levelwise(bins, feat, thr, leaf, depth)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def _walk_leafwise(bins, split, feat, thr, leaf):
    """numpy reference: replay the split sequence over the quantized tables
    (tests/test_pallas_kernels.py:313-327)."""
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


def _lw_tables(rng, T, K, R, d, int8_leaves):
    """test_pallas_kernels.py:351's tables: split_leaf[t, k, r] in [0, r]
    (round r can split any leaf made so far), tree 2 stopped after 5 rounds
    (-1 no-op rounds), the 255 sentinel, bf16-rounded or int8-scaled leaves
    widened to float32."""
    from mmlspark_tpu_torch.models.gbdt.engine import quantize_leaves_int8
    split = np.stack([np.stack([rng.integers(0, r + 1, size=T)
                                for r in range(R)], axis=1)
                      for _ in range(K)], axis=1).astype(np.int32)
    split[2, :, 5:] = -1
    feat = rng.integers(0, d, size=(T, K, R)).astype(np.uint8)
    thr = rng.integers(0, 64, size=(T, K, R)).astype(np.uint8)
    thr[1, 0, :3] = 255
    leaf32 = rng.normal(size=(T, K, R + 1)).astype(np.float32)
    if int8_leaves:
        q, scale = quantize_leaves_int8(leaf32)
        leaf = (q.astype(np.float32) * scale).astype(np.float32)
    else:
        leaf = torch.from_numpy(leaf32).to(torch.bfloat16).float().numpy()
    return split, feat, thr, leaf


@pytest.mark.parametrize("int8_leaves", [False, True])
@pytest.mark.parametrize("K", [1, 3])
def test_quant_leafwise_predict_matches_numpy_walk(int8_leaves, K):
    """test_pallas_kernels.py:351 (T = 5, R = 9, d = 6, n = 333, nothing
    aligned), -1 no-op rounds that never move a row, the 255 sentinel, K =
    1 and 3, bf16 or int8-scaled leaves."""
    rng = np.random.default_rng(11)
    T, R, d, n = 5, 9, 6, 333
    bins = rng.integers(0, 64, size=(n, d)).astype(np.uint8)
    split, feat, thr, leaf = _lw_tables(rng, T, K, R, d, int8_leaves)
    out = gk.gbdt_predict_quant_leafwise(*_t(bins.T, split, feat, thr, leaf))
    assert out.shape == (n, K) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(),
                               _walk_leafwise(bins, split, feat, thr, leaf),
                               atol=1e-6)
    # a tree whose rounds are all no-ops scores its root leaf everywhere
    split[:] = -1
    out = gk.gbdt_predict_quant_leafwise(*_t(bins.T, split, feat, thr, leaf))
    np.testing.assert_allclose(out.numpy(),
                               np.broadcast_to(leaf[:, :, 0].sum(0), (n, K)),
                               atol=1e-6)


def test_leafwise_wrapper_checks_its_inputs():
    bins_t = torch.zeros((3, 10), dtype=torch.uint8)
    sl = torch.zeros((2, 1, 7), dtype=torch.int32)
    u8 = torch.zeros((2, 1, 7), dtype=torch.uint8)
    with pytest.raises(ValueError, match="R \\+ 1"):
        gk.gbdt_predict_quant_leafwise(bins_t, sl, u8, u8,
                                       torch.zeros((2, 1, 7)))
    with pytest.raises(ValueError, match="disagree"):
        gk.gbdt_predict_quant_leafwise(bins_t, sl, u8[:, :, :6], u8,
                                       torch.zeros((2, 1, 8)))
    big = torch.zeros((1, 1, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="caps"):
        gk.gbdt_predict_quant_leafwise(bins_t, big.int(), big, big,
                                       torch.zeros((1, 1, 129)))
    with pytest.raises(ValueError, match="\\(T, K, R\\)"):
        gk.gbdt_predict_quant_leafwise(bins_t, sl[0], u8[0], u8[0],
                                       torch.zeros((1, 8)))
    with pytest.raises(ValueError, match="devices"):
        gk.gbdt_predict_quant_leafwise(bins_t, sl, u8, u8,
                                       torch.zeros((2, 1, 8),
                                                   device="meta"))
    # R = 127 rounds (the cap) is taken
    cap = torch.zeros((1, 1, 127), dtype=torch.uint8)
    out = gk.gbdt_predict_quant_leafwise(bins_t, cap.int(), cap, cap,
                                         torch.ones((1, 1, 128)))
    assert torch.equal(out, torch.ones((10, 1)))


def test_kernel_wrappers_check_their_inputs():
    bins_t = torch.zeros((3, 10), dtype=torch.uint8)
    z = torch.zeros(10)
    with pytest.raises(ValueError):
        gk.mxu_node_histogram(bins_t, torch.zeros(9, dtype=torch.int32), z,
                              z, n_nodes=2, n_bins=16)
    with pytest.raises(ValueError):
        gk.mxu_node_histogram(bins_t, torch.zeros(10, dtype=torch.int32), z,
                              z, n_nodes=300, n_bins=16)
    feat = torch.zeros((2, 1, 7), dtype=torch.uint8)
    with pytest.raises(ValueError, match="depth"):
        gk.gbdt_predict_quant_levelwise(bins_t, feat, feat,
                                        torch.zeros((2, 1, 8)), depth=2)
    big = torch.zeros((1, 1, 255), dtype=torch.uint8)
    with pytest.raises(ValueError, match="caps"):
        gk.gbdt_predict_quant_levelwise(bins_t, big, big,
                                        torch.zeros((1, 1, 256)), depth=8)


def test_cpu_calls_launch_nothing():
    """The launch counters count kernel launches only: the plain versions
    that CPU tensors run leave them alone."""
    def counts():
        return (gk.mxu_node_histogram.launches, gk.histogram_fused.launches,
                gk.gbdt_predict_quant_levelwise.launches,
                gk.gbdt_predict_quant_leafwise.launches)
    before = counts()
    bins, node, g, h = _hist_inputs(8, 50, 2, 8, 2)
    gk.mxu_node_histogram(*_t(bins.T.astype(np.uint8), node, g, h),
                          n_nodes=2, n_bins=8)
    gk.histogram_fused(*_t(bins, g, h), n_bins=8)
    feat = torch.zeros((1, 1, 1), dtype=torch.uint8)
    gk.gbdt_predict_quant_levelwise(*_t(bins.T.astype(np.uint8)), feat, feat,
                                    torch.ones((1, 1, 2)), depth=1)
    gk.gbdt_predict_quant_leafwise(*_t(bins.T.astype(np.uint8)),
                                   feat.int(), feat, feat,
                                   torch.ones((1, 1, 2)))
    assert before == counts()


@pytest.mark.cuda
def test_cuda_kernels_match_plain_and_repeat_bit_for_bit():
    """On a card: each kernel against its plain version, and two launches
    on the same inputs bit-identical (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    bins, node, g, h = _hist_inputs(9, 50001, 7, 255, 16)
    bt, nd, gg, hh = (x.cuda() for x in _t(bins.T.astype(np.uint8), node, g,
                                            h))
    a = gk.mxu_node_histogram(bt, nd, gg, hh, n_nodes=16, n_bins=255)
    b = gk.mxu_node_histogram(bt, nd, gg, hh, n_nodes=16, n_bins=255)
    r = gk.node_histogram_reference(bt, nd, gg, hh, 16, 255)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a, r):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
    # the integer sums are exact: the kernel is its arithmetic, bit for bit
    e = gk.node_histogram_kernel_arithmetic(bt, nd, gg, hh, 16, 255)
    assert all(_same_bits(x, y) for x, y in zip(a, e))
    comb = (np.clip(node, 0, 15)[:, None] * 255 + bins).astype(np.int32)
    cb = torch.from_numpy(comb).cuda()
    a = gk.histogram_fused(cb, gg, hh, n_bins=16 * 255)
    b = gk.histogram_fused(cb, gg, hh, n_bins=16 * 255)
    r = gk.histogram_fused_reference(cb, gg, hh, 16 * 255)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a, r):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
    e = gk.histogram_fused_kernel_arithmetic(cb, gg, hh, 16 * 255)
    assert all(_same_bits(x, y) for x, y in zip(a, e))
    rng = np.random.default_rng(10)
    feat = torch.from_numpy(rng.integers(0, 7, (9, 2, 31)).astype(
        np.uint8)).cuda()
    thr = torch.from_numpy(rng.integers(0, 256, (9, 2, 31)).astype(
        np.uint8)).cuda()
    leaf = torch.from_numpy(rng.normal(size=(9, 2, 32)).astype(
        np.float32)).cuda()
    out = gk.gbdt_predict_quant_levelwise(bt, feat, thr, leaf, depth=5)
    assert torch.equal(out, gk.quant_levelwise_reference(bt, feat, thr, leaf,
                                                         5))
    split, f8, t8, lf = (torch.from_numpy(a).cuda() for a in _lw_tables(
        rng, 9, 2, 30, 7, False))
    before = gk.gbdt_predict_quant_leafwise.launches
    a = gk.gbdt_predict_quant_leafwise(bt, split, f8, t8, lf)
    b = gk.gbdt_predict_quant_leafwise(bt, split, f8, t8, lf)
    assert gk.gbdt_predict_quant_leafwise.launches == before + 2
    assert torch.equal(a, b)
    assert torch.equal(a, gk.quant_leafwise_reference(bt, split, f8, t8, lf))
    # the kernel takes int32 split ids, uint8 tables and f32 leaves only
    for bad in ((split.long(), f8, t8, lf), (split, f8.int(), t8, lf),
                (split, f8, t8, lf.double())):
        with pytest.raises(ValueError, match="takes int32"):
            gk.gbdt_predict_quant_leafwise(bt, *bad)
    assert gk.gbdt_predict_quant_leafwise.launches == before + 2


# ------------------------------------------- the kernels' fixed-point sums

def _same_bits(a, b) -> bool:
    """Equal bit for bit, NaN for NaN (whatever the NaN's payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32),
        torch.where(nb, 0.0, b).view(torch.int32))


def _grads(rng, N, objective):
    """g/h over the ranges the objectives give: binary log-loss (|g| < 1,
    h <= 0.25), l2 regression on a wide target (h = 1), and log-loss
    gradients with one outlier of 1e3."""
    if objective == "regression":
        return (rng.normal(0, 30, N).astype(np.float32),
                np.ones(N, np.float32))
    p = 1 / (1 + np.exp(-rng.normal(0, 2, N)))
    y = rng.random(N) < 0.5
    g, h = (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)
    if objective == "outlier":
        g[N // 3] = 1e3
    return g, h


def _ulps(a, b):
    """Distance in float32 ulps of finite same-sign-or-zero values."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7fffffff), ia)
    ib = torch.where(ib < 0, -(ib & 0x7fffffff), ib)
    return (ia - ib).abs()


def _hold_to_plain(got, ref):
    """The chip smoke run's gate and, tighter, one float32 ulp: the fixed
    point holds a key's sum to count * max|v| * N * 2^-76, under half a
    float32 ulp of any sum that does not cancel to below count * max|v| *
    N * 2^-50, which none of these inputs' sums does; so only a sum within
    that of a rounding tie can round apart."""
    for x, y in zip(got, ref):
        assert bool(((x - y).abs() <= 1e-4 + 1e-5 * y.abs()).all())
        assert int(_ulps(x, y).max()) <= 1


OBJECTIVES = ["binary", "regression", "outlier"]


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("n_nodes,n_bins", [(1, 255), (2, 16), (16, 255)])
def test_node_kernel_arithmetic_matches_plain_and_jax(objective, n_nodes,
                                                      n_bins):
    """The kernel's fixed-point arithmetic against the float64 plain
    version and the Pallas kernel (interpret mode), with out-of-range node
    ids and bins past n_bins among the rows."""
    rng = np.random.default_rng(20 + n_nodes)
    N, F = 700, 3
    bins = rng.integers(0, 256, size=(N, F)).astype(np.int32)
    node = rng.integers(-1, n_nodes + 2, size=N).astype(np.int32)
    g, h = _grads(rng, N, objective)
    args = _t(bins.T.astype(np.uint8), node, g, h)
    got = gk.node_histogram_kernel_arithmetic(*args, n_nodes, n_bins)
    assert got[0].shape == (n_nodes, F, n_bins)
    _hold_to_plain(got, gk.node_histogram_reference(*args, n_nodes, n_bins))
    jg, jh = pk.mxu_node_histogram(
        jnp.asarray(bins.T), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), n_nodes=n_nodes, n_bins=n_bins, block_n=128)
    scale = max(1.0, float(np.abs(g).max()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("n_bins", [16, 300])
def test_fused_kernel_arithmetic_matches_plain_and_jax(objective, n_bins):
    """The same for the fused kernel's (N, F) ids, ids below 0 and past
    n_bins among them."""
    rng = np.random.default_rng(30 + n_bins)
    N, F = 600, 4
    bins = rng.integers(-2, n_bins + 3, size=(N, F)).astype(np.int32)
    g, h = _grads(rng, N, objective)
    args = _t(bins, g, h)
    got = gk.histogram_fused_kernel_arithmetic(*args, n_bins)
    assert got[0].shape == (F, n_bins)
    _hold_to_plain(got, gk.histogram_fused_reference(*args, n_bins))
    jg, jh = pk.histogram_fused(jnp.asarray(bins), jnp.asarray(g),
                                jnp.asarray(h), n_bins=n_bins, block_n=128)
    scale = max(1.0, float(np.abs(g).max()))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jg),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(jh), atol=1e-4)


def test_kernel_arithmetic_gives_the_same_bits_under_a_row_permutation():
    """Integer sums do not depend on the order of the rows."""
    rng = np.random.default_rng(40)
    N, F = 5000, 6
    bins = rng.integers(0, 64, size=(N, F)).astype(np.int32)
    node = rng.integers(-1, 5, size=N).astype(np.int32)
    g, h = _grads(rng, N, "binary")
    perm = rng.permutation(N)
    for rows in (np.arange(N), perm):
        a = gk.node_histogram_kernel_arithmetic(
            *_t(bins[rows].T.astype(np.uint8), node[rows], g[rows],
                h[rows]), 4, 64)
        b = gk.histogram_fused_kernel_arithmetic(
            *_t(bins[rows], g[rows], h[rows]), 64)
        if rows is perm:
            assert all(_same_bits(x, y) for x, y in zip(a + b, first))
        first = a + b


def test_kernel_arithmetic_gives_ieee_results_for_non_finite_values():
    """NaN, +inf, -inf and both infinities in one key: the float64
    scatter-add's results; the finite keys as without them."""
    rng = np.random.default_rng(41)
    N = 400
    bins = rng.integers(0, 8, size=(N, 2)).astype(np.int32)
    g, h = _grads(rng, N, "binary")
    g[bins[:, 0] == 1] = np.nan
    g[np.flatnonzero(bins[:, 0] == 2)[:2]] = np.inf
    g[np.flatnonzero(bins[:, 0] == 3)[:1]] = -np.inf
    g[np.flatnonzero(bins[:, 0] == 4)[:1]] = np.inf
    g[np.flatnonzero(bins[:, 0] == 4)[1:2]] = -np.inf
    got = gk.histogram_fused_kernel_arithmetic(*_t(bins, g, h), 8)
    ref = gk.histogram_fused_reference(*_t(bins, g, h), 8)
    row = got[0][0]
    assert math.isnan(row[1]) and math.isnan(row[4])
    assert row[2] == math.inf and row[3] == -math.inf
    for x, y in zip(got, ref):
        assert torch.equal(torch.isnan(x), torch.isnan(y))
        assert torch.equal(torch.isinf(x), torch.isinf(y))
        assert torch.equal(x[torch.isinf(x)], y[torch.isinf(y)])
        fin = torch.isfinite(y)
        assert int(_ulps(x[fin], y[fin]).max()) <= 1
    # the h histogram saw no non-finite value: its scale and sums as before
    clean = gk.histogram_fused_kernel_arithmetic(
        *_t(bins, np.zeros(N, np.float32), h), 8)
    assert _same_bits(got[1], clean[1])


def test_kernel_arithmetic_edge_values():
    """All-zero g gives zeros; one row gives its value exactly; integer
    and quarter values sum exactly, as in float64."""
    rng = np.random.default_rng(42)
    N = 300
    bins = rng.integers(0, 8, size=(N, 3)).astype(np.int32)
    z = np.zeros(N, np.float32)
    q = (rng.integers(-8, 9, N) / 4).astype(np.float32)
    got = gk.histogram_fused_kernel_arithmetic(*_t(bins, z, q), 8)
    assert _same_bits(got[0], torch.zeros((3, 8)))
    assert _same_bits(got[1], gk.histogram_fused_reference(
        *_t(bins, z, q), 8)[1])
    one = gk.node_histogram_kernel_arithmetic(
        *_t(np.array([[5]], np.uint8), np.array([0], np.int32),
            np.array([-0.3], np.float32), np.array([1e-30], np.float32)),
        1, 8)
    assert float(one[0][0, 0, 5]) == np.float32(-0.3)
    assert float(one[1][0, 0, 5]) == np.float32(1e-30)
    assert float(one[0].abs().sum() - one[0][0, 0, 5].abs()) == 0.0


def test_fixed_point_words_stay_inside_their_bounds():
    """hi of every value below 2^62 / N and lo within 2^13, so neither the
    int64 sums of N rows nor the int32 lo sums of a block overflow."""
    for v in (np.float32([1.0, -1.0, 0.5]), np.float32([3e38, -1e-45]),
              np.float32([1e-40, 0.0, -2e-40])):
        N = 10 ** 6
        s = gk._fixed_scale(torch.from_numpy(v), N)
        t = v.astype(np.float64) * 2.0 ** s
        assert np.abs(np.rint(t)).max() < 2.0 ** 62 / N
        lo = np.rint((t - np.rint(t)) * 2.0 ** gk.FIXED_LO_BITS)
        assert np.abs(lo).max() <= 2 ** 13


PLAN_SHAPES = [
    (1_000_000, 28, 255), (1_000_000, 28, 510), (1_000_000, 28, 4080),
    (200_000, 715, 510), (1_000_000, 28, 16 * 255), (12345, 3, 64 * 255),
    (1, 1, 1), (77777, 13, 256 * 256), (3_000_000, 5, 16)]


@pytest.mark.parametrize("n_rows,n_feat,n_keys", PLAN_SHAPES)
def test_histogram_plan_keeps_the_kernels_limits(n_rows, n_feat, n_keys):
    """Every row covered, the grid within CUDA's limits, shared memory
    within a block's, and at most 2^17 rows a block, where the int32 lo
    words of its part cannot overflow."""
    fpb, n_splits, rows, smem = gk._plan(n_rows, n_feat, n_keys, 132)
    assert 1 <= fpb <= n_feat and 1 <= n_splits <= 65535
    assert n_splits * rows >= n_rows and (n_splits - 1) * rows < n_rows
    assert rows <= gk._MAX_SPLIT_ROWS
    if smem:
        assert fpb * n_keys * gk._KEY_BYTES <= gk._SMEM_MAX
    else:
        assert n_keys * gk._KEY_BYTES > gk._SMEM_MAX and fpb == 1


@pytest.mark.parametrize("n_rows,n_feat,n_keys", PLAN_SHAPES)
def test_histogram_plan_fills_whole_waves(n_rows, n_feat, n_keys):
    """With the sums in shared memory, the grid fills the fewest whole
    waves of resident blocks that it fills to _WAVE_FILL, and one more
    row split would start another wave; in global memory it takes the
    fewest splits."""
    sms = 132
    fpb, n_splits, rows, smem = gk._plan(n_rows, n_feat, n_keys, sms)
    groups = -(-n_feat // fpb)
    fewest = max(1, -(-n_rows // gk._MAX_SPLIT_ROWS))
    if not smem:
        assert n_splits == fewest
        return
    assert n_splits >= fewest
    if n_splits == n_rows:  # one row a split: no more to split
        return
    per_block = fpb * n_keys * gk._KEY_BYTES + 1024
    slots = sms * max(1, min(gk._SM_SMEM // per_block, 2048 // gk._THREADS))
    waves = -(-groups * n_splits // slots)
    assert groups * n_splits >= gk._WAVE_FILL * waves * slots
    assert groups * (n_splits + 1) > waves * slots


def test_leafwise_two_node_histograms_grow_the_three_id_trees(monkeypatch):
    """cand_pair asks the node-histogram path for the two leaves alone
    (every other row's id 2 is out of range and adds nothing): the trees
    are those of the 3-id form, whose discard slot it drops."""
    from mmlspark_tpu_torch.models.gbdt import engine
    rng = np.random.default_rng(43)
    x = rng.normal(size=(800, 5)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.normal(0, 0.5, 800) > 0).astype(
        np.float32)
    p = engine.GBDTParams(objective="binary", num_iterations=3,
                          num_leaves=8, max_depth=0, max_bin=32,
                          hist_impl="mxu")
    orig = engine._histograms
    seen = []

    def spy(bins, bins_t, g, h, node, n_nodes, n_bins, impl):
        seen.append(n_nodes)
        return orig(bins, bins_t, g, h, node, n_nodes, n_bins, impl)

    def three_ids(bins, bins_t, g, h, node, n_nodes, n_bins, impl):
        hg, hh = orig(bins, bins_t, g, h, node, 3, n_bins, impl)
        return hg[:2].contiguous(), hh[:2].contiguous()

    monkeypatch.setattr(engine, "_histograms", spy)
    two = engine.fit_gbdt(x, y, p, device="cpu")
    assert set(seen) == {2} and len(seen) == 3 * 8
    monkeypatch.setattr(engine, "_histograms", three_ids)
    three = engine.fit_gbdt(x, y, p, device="cpu")
    for name in ("split_leaf", "feature", "threshold", "is_cat", "leaf"):
        assert torch.equal(getattr(two, name), getattr(three, name)), name
