"""The port's GBDT kernels' plain versions against the JAX package's.

``ops/gbdt_kernels.py`` runs each kernel's plain PyTorch version on CPU
tensors (the CUDA kernels run only on a card). Inputs come from seeded numpy
generators and go through both packages; the Pallas kernels run in interpret
mode on the CPU, as the JAX package's own tests run them.

Tolerances: the histograms at rtol 1e-5 / atol 1e-4 against the Pallas node
histogram and atol 1e-4 against the fused one (float32 sums in another
order; tests/test_pallas_kernels.py:191, :45); the port accumulates every
sum in float64 and rounds once, the JAX package sums in float32. The
quantized predict is held at atol 1e-6 against a numpy heap walk copied
from tests/test_pallas_kernels.py:295-310 (the JAX kernel itself raises on
this jax, which lost ``pl.load``).
"""

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
    before = (gk.mxu_node_histogram.launches, gk.histogram_fused.launches,
              gk.gbdt_predict_quant_levelwise.launches)
    bins, node, g, h = _hist_inputs(8, 50, 2, 8, 2)
    gk.mxu_node_histogram(*_t(bins.T.astype(np.uint8), node, g, h),
                          n_nodes=2, n_bins=8)
    gk.histogram_fused(*_t(bins, g, h), n_bins=8)
    feat = torch.zeros((1, 1, 1), dtype=torch.uint8)
    gk.gbdt_predict_quant_levelwise(*_t(bins.T.astype(np.uint8)), feat, feat,
                                    torch.ones((1, 1, 2)), depth=1)
    assert before == (gk.mxu_node_histogram.launches,
                      gk.histogram_fused.launches,
                      gk.gbdt_predict_quant_levelwise.launches)


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
    comb = (np.clip(node, 0, 15)[:, None] * 255 + bins).astype(np.int32)
    cb = torch.from_numpy(comb).cuda()
    a = gk.histogram_fused(cb, gg, hh, n_bins=16 * 255)
    b = gk.histogram_fused(cb, gg, hh, n_bins=16 * 255)
    r = gk.histogram_fused_reference(cb, gg, hh, 16 * 255)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a, r):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-4)
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
