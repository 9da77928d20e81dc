"""GBDT histogram and predict kernels: the port of the GBDT half of
``mmlspark_tpu/ops/pallas_kernels.py``.

Kernel wrappers, each beside its plain PyTorch version. On CUDA tensors a
wrapper launches its hand-written kernel or raises (there is no fallback);
on CPU tensors it runs the plain version. Each counts its kernel launches in
a plain int attribute, ``launches``, and nowhere else.

* :func:`mxu_node_histogram` (``_node_hist_kernel``) — per-(node, feature,
  bin) grad/hess sums; ``csrc/gbdt_histogram.cu`` mode 0.
* :func:`histogram_fused` (``_hist_kernel``) — per-(feature, id) sums of an
  int32 (N, F) id matrix; ``csrc/gbdt_histogram.cu`` mode 1.
* :func:`gbdt_predict_quant_levelwise` (``_gbdt_quant_lvl_kernel``) — the
  summed leaves of a level-wise ensemble over uint8 tables;
  ``csrc/gbdt_predict.cu``.

Every grad/hess sum here — the kernels, their plain versions, the plain
histograms and the leaf sums — accumulates in float64 and rounds to float32
once: each result is the float32 sum correctly rounded (to within float64's
rounding), whatever order it is taken in. The kernels take theirs in an
order fixed by the shapes (no atomics), so repeated calls give the same
bits; the plain versions' CUDA scatter-adds are atomic, in no fixed order,
and still agree with the kernels in all but a last-bit double rounding of
one sum in millions. So a fit through a kernel and through a plain path
grow the same trees, where float32 sums in two orders would break a
near-tie in the split search differently.

Also here, as plain PyTorch (the JAX package's plain-XLA functions):
:func:`segment_histogram`, :func:`compare_reduce_histogram` and
:func:`node_sums`, and the predict kernel's eligibility caps.
"""

from __future__ import annotations

import ctypes

import torch

#: the quantized predict kernel's caps (pallas_kernels.py:581-582), kept as
#: the eligibility rule of predict_impl="pallas"
PREDICT_QUANT_MAX_NODES = 127
PREDICT_QUANT_MAX_LEAVES = 128

#: threads and keys per histogram block: each warp's (g, h) sub-histogram
#: of _KEY_RANGE doubles sits in shared memory, 8 warps x 2 x 512 x 8 bytes
#: = 64 KB, three blocks per SM
_THREADS = 256
_KEY_RANGE = 512
#: row splits aim at this many blocks per SM
_BLOCKS_PER_SM = 8
_MIN_ROWS_PER_SPLIT = 8192

_C_HIST = {
    "mmlspark_gbdt_histogram": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p]),
    "mmlspark_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_C_PREDICT = {
    "mmlspark_gbdt_predict_quant_levelwise": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "mmlspark_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _raise_on(rc: int, lib, what: str):
    if rc != 0:
        msg = lib.mmlspark_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {rc} ({msg})")


def _check_rows(n: int, *vecs):
    for v in vecs:
        if v.dim() != 1 or v.shape[0] != n:
            raise ValueError(f"expected ({n},) vectors, got {tuple(v.shape)}")
        if v.device != vecs[0].device:
            raise ValueError("operands on different devices")


# ------------------------------------------------------- plain XLA functions

def segment_histogram(bins, grad, hess, n_bins: int):
    """Flat scatter-add histograms (``segment_histogram``, :393): bins (N, F)
    int in [0, n_bins), grad/hess (N,) -> (hist_g, hist_h), each (F, n_bins)
    float32 (accumulated in float64)."""
    N, F = bins.shape
    seg = (torch.arange(F, device=bins.device) * n_bins
           + bins.long()).reshape(-1)

    def bsum(v):
        src = v.double()[:, None].expand(N, F).reshape(-1)
        return torch.zeros(F * n_bins, dtype=torch.float64,
                           device=bins.device).index_add_(0, seg, src).float()
    return bsum(grad).reshape(F, n_bins), bsum(hess).reshape(F, n_bins)


def compare_reduce_histogram(bins, grad, hess, n_bins: int):
    """Per-bin masked sums (``compare_reduce_histogram``, :408), for id
    spaces of at most 256: bins (N, F) -> ((F, n_bins), (F, n_bins))."""
    if n_bins > 256:
        raise ValueError("compare-reduce needs a uint8 id space")
    bins = bins.to(torch.uint8)
    g = grad.double()[:, None]
    h = hess.double()[:, None]
    hg, hh = [], []
    for b in range(n_bins):
        m = bins == b
        hg.append(torch.where(m, g, 0.0).sum(0))
        hh.append(torch.where(m, h, 0.0).sum(0))
    return torch.stack(hg, 1).float(), torch.stack(hh, 1).float()


def node_sums(node, g, h, n_ids: int, impl: str = "auto"):
    """Per-node grad/hess sums, the leaf reduction (``node_sums``, :743).
    The pinned impls "segment", "compare" and "pallas" use the segment
    reduction; only "auto"/"mxu" take the one-hot product, and only while
    its (N, n_ids) staging stays under 2 GB. The product is a masked sum,
    never a matmul that TF32 could reach. Both accumulate in float64.
    Returns (lg, lh), each (n_ids,) float32."""
    if impl in ("segment", "compare", "pallas") \
            or node.shape[0] * n_ids * 4 > (2 << 30):
        idx = node.long()

        def seg(v):
            return torch.zeros(n_ids, dtype=torch.float64,
                               device=node.device).index_add_(
                                   0, idx, v.double()).float()
        return seg(g), seg(h)
    oh = node[:, None] == torch.arange(n_ids, device=node.device,
                                       dtype=node.dtype)
    return (torch.where(oh, g.double()[:, None], 0.0).sum(0).float(),
            torch.where(oh, h.double()[:, None], 0.0).sum(0).float())


# ------------------------------------------------------ histogram kernels

def _splits(n_rows: int, blocks_xy: int, device) -> tuple:
    """(row splits, rows per split): enough blocks for _BLOCKS_PER_SM per
    SM, each split at least _MIN_ROWS_PER_SPLIT rows. A function of the
    shapes and the card alone, so the summation order is fixed."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-sms * _BLOCKS_PER_SM // blocks_xy)
    cap = max(1, -(-n_rows // _MIN_ROWS_PER_SPLIT))
    n_splits = max(1, min(want, cap, 65535))
    return n_splits, max(1, -(-n_rows // n_splits))


def _launch_histogram(mode, bins, node, g, h, n_rows, ld, n_feat, nb,
                      n_nodes, n_keys, out_shape, what):
    from . import _build
    dev = bins.device
    key_range = min(n_keys, _KEY_RANGE)
    groups = -(-n_keys // key_range)
    if groups > 65535:
        raise ValueError(f"{what}: {n_keys} keys exceed the kernel's grid")
    n_splits, rows_per = _splits(n_rows, n_feat * groups, dev)
    part = torch.empty((n_splits, n_feat, 2, n_keys), dtype=torch.float64,
                       device=dev)
    hg = torch.empty(out_shape, dtype=torch.float32, device=dev)
    hh = torch.empty(out_shape, dtype=torch.float32, device=dev)
    lib = _build.load("gbdt_histogram", _C_HIST)
    with torch.cuda.device(dev):
        rc = lib.mmlspark_gbdt_histogram(
            mode, bins.data_ptr(), node.data_ptr() if node is not None else 0,
            g.data_ptr(), h.data_ptr(), part.data_ptr(), hg.data_ptr(),
            hh.data_ptr(), n_rows, ld, n_feat, nb, n_nodes, n_keys,
            key_range, n_splits, rows_per, _THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, what)
    return hg, hh


def node_histogram_reference(bins_t, node, g, h, n_nodes: int,
                             n_bins: int = 256):
    """Plain PyTorch version of :func:`mxu_node_histogram`: one scatter-add
    over combined (node, feature, bin) ids, with out-of-range node ids and
    bins >= n_bins sent to a discarded slot."""
    F, N = bins_t.shape
    dev = bins_t.device
    b = bins_t.long()
    nd = node.long()[None, :]
    ok = (nd >= 0) & (nd < n_nodes) & (b < n_bins)
    size = n_nodes * F * n_bins
    ids = torch.where(
        ok, (nd * F + torch.arange(F, device=dev)[:, None]) * n_bins + b,
        size).reshape(-1)

    def bsum(v):
        src = torch.where(ok, v.double()[None, :], 0.0).reshape(-1)
        out = torch.zeros(size + 1, dtype=torch.float64, device=dev)
        return out.index_add_(0, ids, src)[:size].reshape(
            n_nodes, F, n_bins).float()
    return bsum(g), bsum(h)


def mxu_node_histogram(bins_t, node, g, h, *, n_nodes: int,
                       n_bins: int = 256):
    """Per-(node, feature, bin) grad/hess histograms.

    bins_t (F, N) the transposed bin matrix (uint8 for the kernel; any int
    on the CPU); node (N,) int32 row -> node ids, rows outside
    [0, n_nodes) adding nothing; g/h (N,) float32. Returns (hg, hh), each
    (n_nodes, F, n_bins) float32. ``n_nodes`` <= 256 and ``n_bins`` <= 256,
    as for the TPU kernel."""
    if bins_t.dim() != 2:
        raise ValueError(f"bins_t must be (F, N), got {tuple(bins_t.shape)}")
    F, N = bins_t.shape
    _check_rows(N, node, g, h)
    if bins_t.device != node.device:
        raise ValueError("bins_t and node on different devices")
    if not 1 <= n_nodes <= 256 or not 1 <= n_bins <= 256:
        raise ValueError(f"n_nodes {n_nodes} and n_bins {n_bins} must be in "
                         f"[1, 256]")
    if bins_t.device.type == "cpu":
        return node_histogram_reference(bins_t, node, g, h, n_nodes, n_bins)
    if bins_t.device.type != "cuda":
        raise ValueError(f"mxu_node_histogram runs on cuda or cpu tensors, "
                         f"not {bins_t.device}")
    if bins_t.dtype != torch.uint8 or bins_t.stride(1) != 1:
        raise ValueError("the CUDA kernel reads uint8 bins_t with unit "
                         "row stride")
    if node.dtype != torch.int32 or g.dtype != torch.float32 \
            or h.dtype != torch.float32:
        raise ValueError("the CUDA kernel takes int32 node ids and float32 "
                         "g/h")
    if F == 0 or N == 0:
        z = torch.zeros((n_nodes, F, n_bins), dtype=torch.float32,
                        device=bins_t.device)
        return z, z.clone()
    out = _launch_histogram(
        0, bins_t, node.contiguous(), g.contiguous(), h.contiguous(), N,
        bins_t.stride(0), F, n_bins, n_nodes, n_nodes * n_bins,
        (n_nodes, F, n_bins), "mxu_node_histogram")
    mxu_node_histogram.launches += 1
    return out


#: kernel launches since the last reset (a run sets it to 0 and reads it)
mxu_node_histogram.launches = 0


def histogram_fused_reference(bins, grad, hess, n_bins: int = 256):
    """Plain PyTorch version of :func:`histogram_fused`: a scatter-add with
    ids outside [0, n_bins) sent to a discarded slot."""
    N, F = bins.shape
    dev = bins.device
    b = bins.long()
    ok = (b >= 0) & (b < n_bins)
    size = F * n_bins
    ids = torch.where(ok, torch.arange(F, device=dev) * n_bins + b,
                      size).reshape(-1)

    def bsum(v):
        src = torch.where(ok, v.double()[:, None], 0.0).reshape(-1)
        out = torch.zeros(size + 1, dtype=torch.float64, device=dev)
        return out.index_add_(0, ids, src)[:size].reshape(F, n_bins).float()
    return bsum(grad), bsum(hess)


def histogram_fused(bins, grad, hess, n_bins: int = 256):
    """Gradient/hessian histograms (the v1 one-hot kernel's function).

    bins (N, F) int32 ids (the engine passes node * max_bin + bin, so
    ``n_bins`` reaches n_nodes * max_bin); grad/hess (N,) float32. Ids
    outside [0, n_bins) add nothing. Returns (hist_g, hist_h), each
    (F, n_bins) float32."""
    if bins.dim() != 2:
        raise ValueError(f"bins must be (N, F), got {tuple(bins.shape)}")
    N, F = bins.shape
    _check_rows(N, grad, hess)
    if bins.device != grad.device:
        raise ValueError("bins and grad on different devices")
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if bins.device.type == "cpu":
        return histogram_fused_reference(bins, grad, hess, n_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"histogram_fused runs on cuda or cpu tensors, not "
                         f"{bins.device}")
    if bins.dtype != torch.int32 or bins.stride(1) != 1:
        raise ValueError("the CUDA kernel reads int32 bins with unit column "
                         "stride")
    if grad.dtype != torch.float32 or hess.dtype != torch.float32:
        raise ValueError("the CUDA kernel takes float32 grad/hess")
    if F == 0 or N == 0:
        z = torch.zeros((F, n_bins), dtype=torch.float32, device=bins.device)
        return z, z.clone()
    out = _launch_histogram(
        1, bins, None, grad.contiguous(), hess.contiguous(), N,
        bins.stride(0), F, 1, 1, n_bins, (F, n_bins), "histogram_fused")
    histogram_fused.launches += 1
    return out


histogram_fused.launches = 0


# --------------------------------------------------------- predict kernel

def _check_tables(bins_t, feature, threshold, leaf, depth: int):
    if bins_t.dim() != 2 or feature.dim() != 3:
        raise ValueError("bins_t must be (d, n) and the tables (T, K, .)")
    T, K, n_nodes = feature.shape
    if n_nodes != 2 ** depth - 1 or threshold.shape != feature.shape \
            or tuple(leaf.shape) != (T, K, 2 ** depth):
        raise ValueError(
            f"tables do not match depth {depth}: feature "
            f"{tuple(feature.shape)}, threshold {tuple(threshold.shape)}, "
            f"leaf {tuple(leaf.shape)}")
    if n_nodes > PREDICT_QUANT_MAX_NODES or 2 ** depth \
            > PREDICT_QUANT_MAX_LEAVES:
        raise ValueError(f"depth {depth} exceeds the kernel's caps "
                         f"({PREDICT_QUANT_MAX_NODES} nodes)")
    if not (bins_t.device == feature.device == threshold.device
            == leaf.device):
        raise ValueError("bins_t and the tables on different devices")


def quant_levelwise_reference(bins_t, feature, threshold, leaf, depth: int):
    """Plain PyTorch version of :func:`gbdt_predict_quant_levelwise`: the
    same heap descent, tree by tree, summing each tree's leaf in tree order
    from 0 (the kernel's order, so the two agree bit for bit)."""
    T, K, _ = feature.shape
    n = bins_t.shape[1]
    feat = feature.long()
    thr = threshold.long()
    lf = leaf.float()
    out = torch.zeros((n, K), dtype=torch.float32, device=bins_t.device)
    for t in range(T):
        for k in range(K):
            pos = torch.zeros(n, dtype=torch.long, device=bins_t.device)
            for level in range(depth):
                node = 2 ** level - 1 + pos
                vals = bins_t.gather(0, feat[t, k][node][None, :])[0]
                pos = pos * 2 + (vals.long() > thr[t, k][node]).long()
            out[:, k] += lf[t, k][pos]
    return out


def gbdt_predict_quant_levelwise(bins_t, feature, threshold, leaf, *,
                                 depth: int):
    """Quantized level-wise ensemble predict: one launch scores every tree.

    bins_t (d, n) uint8 — the transposed bin matrix; feature/threshold
    (T, K, 2^depth - 1) uint8 — the structure-of-arrays tables (threshold
    carries the 255 route-all-left sentinel, see engine.quantize_ensemble);
    leaf (T, K, 2^depth) float32 — the bf16 or int8 table widened. Returns
    (n, K) float32, the summed leaves without the base score."""
    _check_tables(bins_t, feature, threshold, leaf, depth)
    if bins_t.device.type == "cpu":
        return quant_levelwise_reference(bins_t, feature, threshold, leaf,
                                         depth)
    if bins_t.device.type != "cuda":
        raise ValueError(f"gbdt_predict_quant_levelwise runs on cuda or cpu "
                         f"tensors, not {bins_t.device}")
    d, n = bins_t.shape
    T, K, _ = feature.shape
    if bins_t.dtype != torch.uint8 or bins_t.stride(1) != 1:
        raise ValueError("the CUDA kernel reads uint8 bins_t with unit row "
                         "stride")
    if feature.dtype != torch.uint8 or threshold.dtype != torch.uint8 \
            or leaf.dtype != torch.float32:
        raise ValueError("the CUDA kernel takes uint8 feature/threshold and "
                         "float32 leaf tables")
    if not 1 <= d <= 256:
        raise ValueError(f"the CUDA kernel takes 1..256 features, not {d}")
    out = torch.zeros((n, K), dtype=torch.float32, device=bins_t.device)
    if n == 0 or T == 0:
        return out
    feature, threshold, leaf = (x.contiguous()
                                for x in (feature, threshold, leaf))
    if depth > 0 and int(feature.max()) >= d:
        raise ValueError(f"feature ids must be < {d}")
    from . import _build
    lib = _build.load("gbdt_predict", _C_PREDICT)
    with torch.cuda.device(bins_t.device):
        rc = lib.mmlspark_gbdt_predict_quant_levelwise(
            bins_t.data_ptr(), bins_t.stride(0), feature.data_ptr(),
            threshold.data_ptr(), leaf.data_ptr(), out.data_ptr(), n, d, T, K,
            depth, torch.cuda.current_stream(bins_t.device).cuda_stream)
    _raise_on(rc, lib, "gbdt_predict_quant_levelwise")
    gbdt_predict_quant_levelwise.launches += 1
    return out


gbdt_predict_quant_levelwise.launches = 0
