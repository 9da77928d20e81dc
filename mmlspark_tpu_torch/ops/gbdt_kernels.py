"""GBDT histogram and predict kernels: the port of the GBDT half of
``mmlspark_tpu/ops/pallas_kernels.py``.

Kernel wrappers, each beside its plain PyTorch version. On CUDA tensors a
wrapper launches its hand-written kernel or raises (there is no fallback);
on CPU tensors it runs the plain version. Each counts its kernel launches in
a plain int attribute, ``launches``, and nowhere else; the count is taken
under a lock, so fits on several threads (TuneHyperparameters) lose none.

* :func:`mxu_node_histogram` (``_node_hist_kernel``) — per-(node, feature,
  bin) grad/hess sums; ``csrc/gbdt_histogram.cu`` mode 0.
* :func:`histogram_fused` (``_hist_kernel``) — per-(feature, id) sums of an
  int32 (N, F) id matrix; ``csrc/gbdt_histogram.cu`` mode 1.
* :func:`gbdt_predict_quant_levelwise` (``_gbdt_quant_lvl_kernel``) — the
  summed leaves of a level-wise ensemble over uint8 tables;
  ``csrc/gbdt_predict.cu``.
* :func:`gbdt_predict_quant_leafwise` (``_gbdt_quant_lw_kernel``) — the
  same for a leaf-wise ensemble, each tree's split sequence turned into a
  pointer tree that a row walks down its path; ``csrc/gbdt_predict.cu``.

The histogram kernels sum in integer fixed point: each g and h becomes a
64-bit integer word and a 32-bit word of 14 more fraction bits, at one
power-of-two scale per call and quantity, chosen from max|v| and the row
count so that no sum can overflow; the integers are added in any order
(atomics) and each sum is converted to float32 once. Integer addition is
associative, so repeated calls, and calls on the same rows in another
order, give the same bits; each output is within count * max|v| * N *
2^-76 of the exact sum before its rounding to float32
(:func:`node_histogram_kernel_arithmetic` and
:func:`histogram_fused_kernel_arithmetic` repeat the arithmetic bit for
bit, for the tests and the chip smoke run). The plain
versions, the plain histograms and the leaf sums accumulate in float64 and
round to float32 once. That bound is absolute, not relative: where a
key's sum S has |S| >= count * max|v| * N * 2^-50 (at N = 1M, a mean value
of at least 8.9e-10 * max|v|), it stays under half a float32 ulp of S, so
kernel and plain version both give S within one ulp of its correct
rounding and differ at most in that last bit, rarely; a key whose values
cancel below that is held only to the bound. So a fit through a kernel
and through a plain path grow the same trees, where float32 sums in two
orders would break a near-tie in the split search differently.

The predict kernels add each row's leaves in tree order from 0, as their
plain versions do, so the two agree bit for bit;
:func:`quant_levelwise_kernel_arithmetic` and
:func:`quant_leafwise_kernel_arithmetic` repeat what the kernels compute
(the packed node words, the pointer trees and their walk) for the tests.

Also here, as plain PyTorch (the JAX package's plain-XLA functions):
:func:`segment_histogram`, :func:`compare_reduce_histogram` and
:func:`node_sums`, and the predict kernels' eligibility caps.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from ..telemetry import profiler

_launch_count_lock = threading.Lock()


def _count_launch(wrapper):
    """One more launch of ``wrapper``'s kernel (``+=`` on an attribute is
    a read and a write, which two threads can interleave)."""
    with _launch_count_lock:
        wrapper.launches += 1


#: the quantized predict kernels' caps (pallas_kernels.py:581-582): nodes
#: of a level-wise tree or split rounds of a leaf-wise one, and leaves; kept
#: as the eligibility rule of predict_impl="pallas"
PREDICT_QUANT_MAX_NODES = 127
PREDICT_QUANT_MAX_LEAVES = 128

#: the histogram kernels' fixed point (csrc/gbdt_histogram.cu): the scale
#: is 2^s with s = FIXED_HEADROOM - e, (m, e) = frexp(max|v| * N), so every
#: |v| * 2^s < 2^62 / N and no sum of the int64 words overflows; the low
#: word keeps FIXED_LO_BITS bits of each value's fraction
FIXED_HEADROOM = 62
FIXED_LO_BITS = 14
#: threads per histogram block; shared bytes per (feature, key): the int64
#: and int32 words of g and h
_THREADS = 512
_KEY_BYTES = 24
#: a block's shared sub-histograms aim at this size (two blocks of 512
#: threads per SM) and may not pass the per-block maximum; an SM's shared
#: memory (sm_90)
_SMEM_TARGET = 100 * 1024
_SMEM_MAX = 232448
_SM_SMEM = 233472
#: rows per block: its int32 low words (|lo| <= 2^13) cannot overflow
_MAX_SPLIT_ROWS = 1 << 17
#: the share of its waves' block slots a plan's grid fills at least
_WAVE_FILL = 0.9

_C_HIST = {
    "mmlspark_gbdt_histogram": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 2
        + [ctypes.c_void_p]),
    "mmlspark_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
_C_PREDICT = {
    "mmlspark_gbdt_predict_quant_levelwise": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "mmlspark_gbdt_predict_quant_leafwise": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
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

@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(n_rows: int, n_feat: int, n_keys: int, sms: int) -> tuple:
    """(features per block, row splits, rows per split, shared memory?)
    for a histogram launch. A block keeps the words of its features' keys
    in shared memory when one feature's fit; its features share each row's
    loads and quantization. A split holds at most _MAX_SPLIT_ROWS rows,
    where the int32 low words cannot overflow, and the grid takes the
    fewest whole waves of resident blocks that it fills to _WAVE_FILL,
    with as many row splits as those waves hold. Where one feature's keys
    do not fit, blocks add into their part in global memory, one feature
    each, over the fewest splits: every split adds a part of all the keys.
    Only the speed depends on the plan, never the bits."""
    per_feat = n_keys * _KEY_BYTES
    smem = per_feat <= _SMEM_MAX
    groups = -(-n_feat // max(1, _SMEM_TARGET // per_feat)) if smem \
        else n_feat
    fpb = -(-n_feat // groups)
    n_splits = max(1, -(-n_rows // _MAX_SPLIT_ROWS))
    if smem:
        resident = max(1, min(_SM_SMEM // (fpb * per_feat + 1024),
                              2048 // _THREADS))
        slots = sms * resident
        waves = -(-groups * n_splits // slots)
        while groups * (waves * slots // groups) < _WAVE_FILL * waves * slots:
            waves += 1
        n_splits = max(n_splits, waves * slots // groups)
    n_splits = min(n_splits, 65535, n_rows)
    return fpb, n_splits, -(-n_rows // n_splits), smem


def _launch_histogram(mode, bins, node, g, h, n_rows, ld, n_feat, nb,
                      n_nodes, n_keys, out_shape, what):
    from . import _build
    dev = bins.device
    fpb, n_splits, rows_per, smem = _plan(
        n_rows, n_feat, n_keys,
        _sm_count(dev.index if dev.index is not None
                  else torch.cuda.current_device()))
    # one allocation, which the launch zeroes where it must: the max words
    # and the (F, 2, n_keys) int32 non-finite bits, then the parts'
    # (n_splits, F, 2, n_keys) int64 high and int32 low words
    words = n_splits * n_feat * 2 * n_keys
    scratch = torch.empty(1 + n_feat * n_keys + words + -(-words // 2),
                          dtype=torch.int64, device=dev)
    # two allocations, not two views of one: the callers' reductions over
    # the histograms sum in an order that depends on their alignment
    hg = torch.empty(out_shape, dtype=torch.float32, device=dev)
    hh = torch.empty(out_shape, dtype=torch.float32, device=dev)
    lib = _build.load("gbdt_histogram", _C_HIST)
    with torch.cuda.device(dev):
        rc = lib.mmlspark_gbdt_histogram(
            mode, bins.data_ptr(), node.data_ptr() if node is not None else 0,
            g.data_ptr(), h.data_ptr(), scratch.data_ptr(), hg.data_ptr(),
            hh.data_ptr(), n_rows, ld, n_feat, nb, n_nodes, n_keys, fpb,
            n_splits, rows_per, int(smem), _THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, what)
    return hg, hh


def _fixed_scale(v, n_rows: int) -> int:
    """The kernels' scale exponent s for one quantity: 62 - e, (m, e) =
    frexp(max|v| * N) over the finite values (a max of 0 gives s = 62)."""
    fin = v[torch.isfinite(v)]
    m = float(fin.abs().max()) if fin.numel() else 0.0
    return FIXED_HEADROOM - math.frexp(m * float(n_rows))[1]


def _fixed_point_sum(v, ids, ok, size: int, row_axis: int):
    """One quantity's sums in the kernels' arithmetic. ``ids``/``ok`` are
    (F, N) with ``row_axis`` 1 or (N, F) with ``row_axis`` 0, v (N,) is
    broadcast over them, and the sums go into ``size`` slots; non-finite
    values add nothing to the integers and decide their slot's IEEE
    result."""
    s = _fixed_scale(v, v.shape[0])
    fin = torch.isfinite(v)
    t = torch.where(fin, v.double(), 0.0) * 2.0 ** s
    hi = torch.round(t)
    lo = torch.round((t - hi) * 2.0 ** FIXED_LO_BITS).long()
    flat = torch.where(ok, ids, size).reshape(-1)

    def total(x):
        x = (x[None, :] if row_axis == 1 else x[:, None]).expand(ids.shape)
        return torch.zeros(size + 1, dtype=torch.int64,
                           device=v.device).index_add_(
                               0, flat, x.reshape(-1))[:size]
    H, L = total(hi.long()), total(lo)
    out = ((H.double() + L.double() * 2.0 ** -FIXED_LO_BITS)
           * 2.0 ** -s).float()
    nan, pos, neg = (total(m.long()) > 0 for m in (
        torch.isnan(v), v == math.inf, v == -math.inf))
    out = torch.where(pos, math.inf, torch.where(neg, -math.inf, out))
    return torch.where(nan | (pos & neg), math.nan, out)


def node_histogram_kernel_arithmetic(bins_t, node, g, h, n_nodes: int,
                                     n_bins: int = 256):
    """The node-histogram kernel's arithmetic in plain PyTorch: the same
    fixed-point words, exact integer sums and one conversion, so it equals
    the kernel bit for bit. For tests and the chip smoke run; the fit path
    uses :func:`mxu_node_histogram`."""
    F, N = bins_t.shape
    b = bins_t.long()
    nd = node.long()[None, :]
    ok = (nd >= 0) & (nd < n_nodes) & (b < n_bins)
    ids = (nd * F + torch.arange(F, device=bins_t.device)[:, None]) \
        * n_bins + b
    size = n_nodes * F * n_bins
    return tuple(_fixed_point_sum(v, ids, ok, size, 1).reshape(
        n_nodes, F, n_bins) for v in (g, h))


def histogram_fused_kernel_arithmetic(bins, grad, hess, n_bins: int = 256):
    """The fused-histogram kernel's arithmetic in plain PyTorch, bit for
    bit (see :func:`node_histogram_kernel_arithmetic`)."""
    N, F = bins.shape
    b = bins.long()
    ok = (b >= 0) & (b < n_bins)
    ids = torch.arange(F, device=bins.device) * n_bins + b
    return tuple(_fixed_point_sum(v, ids, ok, F * n_bins, 0).reshape(
        F, n_bins) for v in (grad, hess))


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


def unit_row_stride(bins_t) -> bool:
    """Whether the predict kernels can step the rows of ``bins_t`` (F, N)
    one byte at a time. A single row is never stepped: ``.T.contiguous()``
    of a (1, F) matrix keeps its (1, F) strides (PyTorch calls that
    contiguous), and the kernels read its F bytes through the feature
    stride, 1, with byte loads (``load4`` past the last row)."""
    return bins_t.shape[1] <= 1 or bins_t.stride(1) == 1


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
    _count_launch(mxu_node_histogram)
    # the profiler's analytic cost: every row taken as live (the most)
    profiler.note_kernel(2.0 * N * F,
                         F * N + 12 * N + 8 * n_nodes * F * n_bins)
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
    _count_launch(histogram_fused)
    profiler.note_kernel(2.0 * N * F, 4 * N * F + 8 * N + 8 * F * n_bins)
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


def levelwise_node_words(feature, threshold):
    """The level-wise kernel's packed nodes: (T, K, 2^depth - 1) int64
    words feature | threshold << 8 (16 bits), as csrc/gbdt_predict.cu
    stages them."""
    return feature.long() | threshold.long() << 8


def quant_levelwise_kernel_arithmetic(bins_t, feature, threshold, leaf,
                                      depth: int):
    """What the level-wise CUDA kernel computes, in plain PyTorch: the heap
    descent over :func:`levelwise_node_words` (node h's children are 2h + 1
    and 2h + 2; a row goes right where its bin shifted to the threshold's
    byte, bin << 8, exceeds the whole word), each tree's leaf added in tree
    order from 0. Equal to :func:`quant_levelwise_reference` bit for bit;
    for the tests and the chip smoke run, not the main path."""
    _check_tables(bins_t, feature, threshold, leaf, depth)
    T, K, nn = feature.shape
    n = bins_t.shape[1]
    words = levelwise_node_words(feature, threshold)
    lf = leaf.float()
    out = torch.zeros((n, K), dtype=torch.float32, device=bins_t.device)
    for t in range(T):
        for k in range(K):
            h = torch.zeros(n, dtype=torch.long, device=bins_t.device)
            for _ in range(depth):
                w = words[t, k][h]
                b = bins_t.gather(0, (w & 0xFF)[None, :])[0].long() << 8
                h = 2 * h + torch.where(b > w, 2, 1)
            out[:, k] += lf[t, k][h - nn]
    return out


def _predict_bytes(bins_t, out, *tables) -> int:
    """A predict's least traffic: the bins and the tables read once, the
    output written once."""
    return (bins_t.shape[0] * bins_t.shape[1] + out.numel() * 4
            + sum(x.numel() * x.element_size() for x in tables))


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
    if bins_t.dtype != torch.uint8 or not unit_row_stride(bins_t):
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
    _count_launch(gbdt_predict_quant_levelwise)
    # a compare per level and an add per (row, tree, class)
    profiler.note_kernel(float(n) * T * K * (depth + 1),
                         _predict_bytes(bins_t, out, feature, threshold,
                                        leaf))
    return out


gbdt_predict_quant_levelwise.launches = 0


def _check_lw_tables(bins_t, split_leaf, feature, threshold, leaf):
    if bins_t.dim() != 2 or split_leaf.dim() != 3:
        raise ValueError("bins_t must be (d, n) and the tables (T, K, R)")
    T, K, R = split_leaf.shape
    if feature.shape != split_leaf.shape \
            or threshold.shape != split_leaf.shape \
            or tuple(leaf.shape) != (T, K, R + 1):
        raise ValueError(
            f"leaf-wise tables disagree: split_leaf {tuple(split_leaf.shape)}"
            f", feature {tuple(feature.shape)}, threshold "
            f"{tuple(threshold.shape)}, leaf {tuple(leaf.shape)} (want R + 1 "
            f"leaves)")
    if not 1 <= R <= PREDICT_QUANT_MAX_NODES \
            or R + 1 > PREDICT_QUANT_MAX_LEAVES:
        raise ValueError(f"{R} split rounds exceed the kernel's caps "
                         f"({PREDICT_QUANT_MAX_NODES} rounds, "
                         f"{PREDICT_QUANT_MAX_LEAVES} leaves)")
    if not (bins_t.device == split_leaf.device == feature.device
            == threshold.device == leaf.device):
        raise ValueError("bins_t and the tables on different devices")


def quant_leafwise_reference(bins_t, split_leaf, feature, threshold, leaf):
    """Plain PyTorch version of :func:`gbdt_predict_quant_leafwise`: each
    tree's split sequence replayed round by round, summing each tree's leaf
    in tree order from 0 (the kernel's order, so the two agree bit for
    bit). It repeats the numeric arm of leafwise._replay_lw_streaming on
    purpose: the kernel's check stays independent of the model code that
    the kernel serves."""
    T, K, R = split_leaf.shape
    n = bins_t.shape[1]
    dev = bins_t.device
    sl = split_leaf.long()
    feat = feature.long()
    thr = threshold.long()
    lf = leaf.float()
    out = torch.zeros((n, K), dtype=torch.float32, device=dev)
    for t in range(T):
        for k in range(K):
            pos = torch.zeros(n, dtype=torch.long, device=dev)
            for r in range(R):
                vals = bins_t.index_select(0, feat[t, k, r:r + 1])[0]
                right = (pos == sl[t, k, r]) & (vals.long() > thr[t, k, r])
                pos = torch.where(right, r + 1, pos)
            out[:, k] += lf[t, k][pos]
    return out


def leafwise_node_words(split_leaf, feature, threshold):
    """The leaf-wise kernel's pointer trees, as csrc/gbdt_predict.cu builds
    them in each block: (T, K, 2R + 2) int64 words of 32 bits, feature |
    threshold << 8 | left << 16 | right << 24, each child a word index. Word 0
    is the entry, a node that always goes left (threshold 255), to the
    root; word 1 + r round r's node; word R + 1 + l leaf l, a node whose
    children are itself. With next(r, v) the first round after r that
    splits leaf v: the root is next(-1, 0), left(r) = next(r,
    split_leaf[r]) else leaf split_leaf[r], right(r) = next(r, r + 1) else
    leaf r + 1 (a no-op round's left is leaf 0; nothing reaches it)."""
    T, K, R = split_leaf.shape
    dev = split_leaf.device
    nl = R + 1
    s = split_leaf.long()
    r = torch.arange(R, device=dev)
    left = nl + torch.where((s >= 0) & (s <= R), s, 0)
    right = (nl + r + 1).expand(T, K, R).clone()
    root = torch.full((T, K), nl, dtype=torch.long, device=dev)
    # from the last round down: the first later match is written last
    for rp in range(R - 1, -1, -1):
        v = s[:, :, rp:rp + 1]
        later = r < rp
        left = torch.where(later & (s == v), rp + 1, left)
        right = torch.where(later & (v == r + 1), rp + 1, right)
        root = torch.where(v[:, :, 0] == 0, rp + 1, root)
    nodes = (feature.long() | threshold.long() << 8 | left << 16
             | right << 24)
    leaves = (0xFF00 | (nl + torch.arange(nl, device=dev)) * 0x01010000
              ).expand(T, K, nl)
    entry = 0xFF00 | root * 0x01010000
    return torch.cat([entry[:, :, None], nodes, leaves], dim=2)


def leafwise_path_lengths(bins_t, words):
    """(T, K, n) rounds each row visits per tree, walking the pointer trees
    of :func:`leafwise_node_words` as the kernel does (a row goes right
    where its bin << 8 exceeds the word's low 16 bits, threshold << 8 |
    feature), and the (T, K, n) leaf each row ends on."""
    T, K, nw = words.shape
    R = nw // 2 - 1
    n = bins_t.shape[1]
    dev = bins_t.device
    steps = torch.zeros((T, K, n), dtype=torch.long, device=dev)
    leaves = torch.zeros((T, K, n), dtype=torch.long, device=dev)
    for t in range(T):
        for k in range(K):
            tw = words[t, k]
            c = torch.zeros(n, dtype=torch.long, device=dev)
            for _ in range(R + 1):
                w = tw[c]
                b = bins_t.gather(0, (w & 0xFF)[None, :])[0].long()
                c = torch.where(b << 8 > (w & 0xFFFF), w >> 24,
                                (w >> 16) & 0xFF)
                on = c <= R
                if not bool(on.any()):
                    break
                steps[t, k] += on.long()
            leaves[t, k] = c - (R + 1)
    return steps, leaves


def quant_leafwise_kernel_arithmetic(bins_t, split_leaf, feature, threshold,
                                     leaf):
    """What the leaf-wise CUDA kernel computes, in plain PyTorch: each
    tree's split sequence turned into :func:`leafwise_node_words`, each row
    walked down its path to a leaf, the leaves added in tree order from 0.
    Equal to :func:`quant_leafwise_reference` bit for bit; for the tests
    and the chip smoke run, not the main path."""
    _check_lw_tables(bins_t, split_leaf, feature, threshold, leaf)
    T, K, _ = split_leaf.shape
    n = bins_t.shape[1]
    words = leafwise_node_words(split_leaf, feature, threshold)
    _, leaves = leafwise_path_lengths(bins_t, words)
    lf = leaf.float()
    out = torch.zeros((n, K), dtype=torch.float32, device=bins_t.device)
    for t in range(T):
        for k in range(K):
            out[:, k] += lf[t, k][leaves[t, k]]
    return out


def gbdt_predict_quant_leafwise(bins_t, split_leaf, feature, threshold,
                                leaf):
    """Quantized leaf-wise ensemble predict: one launch scores every tree.

    bins_t (d, n) uint8 — the transposed bin matrix; split_leaf (T, K, R)
    int32 — the leaf each round splits, -1 for a no-op round; feature and
    threshold (T, K, R) uint8 (threshold 255 routes nothing right); leaf
    (T, K, R + 1) float32 — the bf16 or int8 table widened. Numeric splits
    only (categorical bitsets stay on the dense path). Returns (n, K)
    float32, the summed leaves without the base score."""
    _check_lw_tables(bins_t, split_leaf, feature, threshold, leaf)
    if bins_t.device.type == "cpu":
        return quant_leafwise_reference(bins_t, split_leaf, feature,
                                        threshold, leaf)
    if bins_t.device.type != "cuda":
        raise ValueError(f"gbdt_predict_quant_leafwise runs on cuda or cpu "
                         f"tensors, not {bins_t.device}")
    d, n = bins_t.shape
    T, K, R = split_leaf.shape
    if bins_t.dtype != torch.uint8 or not unit_row_stride(bins_t):
        raise ValueError("the CUDA kernel reads uint8 bins_t with unit row "
                         "stride")
    if split_leaf.dtype != torch.int32 or feature.dtype != torch.uint8 \
            or threshold.dtype != torch.uint8 or leaf.dtype != torch.float32:
        raise ValueError("the CUDA kernel takes int32 split_leaf, uint8 "
                         "feature/threshold and float32 leaf tables")
    if not 1 <= d <= 256:
        raise ValueError(f"the CUDA kernel takes 1..256 features, not {d}")
    out = torch.zeros((n, K), dtype=torch.float32, device=bins_t.device)
    if n == 0 or T == 0:
        return out
    split_leaf, feature, threshold, leaf = (
        x.contiguous() for x in (split_leaf, feature, threshold, leaf))
    if int(feature.max()) >= d:
        raise ValueError(f"feature ids must be < {d}")
    from . import _build
    lib = _build.load("gbdt_predict", _C_PREDICT)
    with torch.cuda.device(bins_t.device):
        rc = lib.mmlspark_gbdt_predict_quant_leafwise(
            bins_t.data_ptr(), bins_t.stride(0), split_leaf.data_ptr(),
            feature.data_ptr(), threshold.data_ptr(), leaf.data_ptr(),
            out.data_ptr(), n, d, T, K, R,
            torch.cuda.current_stream(bins_t.device).cuda_stream)
    _raise_on(rc, lib, "gbdt_predict_quant_leafwise")
    _count_launch(gbdt_predict_quant_leafwise)
    # the walk's length depends on the data: the profiler takes the most,
    # a compare per round and an add per (row, tree, class)
    profiler.note_kernel(float(n) * T * K * (R + 1),
                         _predict_bytes(bins_t, out, split_leaf, feature,
                                        threshold, leaf))
    return out


gbdt_predict_quant_leafwise.launches = 0
