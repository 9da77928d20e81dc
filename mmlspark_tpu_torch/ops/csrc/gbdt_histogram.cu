// GBDT gradient/hessian histograms for Hopper (sm_90a), without atomics.
//
// Replaces two Pallas kernels of mmlspark_tpu/ops/pallas_kernels.py:
//   mode 0, _node_hist_kernel (mxu_node_histogram): per-(node, feature, bin)
//     sums from the transposed uint8 bin matrix bins_t (F, N), node ids
//     (N,) and g/h (N,); a row whose node id is outside [0, n_nodes) or
//     whose bin is >= nb adds nothing. Output (n_nodes, F, nb).
//   mode 1, _hist_kernel (histogram_fused): per-(feature, id) sums from an
//     int32 (N, F) id matrix (the engine passes node * max_bin + bin); ids
//     outside [0, n_keys) add nothing. Output (F, n_keys).
//
// Both are the same computation over a key space: row i of feature f adds
// (g[i], h[i]) to key k(i, f) of that feature. The TPU kernels carry the
// sums across a sequential grid axis, which is deterministic. CUDA blocks
// run in no order, and float atomics would make each sum depend on the
// order of arrival, so a near-tie in the split search could pick another
// split from one run to the next. Here every sum is taken in an order fixed
// by the shapes alone, so the same inputs give the same bits on every run,
// and in double precision, rounded to float once at the end: each output is
// the float32 sum correctly rounded (to within double's rounding), whatever
// the order, so the port's plain versions — scatter-adds accumulated in
// float64 the same way — agree with it in all but the last-bit double
// rounding of one sum in millions, and a fit through either grows the same
// trees.
//   1. hist_partial: block (f, key group, row split) owns keys
//      [k0, k0 + key_range) of feature f over one contiguous row range.
//      Each of its 8 warps keeps a private (g, h) sub-histogram of those
//      keys in shared memory and walks its own rows in groups of 32. Lanes
//      holding the same key are found with __match_any_sync and summed in
//      ascending lane order by shuffles; the lowest such lane adds the sum
//      to its warp's sub-histogram (one writer per key per warp, no race).
//      A warp starts the loads of 4 groups of 32 rows before combining
//      them, so their latencies overlap.
//      At the end the 8 sub-histograms are summed in warp order and written
//      to a partial (split, f, 2, n_keys) buffer.
//   2. hist_reduce: sums the partials over the splits in split order and
//      writes the output layout.
// What bounds it: the bins are read once per key group (1 group at the
// root, 8 at 16 nodes of 255 bins), node/g/h once per group from L2; the
// work per row and feature is a handful of warp intrinsics, __match_any_sync
// the dearest, so instruction throughput bounds it far above the byte
// bound. Rows are split so that the grid holds about eight blocks per SM
// even at the root, where there are only F blocks of keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int UNROLL = 4;  // groups of 32 rows loaded at once per warp

// key of row i for feature f, or -1 when the row adds nothing
template <int MODE>
__device__ __forceinline__ int row_key(const void* bins, const int* node,
                                       long long ld, int f, long long i,
                                       int nb, int n_nodes, int n_keys) {
  if (MODE == 0) {
    const int b = static_cast<const uint8_t*>(bins)[(long long)f * ld + i];
    const int nd = node[i];
    return (nd >= 0 && nd < n_nodes && b < nb) ? nd * nb + b : -1;
  }
  const int b = static_cast<const int*>(bins)[i * ld + f];
  return (b >= 0 && b < n_keys) ? b : -1;
}

// one group of 32 rows into the warp's sub-histogram: the lanes holding
// the same key sum their values in ascending lane order (the lanes without a
// key take part in the shuffles and sum nothing), and the lowest of them
// adds the sum, so each key has one writer
__device__ __forceinline__ void add_group(double* sg, double* sh, int key,
                                          float gv, float hv, int lane) {
  if (__ballot_sync(FULL_MASK, key >= 0) == 0u) return;
  const unsigned peers = __match_any_sync(FULL_MASK, key);
  unsigned rest = key >= 0 ? peers : 0u;
  const int most = __reduce_max_sync(FULL_MASK, (unsigned)__popc(rest));
  double tg = 0.0, th = 0.0;
  for (int it = 0; it < most; ++it) {
    const int src = rest ? __ffs(rest) - 1 : lane;
    const float a = __shfl_sync(FULL_MASK, gv, src);
    const float b = __shfl_sync(FULL_MASK, hv, src);
    if (rest) {
      tg += a;
      th += b;
      rest &= rest - 1;
    }
  }
  if (key >= 0 && lane == __ffs(peers) - 1) {
    sg[key] += tg;
    sh[key] += th;
  }
  __syncwarp();
}

template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
    hist_partial(const void* __restrict__ bins, const int* __restrict__ node,
                 const float* __restrict__ g, const float* __restrict__ h,
                 double* __restrict__ part, long long n_rows, long long ld,
                 int n_feat, int nb, int n_nodes, int n_keys, int key_range,
                 long long rows_per_split) {
  extern __shared__ double sub[];  // [warp][g | h][key_range]
  const int f = blockIdx.x;
  const int k0 = blockIdx.y * key_range;
  const int kr = min(key_range, n_keys - k0);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j = threadIdx.x; j < warps * 2 * key_range; j += blockDim.x)
    sub[j] = 0.0;
  __syncthreads();

  double* sg = sub + warp * 2 * key_range;
  double* sh = sg + key_range;
  const long long r0 = (long long)blockIdx.z * rows_per_split;
  const long long r1 = min(n_rows, r0 + rows_per_split);
  // each warp takes UNROLL x 32 rows at a time: their loads all start
  // before the first group is combined. base is the same for every lane of
  // the warp, so the loop is warp-uniform.
  for (long long base = r0 + (long long)warp * 32 * UNROLL; base < r1;
       base += (long long)blockDim.x * UNROLL) {
    int key[UNROLL];
    float gv[UNROLL], hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * 32 + lane;
      key[u] = -1;
      gv[u] = hv[u] = 0.f;
      if (i < r1) {
        const int k = row_key<MODE>(bins, node, ld, f, i, nb, n_nodes, n_keys);
        gv[u] = g[i];
        hv[u] = h[i];
        if (k >= k0 && k < k0 + kr) key[u] = k - k0;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      add_group(sg, sh, key[u], gv[u], hv[u], lane);
  }
  __syncthreads();

  double* dst = part + ((long long)blockIdx.z * n_feat + f) * 2 * n_keys;
  for (int j = threadIdx.x; j < kr; j += blockDim.x) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < warps; ++w) {
      a += sub[w * 2 * key_range + j];
      b += sub[w * 2 * key_range + key_range + j];
    }
    dst[k0 + j] = a;
    dst[n_keys + k0 + j] = b;
  }
}

// out[...] = sum over splits, in split order, of the partials, rounded once
template <int MODE>
__global__ void hist_reduce(const double* __restrict__ part,
                           float* __restrict__ out_g,
                           float* __restrict__ out_h, int n_splits,
                           int n_feat, int n_keys, int nb) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_feat * n_keys) return;
  const int f = (int)(idx / n_keys), k = (int)(idx % n_keys);
  double a = 0.0, b = 0.0;
  for (int s = 0; s < n_splits; ++s) {
    const double* p = part + ((long long)s * n_feat + f) * 2 * n_keys;
    a += p[k];
    b += p[n_keys + k];
  }
  // mode 0: key = node * nb + bin -> (node, f, bin); mode 1: (f, key)
  const long long o = MODE == 0
                          ? ((long long)(k / nb) * n_feat + f) * nb + k % nb
                          : (long long)f * n_keys + k;
  out_g[o] = static_cast<float>(a);
  out_h[o] = static_cast<float>(b);
}

template <int MODE>
int launch(const void* bins, const int* node, const float* g, const float* h,
           double* part, float* out_g, float* out_h, long long n_rows,
           long long ld, int n_feat, int nb, int n_nodes, int n_keys,
           int key_range, int n_splits, long long rows_per_split,
           int threads, cudaStream_t s) {
  const int smem = threads / 32 * 2 * key_range * (int)sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      hist_partial<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_feat, (n_keys + key_range - 1) / key_range, n_splits);
  hist_partial<MODE><<<grid, threads, smem, s>>>(
      bins, node, g, h, part, n_rows, ld, n_feat, nb, n_nodes, n_keys,
      key_range, rows_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)n_feat * n_keys;
  hist_reduce<MODE><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part, out_g, out_h, n_splits, n_feat, n_keys, nb);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: bins (F, ld) uint8, node (N,) int32, n_keys = n_nodes * nb,
//         out (n_nodes, F, nb); mode 1: bins (N, ld) int32, node unused,
//         out (F, n_keys). part: (n_splits, F, 2, n_keys) double scratch.
extern "C" int mmlspark_gbdt_histogram(
    int mode, const void* bins, const void* node, const void* g,
    const void* h, void* part, void* out_g, void* out_h, long long n_rows,
    long long ld, int n_feat, int nb, int n_nodes, int n_keys, int key_range,
    int n_splits, long long rows_per_split, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nd = static_cast<const int*>(node);
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  double* p = static_cast<double*>(part);
  float* og = static_cast<float*>(out_g);
  float* oh = static_cast<float*>(out_h);
  if (n_feat <= 0 || n_keys <= 0 || key_range <= 0 || n_splits <= 0 ||
      n_splits > 65535 || rows_per_split <= 0 || threads % 32 != 0 ||
      threads < 32 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return launch<0>(bins, nd, gf, hf, p, og, oh, n_rows, ld, n_feat, nb,
                     n_nodes, n_keys, key_range, n_splits, rows_per_split,
                     threads, s);
  if (mode == 1)
    return launch<1>(bins, nd, gf, hf, p, og, oh, n_rows, ld, n_feat, nb,
                     n_nodes, n_keys, key_range, n_splits, rows_per_split,
                     threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
