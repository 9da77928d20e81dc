// Quantized level-wise GBDT ensemble predict for Hopper (sm_90a).
//
// Replaces _gbdt_quant_lvl_kernel (gbdt_predict_quant_levelwise) of
// mmlspark_tpu/ops/pallas_kernels.py: the summed leaf value of every tree
// for each row, by heap descent over structure-of-arrays uint8 tables.
//   bins_t    (d, n) uint8, row stride ld   the transposed bin matrix
//   feature   (T, K, 2^depth - 1) uint8     split feature per node
//   threshold (T, K, 2^depth - 1) uint8     go right when bin > threshold;
//                                           255 routes every row left
//   leaf      (T, K, 2^depth) float         leaf values (the bf16 or int8
//                                           table, widened by the caller)
//   out       (n, K) float                  sum over trees, base excluded
// Each thread scores one row. A block of 256 rows first copies its rows'
// d bins into shared memory (one coalesced load per feature), as the TPU
// kernel keeps its row block in VMEM, and, when they fit, the whole
// ensemble's tables too (100 trees of depth 5 take 19 KB); every tree then
// walks those bytes. The sums run over the trees in order from 0, as the
// TPU kernel's fori_loop does, so a row's score is the same bits on every
// run.
// What bounds it: the bin matrix is read once (n * d bytes) and the output
// written once; each block reads the tables once more from L2. The walk is
// T * K chains of depth dependent shared-memory loads per row, so at 100
// trees latency and instruction throughput bound it far above the byte
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRED_THREADS = 256;
// tables up to this many bytes go to shared memory beside the rows
constexpr int SMEM_TABLE_BYTES = 96 * 1024;

__host__ __device__ __forceinline__ long long row_bytes(int d) {
  return ((long long)d * PRED_THREADS + 15) / 16 * 16;
}

template <bool SMEM_TABLES>
__global__ void __launch_bounds__(PRED_THREADS)
    quant_levelwise(const uint8_t* __restrict__ bins_t, long long ld,
                    const uint8_t* __restrict__ feature,
                    const uint8_t* __restrict__ threshold,
                    const float* __restrict__ leaf, float* __restrict__ out,
                    long long n, int d, int n_trees, int n_class, int depth) {
  // [feature][row of the block] bins, then leaf, feature, threshold tables
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* rows = smem;
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * PRED_THREADS + t;
  const int n_nodes = (1 << depth) - 1, n_leaves = 1 << depth;
  for (int f = 0; f < d; ++f)
    rows[f * PRED_THREADS + t] = i < n ? bins_t[(long long)f * ld + i] : 0;
  const float* lf = leaf;
  const uint8_t* ft = feature;
  const uint8_t* tt = threshold;
  if (SMEM_TABLES) {
    const int n_tab = n_trees * n_class;
    float* sl = reinterpret_cast<float*>(smem + row_bytes(d));
    uint8_t* sf = reinterpret_cast<uint8_t*>(sl + n_tab * n_leaves);
    uint8_t* st = sf + n_tab * n_nodes;
    for (int j = t; j < n_tab * n_leaves; j += PRED_THREADS) sl[j] = leaf[j];
    for (int j = t; j < n_tab * n_nodes; j += PRED_THREADS) {
      sf[j] = feature[j];
      st[j] = threshold[j];
    }
    lf = sl;
    ft = sf;
    tt = st;
  }
  __syncthreads();
  if (i >= n) return;
  for (int k = 0; k < n_class; ++k) {
    float acc = 0.f;
    for (int tree = 0; tree < n_trees; ++tree) {
      const long long tk = (long long)tree * n_class + k;
      const uint8_t* tf = ft + tk * n_nodes;
      const uint8_t* th = tt + tk * n_nodes;
      int pos = 0;
      for (int level = 0; level < depth; ++level) {
        const int node = (1 << level) - 1 + pos;
        const int b = rows[(int)tf[node] * PRED_THREADS + t];
        pos = pos * 2 + (b > (int)th[node] ? 1 : 0);
      }
      acc += lf[tk * n_leaves + pos];
    }
    out[i * n_class + k] = acc;
  }
}

template <bool SMEM_TABLES>
int launch(const uint8_t* bins_t, long long ld, const uint8_t* feature,
           const uint8_t* threshold, const float* leaf, float* out,
           long long n, int d, int n_trees, int n_class, int depth,
           int smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      quant_levelwise<SMEM_TABLES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n + PRED_THREADS - 1) / PRED_THREADS;
  quant_levelwise<SMEM_TABLES><<<(unsigned)blocks, PRED_THREADS, smem, s>>>(
      bins_t, ld, feature, threshold, leaf, out, n, d, n_trees, n_class,
      depth);
  return (int)cudaGetLastError();
}

}  // namespace

// feature ids must be < d (the wrapper checks); depth in [0, 7]
extern "C" int mmlspark_gbdt_predict_quant_levelwise(
    const void* bins_t, long long ld, const void* feature,
    const void* threshold, const void* leaf, void* out, long long n, int d,
    int n_trees, int n_class, int depth, void* stream) {
  if (d <= 0 || d > 256 || depth < 0 || depth > 7 || n_trees < 0 ||
      n_class <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tables = (long long)n_trees * n_class *
                           (2 * ((1 << depth) - 1) + 4 * (1 << depth));
  const auto* b = static_cast<const uint8_t*>(bins_t);
  const auto* f = static_cast<const uint8_t*>(feature);
  const auto* th = static_cast<const uint8_t*>(threshold);
  const auto* l = static_cast<const float*>(leaf);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables <= SMEM_TABLE_BYTES)
    return launch<true>(b, ld, f, th, l, o, n, d, n_trees, n_class, depth,
                        (int)(row_bytes(d) + tables), s);
  return launch<false>(b, ld, f, th, l, o, n, d, n_trees, n_class, depth,
                       (int)row_bytes(d), s);
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
