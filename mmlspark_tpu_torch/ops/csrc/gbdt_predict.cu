// Quantized GBDT ensemble predict for Hopper (sm_90a): level-wise and
// leaf-wise.
//
// Replaces _gbdt_quant_lvl_kernel (gbdt_predict_quant_levelwise) and
// _gbdt_quant_lw_kernel (gbdt_predict_quant_leafwise) of
// mmlspark_tpu/ops/pallas_kernels.py: the summed leaf value of every tree
// for each row, over structure-of-arrays uint8 tables.
//
// Level-wise, by heap descent:
//   bins_t    (d, n) uint8, row stride ld   the transposed bin matrix
//   feature   (T, K, 2^depth - 1) uint8     split feature per node
//   threshold (T, K, 2^depth - 1) uint8     go right when bin > threshold;
//                                           255 routes every row left
//   leaf      (T, K, 2^depth) float         leaf values (the bf16 or int8
//                                           table, widened by the caller)
//   out       (n, K) float                  sum over trees, base excluded
// Leaf-wise, by replaying each tree's split sequence: round r splits leaf
// split_leaf[r] (-1: a no-op round) and its right child becomes leaf r + 1.
//   split_leaf (T, K, R) int32; feature, threshold (T, K, R) uint8;
//   leaf (T, K, R + 1) float; out (n, K) float, as above. Per tree a row
//   starts at pos 0; at round r, if pos == split_leaf[r] and
//   bin[feature[r]] > threshold[r], pos becomes r + 1; then leaf[pos].
// Each thread scores one row. A block of 256 rows first copies its rows'
// d bins into shared memory (one coalesced load per feature), as the TPU
// kernels keep their row block in VMEM, and, when they fit, the whole
// ensemble's tables too (100 trees of depth 5 take 19 KB; 100 leaf-wise
// trees of 31 leaves 30 KB); every tree then walks those bytes. The sums
// run over the trees in order from 0, as the TPU kernels' fori_loop does,
// so a row's score is the same bits on every run.
// What bounds it: the bin matrix is read once (n * d bytes) and the output
// written once; each block reads the tables once more from L2. The walk is
// T * K chains of depth (level-wise) or R (leaf-wise) dependent
// shared-memory loads and compares per row, so at 100 trees latency and
// instruction throughput bound it far above the byte bound. A leaf-wise
// round whose leaf a row is not in reads no bin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRED_THREADS = 256;
// tables up to this many bytes go to shared memory beside the rows
constexpr int SMEM_TABLE_BYTES = 96 * 1024;

__host__ __device__ __forceinline__ long long row_bytes(int d) {
  return ((long long)d * PRED_THREADS + 15) / 16 * 16;
}

// rows[f * PRED_THREADS + t] = bin of feature f for the block's row t
__device__ __forceinline__ void stage_rows(uint8_t* rows,
                                           const uint8_t* __restrict__ bins_t,
                                           long long ld, long long i,
                                           long long n, int d) {
  const int t = threadIdx.x;
  for (int f = 0; f < d; ++f)
    rows[f * PRED_THREADS + t] = i < n ? bins_t[(long long)f * ld + i] : 0;
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
  stage_rows(rows, bins_t, ld, i, n, d);
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
__global__ void __launch_bounds__(PRED_THREADS)
    quant_leafwise(const uint8_t* __restrict__ bins_t, long long ld,
                   const int* __restrict__ split_leaf,
                   const uint8_t* __restrict__ feature,
                   const uint8_t* __restrict__ threshold,
                   const float* __restrict__ leaf, float* __restrict__ out,
                   long long n, int d, int n_trees, int n_class,
                   int n_rounds) {
  // [feature][row of the block] bins, then leaf, split, feature, threshold
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* rows = smem;
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * PRED_THREADS + t;
  const int n_leaves = n_rounds + 1;
  stage_rows(rows, bins_t, ld, i, n, d);
  const float* lf = leaf;
  const int* sp = split_leaf;
  const uint8_t* ft = feature;
  const uint8_t* tt = threshold;
  if (SMEM_TABLES) {
    const int n_tab = n_trees * n_class;
    float* sl = reinterpret_cast<float*>(smem + row_bytes(d));
    int* ss = reinterpret_cast<int*>(sl + n_tab * n_leaves);
    uint8_t* sf = reinterpret_cast<uint8_t*>(ss + n_tab * n_rounds);
    uint8_t* st = sf + n_tab * n_rounds;
    for (int j = t; j < n_tab * n_leaves; j += PRED_THREADS) sl[j] = leaf[j];
    for (int j = t; j < n_tab * n_rounds; j += PRED_THREADS) {
      ss[j] = split_leaf[j];
      sf[j] = feature[j];
      st[j] = threshold[j];
    }
    lf = sl;
    sp = ss;
    ft = sf;
    tt = st;
  }
  __syncthreads();
  if (i >= n) return;
  for (int k = 0; k < n_class; ++k) {
    float acc = 0.f;
    for (int tree = 0; tree < n_trees; ++tree) {
      const long long tk = (long long)tree * n_class + k;
      const int* ts = sp + tk * n_rounds;
      const uint8_t* tf = ft + tk * n_rounds;
      const uint8_t* th = tt + tk * n_rounds;
      int pos = 0;
      for (int r = 0; r < n_rounds; ++r) {
        // -1 (a no-op round) never equals a position
        if (pos == ts[r] && (int)rows[(int)tf[r] * PRED_THREADS + t] >
                                (int)th[r])
          pos = r + 1;
      }
      acc += lf[tk * n_leaves + pos];
    }
    out[i * n_class + k] = acc;
  }
}

// Raises the kernel's dynamic shared memory to smem bytes and launches it
// over ceil(n / PRED_THREADS) blocks of PRED_THREADS rows.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long n, int smem, cudaStream_t s,
           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n + PRED_THREADS - 1) / PRED_THREADS;
  kernel<<<(unsigned)blocks, PRED_THREADS, smem, s>>>(args...);
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
    return launch(quant_levelwise<true>, n, (int)(row_bytes(d) + tables), s,
                  b, ld, f, th, l, o, n, d, n_trees, n_class, depth);
  return launch(quant_levelwise<false>, n, (int)row_bytes(d), s, b, ld, f,
                th, l, o, n, d, n_trees, n_class, depth);
}

// feature ids must be < d (the wrapper checks); 1 <= R <= 127 rounds
// (PREDICT_QUANT_MAX_NODES), so at most 128 leaves
extern "C" int mmlspark_gbdt_predict_quant_leafwise(
    const void* bins_t, long long ld, const void* split_leaf,
    const void* feature, const void* threshold, const void* leaf, void* out,
    long long n, int d, int n_trees, int n_class, int n_rounds,
    void* stream) {
  if (d <= 0 || d > 256 || n_rounds < 1 || n_rounds > 127 || n_trees < 0 ||
      n_class <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tables = (long long)n_trees * n_class *
                           (6LL * n_rounds + 4LL * (n_rounds + 1));
  const auto* b = static_cast<const uint8_t*>(bins_t);
  const auto* sl = static_cast<const int*>(split_leaf);
  const auto* f = static_cast<const uint8_t*>(feature);
  const auto* th = static_cast<const uint8_t*>(threshold);
  const auto* l = static_cast<const float*>(leaf);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables <= SMEM_TABLE_BYTES)
    return launch(quant_leafwise<true>, n, (int)(row_bytes(d) + tables), s,
                  b, ld, sl, f, th, l, o, n, d, n_trees, n_class, n_rounds);
  return launch(quant_leafwise<false>, n, (int)row_bytes(d), s, b, ld, sl, f,
                th, l, o, n, d, n_trees, n_class, n_rounds);
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
