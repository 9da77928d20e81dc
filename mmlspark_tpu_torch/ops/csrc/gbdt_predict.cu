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
//   out       (n, K) float, zeroed          sum over trees, base excluded
// Leaf-wise, over each tree's split sequence: round r splits leaf
// split_leaf[r] (-1: a no-op round) and its right child becomes leaf r + 1.
//   split_leaf (T, K, R) int32; feature, threshold (T, K, R) uint8;
//   leaf (T, K, R + 1) float; out (n, K) float, as above. The replay that
//   defines it: per tree a row starts at pos 0; at round r, if pos ==
//   split_leaf[r] and bin[feature[r]] > threshold[r], pos becomes r + 1;
//   then leaf[pos].
// Each row's sum runs over the trees of its class in order from 0, one
// float add per tree, as the TPU kernels' fori_loop and the plain versions
// do, so the output is the plain version's bits on every run.
//
// What bounds it: the bins are read once (n * d bytes) and the output
// written once, 0.01 ms at 1M x 28; the walk is a chain of dependent
// shared-memory loads per (row, tree) with a few integer instructions
// around each, and with enough warps in flight to cover the loads' latency
// the instructions issued set the time. So the design spends as few
// instructions (and shared-memory wavefronts) per row and tree as it can:
//   * Packed nodes, one load a step. A level-wise node is one 16-bit word
//     (feature | threshold << 8), a leaf-wise node one 32-bit word (feature
//     | threshold << 8 | left << 16 | right << 24; the old form read the
//     split, feature, threshold and bin of every round).
//   * One compare a step. The staged bins are shifted to the threshold's
//     byte, bin << 8, so bin > threshold is the unsigned compare of the
//     shifted bin with the node's low 16 bits: the feature byte below the
//     threshold never decides it. Threshold 255 routes every row left.
//   * Path walks, leaf-wise. A block turns each tree's split sequence into
//     a pointer tree once, a warp per tree (each lane builds a few rounds
//     while the warp reads the split ids from the last round down, one
//     broadcast load a round): with next(r, v) the first round after r
//     that splits leaf v, the root is next(-1, 0), left(r) = next(r,
//     split_leaf[r]) else leaf split_leaf[r], right(r) = next(r, r + 1)
//     else leaf r + 1. The walk visits exactly the rounds at which the
//     replay's pos == split_leaf[r], in order, and ends on its final pos,
//     so a row pays its path's depth, not R rounds. No-op rounds, leaves
//     split again and again, rounds that name a leaf not made yet, and the
//     255 threshold all fall out of the rule. A tree's 2R + 2 words: word
//     0 a node that always goes left, to the root (a walk starts at its
//     child); words 1..R the rounds;
//     words R + 1 + l leaf l, a node whose children are itself. A child
//     byte is a word index, so a step has no branch: a row on a leaf stays
//     there, and the loop ends when every row of the thread is on one.
//   * Bins without bank conflicts. A tile of rows is staged as 16-bit
//     slots laid out [feature][row]: a warp's lanes read 32 consecutive
//     rows (64 bytes) of whatever features they need, one wavefront per
//     bin load. Coalesced 4-byte global loads (4 rows of one feature)
//     become 8-byte shared stores; the next tile's loads are issued before
//     the current tile's walk and stored after it. 16-bit slots (not 32)
//     leave room for three blocks an SM at 28 features, which the walks'
//     latency needs.
//   * A tree's words sit in consecutive shared words, so lanes on
//     different nodes of one tree seldom share a bank (leaf-wise, a word
//     and the word 32 after it do).
//   * Independent chains: each thread walks ROWS rows, interleaved, so
//     their dependent loads overlap; level-wise the descent is unrolled
//     for each depth.
//   * A persistent grid: as many blocks as fit on the SMs at once (three
//     or four of 256 threads at 28 features), each
//     staging (and converting) the tables once and then looping over row
//     tiles. Tables past TABLE_BYTES are taken in chunks of trees: each
//     chunk is staged once per block and the rows' sums go on from the
//     output, in tree order, so every ensemble runs through the same code
//     in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// rows each thread walks at once (independent load chains)
constexpr int ROWS = 2;
constexpr int MAX_THREADS = 256;
// a row tile's staged bins aim at this size (the tile's rows fall with d,
// down to one warp's worth); a chunk of trees' tables takes at most
// TABLE_BYTES beside them, so at least two blocks fit on an SM
constexpr long long BIN_BYTES = 64 * 1024;
constexpr int TABLE_BYTES = 48 * 1024;
// 4-row bin words per thread loaded ahead of the walk (d <= 32 at ROWS 2
// is staged entirely from these registers)
constexpr int PF = 16;

struct Plan {
  int tile_shift;  // rows per tile = 1 << tile_shift
  int threads;     // tile / ROWS
  int chunk;       // trees (of T * K) staged at once
  int smem;        // dynamic shared bytes
  int blocks;
};

// The 4 bins of feature f for rows i..i+3: one 4-byte load where the
// matrix is 4-byte aligned and the rows lie inside n, else bytes (0 past
// n).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ bins_t,
                                          long long ld, int f, long long i,
                                          long long n, bool aligned) {
  const uint8_t* p = bins_t + (long long)f * ld + i;
  if (aligned && i + 3 < n)
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (i + q < n) v |= (uint32_t)__ldg(p + q) << (8 * q);
  return v;
}

// Staging of one row tile into bins_s[f * tile + row], 16-bit slots
// holding bin << 8. Item idx covers feature idx >> (tile_shift - 2) and
// rows 4 * (idx & (tile/4 - 1)) .. + 3.
struct Stager {
  const uint8_t* bins_t;
  long long ld, n;
  int d, tile_shift;
  bool aligned;

  __device__ __forceinline__ int items() const {
    return d << (tile_shift - 2);
  }
  __device__ __forceinline__ uint32_t load(int idx, long long row0) const {
    const int qs = tile_shift - 2;
    return load4(bins_t, ld, idx >> qs,
                 row0 + 4 * (idx & ((1 << qs) - 1)), n, aligned);
  }
  // item idx's 4 slots are the idx-th 8 bytes of bins_s: bytes 0-3 of v
  // into bytes 1 and 3 of two words
  __device__ __forceinline__ void store(uint16_t* bins_s, int idx,
                                        uint32_t v) const {
    reinterpret_cast<uint2*>(bins_s)[idx] =
        make_uint2(__byte_perm(v, 0, 0x1404), __byte_perm(v, 0, 0x3424));
  }
  // the first PF items of this thread, into registers
  __device__ __forceinline__ void prefetch(uint32_t (&pf)[PF],
                                           long long row0) const {
    const int m = items();
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int idx = threadIdx.x + k * blockDim.x;
      if (idx < m) pf[k] = load(idx, row0);
    }
  }
  // the prefetched items, then the rest loaded now
  __device__ __forceinline__ void commit(uint16_t* bins_s,
                                         const uint32_t (&pf)[PF],
                                         long long row0) const {
    const int m = items();
#pragma unroll
    for (int k = 0; k < PF; ++k) {
      const int idx = threadIdx.x + k * blockDim.x;
      if (idx < m) store(bins_s, idx, pf[k]);
    }
    for (int idx = threadIdx.x + PF * blockDim.x; idx < m; idx += blockDim.x)
      store(bins_s, idx, load(idx, row0));
  }
};

// Trees of class k in [t0, t1) of the (T, K) table order: the first, then
// every K-th.
__device__ __forceinline__ int first_of_class(int t0, int k, int K) {
  return t0 + ((k - t0 % K) % K + K) % K;
}

// The row tiles of this block, chunk by chunk of trees. convert(t0, t1)
// stages a chunk's tables; walk(row0, t0, t1) scores one staged tile.
template <typename St, typename Convert, typename Walk>
__device__ __forceinline__ void run_tiles(const St& st, uint16_t* bins_s,
                                          int n_tab, int chunk,
                                          Convert convert, Walk walk) {
  const long long n_tiles = (st.n + (1LL << st.tile_shift) - 1)
                            >> st.tile_shift;
  uint32_t pf[PF];
  for (int t0 = 0; t0 < n_tab; t0 += chunk) {
    const int t1 = min(n_tab, t0 + chunk);
    __syncthreads();  // the last chunk's walks are done with the tables
    convert(t0, t1);
    long long tile = blockIdx.x;
    st.prefetch(pf, tile << st.tile_shift);
    for (; tile < n_tiles; tile += gridDim.x) {
      const long long row0 = tile << st.tile_shift;
      __syncthreads();  // the last tile's walks are done with bins_s
      st.commit(bins_s, pf, row0);
      __syncthreads();  // bins_s (and the chunk's tables) are in place
      if (tile + gridDim.x < n_tiles)
        st.prefetch(pf, (tile + gridDim.x) << st.tile_shift);
      walk(row0, t0, t1);
    }
  }
}

// The row slots of thread slot q: bins_s + threadIdx.x + q * blockDim.x.
__device__ __forceinline__ void row_slots(const uint16_t* bins_s,
                                          long long row0,
                                          const char* (&rb)[ROWS],
                                          long long (&row)[ROWS]) {
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const int r = threadIdx.x + q * blockDim.x;
    rb[q] = reinterpret_cast<const char*>(bins_s + r);
    row[q] = row0 + r;
  }
}

// The sums of one staged tile for class k over trees [first, t1) step K:
// acc starts at 0 in the first chunk, else from out; tree(j, acc) adds
// tree t0 + j of the staged chunk.
template <typename Tree>
__device__ __forceinline__ void sum_class(float* __restrict__ out,
                                          const long long (&row)[ROWS],
                                          long long n, int t0, int t1, int k,
                                          int K, Tree tree) {
  const int first = first_of_class(t0, k, K);
  if (first >= t1) return;
  float acc[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q)
    acc[q] = (t0 > 0 && row[q] < n) ? out[row[q] * K + k] : 0.f;
  for (int tk = first; tk < t1; tk += K) tree(tk - t0, acc);
#pragma unroll
  for (int q = 0; q < ROWS; ++q)
    if (row[q] < n) out[row[q] * K + k] = acc[q];
}

template <int DEPTH>
__global__ void __launch_bounds__(MAX_THREADS, 3)
    quant_levelwise(const uint8_t* __restrict__ bins_t, long long ld,
                    bool aligned, const uint8_t* __restrict__ feature,
                    const uint8_t* __restrict__ threshold,
                    const float* __restrict__ leaf, float* __restrict__ out,
                    long long n, int d, int n_tab, int n_class,
                    int tile_shift, int chunk) {
  // bins (d * tile 16-bit slots), then the chunk's leaves and 16-bit nodes
  constexpr int nn = (1 << DEPTH) - 1, nl = 1 << DEPTH;
  extern __shared__ __align__(16) uint16_t smem[];
  const int tile = 1 << tile_shift;
  uint16_t* bins_s = smem;
  float* leaf_s = reinterpret_cast<float*>(smem + d * tile);
  uint16_t* node_s = reinterpret_cast<uint16_t*>(leaf_s + chunk * nl);
  const Stager st{bins_t, ld, n, d, tile_shift, aligned};

  auto convert = [&](int t0, int t1) {
    for (int j = threadIdx.x; j < (t1 - t0) * nl; j += blockDim.x)
      leaf_s[j] = __ldg(leaf + (long long)t0 * nl + j);
    for (int j = threadIdx.x; j < (t1 - t0) * nn; j += blockDim.x) {
      const long long g = (long long)t0 * nn + j;
      node_s[j] = (uint16_t)(__ldg(feature + g) |
                             (uint32_t)__ldg(threshold + g) << 8);
    }
  };
  const uint32_t tile2 = 2u * tile;  // bytes of one feature's slots
  auto walk = [&](long long row0, int t0, int t1) {
    const char* rb[ROWS];
    long long row[ROWS];
    row_slots(bins_s, row0, rb, row);
    auto tree = [&](int j, float (&acc)[ROWS]) {
      const char* tn = reinterpret_cast<const char*>(node_s + j * nn);
      // 2 h for heap node h, whose children are 2h + 1 and 2h + 2
      uint32_t h2[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) h2[q] = 0;
#pragma unroll
      for (int level = 0; level < DEPTH; ++level) {
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
          const uint32_t w = *reinterpret_cast<const uint16_t*>(tn + h2[q]);
          const uint32_t b = *reinterpret_cast<const uint16_t*>(
              rb[q] + (w & 0xffu) * tile2);
          h2[q] = 2 * h2[q] + (b > w ? 4 : 2);
        }
      }
#pragma unroll
      for (int q = 0; q < ROWS; ++q)
        acc[q] += leaf_s[j * nl + h2[q] / 2 - nn];
    };
    for (int k = 0; k < n_class; ++k)
      sum_class(out, row, n, t0, t1, k, n_class, tree);
  };
  run_tiles(st, bins_s, n_tab, chunk, convert, walk);
}

__global__ void __launch_bounds__(MAX_THREADS, 3)
    quant_leafwise(const uint8_t* __restrict__ bins_t, long long ld,
                   bool aligned, const int* __restrict__ split_leaf,
                   const uint8_t* __restrict__ feature,
                   const uint8_t* __restrict__ threshold,
                   const float* __restrict__ leaf, float* __restrict__ out,
                   long long n, int d, int n_tab, int n_class, int n_rounds,
                   int tile_shift, int chunk) {
  // bins (d * tile 16-bit slots), then per tree of the chunk 2R + 2 words
  // (the entry node, the rounds, the leaves) and R + 1 leaf values
  extern __shared__ __align__(16) uint16_t smem[];
  const int tile = 1 << tile_shift;
  const int R = n_rounds, nl = n_rounds + 1, nw = 2 * n_rounds + 2;
  uint16_t* bins_s = smem;
  uint32_t* word_s = reinterpret_cast<uint32_t*>(smem + d * tile);
  float* leaf_s = reinterpret_cast<float*>(word_s + chunk * nw);
  const Stager st{bins_t, ld, n, d, tile_shift, aligned};

  // a warp per tree: lane l builds rounds l, l + 32, l + 64, l + 96 while
  // the warp reads the tree's split ids from the last round down (one
  // broadcast load a round), so the first later match is written last
  auto convert = [&](int t0, int t1) {
    const int lane = threadIdx.x & 31;
    for (int tk = t0 + (int)(threadIdx.x >> 5); tk < t1;
         tk += blockDim.x >> 5) {
      const int* ts = split_leaf + (long long)tk * R;
      int s[4];
      uint32_t left[4], right[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = lane + 32 * m;
        s[m] = r < R ? __ldg(ts + r) : -1;
        // leaf l is word R + 1 + l (a round's own leaf where no later
        // round splits it; a no-op round's children are never reached)
        left[m] = (uint32_t)(nl + (s[m] >= 0 && s[m] <= R ? s[m] : 0));
        right[m] = (uint32_t)(nl + r + 1);
      }
      uint32_t root = (uint32_t)nl;  // leaf 0
      for (int rp = R - 1; rp >= 0; --rp) {
        const int v = __ldg(ts + rp);
        if (v == 0) root = rp + 1;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int r = lane + 32 * m;
          if (r < rp) {
            if (v == s[m]) left[m] = rp + 1;
            if (v == r + 1) right[m] = rp + 1;
          }
        }
      }
      const long long g = (long long)tk * R;
      uint32_t* tw = word_s + (tk - t0) * nw;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = lane + 32 * m;
        if (r < R)
          tw[1 + r] = (uint32_t)__ldg(feature + g + r) |
                      (uint32_t)__ldg(threshold + g + r) << 8 |
                      left[m] << 16 | right[m] << 24;
      }
      // the entry and the leaves: threshold 255, feature 0, so a row goes
      // left, to the root or to the leaf itself
      for (int l = lane; l <= nl; l += 32)
        tw[l == nl ? 0 : nl + l] =
            0xff00u | (l == nl ? root : (uint32_t)(nl + l)) * 0x01010000u;
      for (int l = lane; l < nl; l += 32)
        leaf_s[(tk - t0) * nl + l] = __ldg(leaf + (long long)tk * nl + l);
    }
  };
  const uint32_t tile2 = 2u * tile;  // bytes of one feature's slots
  auto walk = [&](long long row0, int t0, int t1) {
    const char* rb[ROWS];
    long long row[ROWS];
    row_slots(bins_s, row0, rb, row);
    auto tree = [&](int j, float (&acc)[ROWS]) {
      const uint32_t* tw = word_s + j * nw;
      const uint32_t root = tw[0] >> 24;  // the entry node's child
      uint32_t c[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS; ++q) c[q] = root;
      bool more = root <= (uint32_t)R;
      while (more) {  // some row of the thread is not on a leaf yet
        more = false;
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
          const uint32_t w = tw[c[q]];
          const uint32_t b = *reinterpret_cast<const uint16_t*>(
              rb[q] + (w & 0xffu) * tile2);
          c[q] = __byte_perm(w, 0, b > (w & 0xffffu) ? 0x4443u : 0x4442u);
          more |= c[q] <= (uint32_t)R;
        }
      }
#pragma unroll
      for (int q = 0; q < ROWS; ++q) acc[q] += leaf_s[j * nl + c[q] - nl];
    };
    for (int k = 0; k < n_class; ++k)
      sum_class(out, row, n, t0, t1, k, n_class, tree);
  };
  run_tiles(st, bins_s, n_tab, chunk, convert, walk);
}

// The tile (as many rows as fit BIN_BYTES of slots, 32 * ROWS to
// MAX_THREADS * ROWS), the chunk of trees, and a persistent grid of as
// many blocks as fit on the card at once (no more than there are tiles).
template <typename Kernel>
int plan(Kernel kernel, long long n, int d, int n_tab, int tree_bytes,
         Plan* p) {
  int shift = 0;
  while ((ROWS * MAX_THREADS) >> shift > 1) ++shift;  // log2 of the max
  int min_shift = 0;                                    // a warp, >= 64 rows
  while ((32 * ROWS) >> min_shift > 1 || min_shift < 6) ++min_shift;
  while (shift > min_shift && (2LL * d << shift) > BIN_BYTES) --shift;
  p->tile_shift = shift;
  p->threads = (1 << shift) / ROWS;
  p->chunk = n_tab < TABLE_BYTES / tree_bytes ? n_tab
                                              : TABLE_BYTES / tree_bytes;
  if (p->chunk < 1) p->chunk = 1;
  p->smem = (int)((2LL * d << shift) + 15) / 16 * 16 +
            (p->chunk * tree_bytes + 15) / 16 * 16;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    p->threads, p->smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + (1LL << shift) - 1) >> shift;
  const long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  p->blocks = (int)(tiles < grid ? tiles : grid);
  return 0;
}

bool aligned4(const void* p, long long ld) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0 && (ld & 3) == 0;
}

}  // namespace

// feature ids must be < d (the wrapper checks); depth in [0, 7]; out
// zeroed
extern "C" int mmlspark_gbdt_predict_quant_levelwise(
    const void* bins_t, long long ld, const void* feature,
    const void* threshold, const void* leaf, void* out, long long n, int d,
    int n_trees, int n_class, int depth, void* stream) {
  if (d <= 0 || d > 256 || depth < 0 || depth > 7 || n_trees < 0 ||
      n_class <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tab = n_trees * n_class;
  if (n_tab == 0) return 0;
  static void (*const kernels[8])(const uint8_t*, long long, bool,
                                  const uint8_t*, const uint8_t*,
                                  const float*, float*, long long, int, int,
                                  int, int, int) = {
      quant_levelwise<0>, quant_levelwise<1>, quant_levelwise<2>,
      quant_levelwise<3>, quant_levelwise<4>, quant_levelwise<5>,
      quant_levelwise<6>, quant_levelwise<7>};
  Plan p;
  const int tree_bytes = 2 * ((1 << depth) - 1) + 4 * (1 << depth);
  int rc = plan(kernels[depth], n, d, n_tab, tree_bytes, &p);
  if (rc) return rc;
  kernels[depth]<<<p.blocks, p.threads, p.smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins_t), ld, aligned4(bins_t, ld),
      static_cast<const uint8_t*>(feature),
      static_cast<const uint8_t*>(threshold), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, d, n_tab, n_class, p.tile_shift, p.chunk);
  return (int)cudaGetLastError();
}

// feature ids must be < d (the wrapper checks); 1 <= R <= 127 rounds
// (PREDICT_QUANT_MAX_NODES), so at most 128 leaves; out zeroed
extern "C" int mmlspark_gbdt_predict_quant_leafwise(
    const void* bins_t, long long ld, const void* split_leaf,
    const void* feature, const void* threshold, const void* leaf, void* out,
    long long n, int d, int n_trees, int n_class, int n_rounds,
    void* stream) {
  if (d <= 0 || d > 256 || n_rounds < 1 || n_rounds > 127 || n_trees < 0 ||
      n_class <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_tab = n_trees * n_class;
  if (n_tab == 0) return 0;
  Plan p;
  int rc = plan(quant_leafwise, n, d, n_tab, 12 * (n_rounds + 1), &p);
  if (rc) return rc;
  quant_leafwise<<<p.blocks, p.threads, p.smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins_t), ld, aligned4(bins_t, ld),
      static_cast<const int*>(split_leaf),
      static_cast<const uint8_t*>(feature),
      static_cast<const uint8_t*>(threshold), static_cast<const float*>(leaf),
      static_cast<float*>(out), n, d, n_tab, n_class, n_rounds, p.tile_shift,
      p.chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
