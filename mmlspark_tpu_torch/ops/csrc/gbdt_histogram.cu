// GBDT gradient/hessian histograms for Hopper (sm_90a): integer fixed-point
// sums in shared memory, deterministic whatever the order of the adds.
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
// (g[i], h[i]) to key k(i, f) of that feature. CUDA blocks run in no
// order, and float atomics would make each sum depend on the order of
// arrival, so a near-tie in the split search could pick another split from
// one run to the next. Integer addition is associative: each value becomes
// a fixed-point integer with one scale per call and quantity, the integers
// are added in any order (shared-memory and global atomics), and each sum
// is converted once at the end. Two launches on the same inputs, or on the
// same rows in another order, give the same bits.
//
// The arithmetic (ops/gbdt_kernels.py repeats it in plain PyTorch, bit for
// bit, as node_histogram_kernel_arithmetic and
// histogram_fused_kernel_arithmetic):
//   scale   s = 62 - e, where (m, e) = frexp(max|v| * N) in double, the max
//           over the finite values of the quantity (g or h) and N all rows.
//           Then |v| * 2^s < 2^62 / N, so no key's sum can overflow int64.
//   words   t = v * 2^s (exact: a power of two), hi = rint(t) (int64),
//           lo = rint((t - hi) * 2^14) in [-2^13, 2^13] (int32 in shared
//           memory: a block sums at most 2^17 rows, |sum| <= 2^30).
//   output  float32((double(H) + double(L) * 2^-14) * 2^-s) of the exact
//           integer sums H and L: the add rounds to double (and so does
//           double(H) first where |H| > 2^53), then one rounding to float32,
//           as the float64 plain versions round their sums.
//   error   each value is held to within 2^-(s+15), and 2^-s <= max|v| * N
//           * 2^-61, so an output is within count * max|v| * N * 2^-76 of
//           the exact sum before its rounding to float32: 1.3e-11 at |g| <=
//           1, N = 1M. The bound is absolute: where a key's sum S has |S| >=
//           count * max|v| * N * 2^-50 (its mean value at least 8.9e-10 *
//           max|v| at N = 1M), it and the double roundings stay under half
//           a float32 ulp of S, and the output is within one ulp of the
//           correctly rounded sum; a key whose values cancel to below that
//           is held only to the absolute bound.
//   non-finite values add nothing to the integers; each sets a bit of its
//           key (NaN, +inf, -inf) by atomicOr, and the output is NaN where
//           a NaN or both infinities fell, else the infinity, as a float64
//           scatter-add gives.
// The kernels:
//   1. hist_absmax: max|g| and max|h| over the finite values, by atomicMax
//      on the bit patterns of the non-negative floats (exact, any order),
//      into the scratch that the next two read; no host sync.
//   2. hist_accumulate: block (feature group, row split) keeps one int64 hi
//      and one int32 lo word per (feature, key, quantity) in dynamic shared
//      memory, for every key of the launch (16 nodes x 255 bins = 98 KB at
//      one feature), so the bins are read once. Each row loads its node id
//      and g/h once, quantizes them once, and for each feature of the group
//      adds to its key with shared atomics (the 64-bit add as two 32-bit
//      ones with a carry, below); a row outside the nodes costs only its
//      loads. At the end the block stores its words, as they are, into its
//      row split's part of a (n_splits, F, 2, n_keys) scratch: plain
//      coalesced stores, where global atomics from every block onto the
//      same words had cost more than the rows. Where one feature's keys do
//      not fit in shared memory, the blocks add into their part directly
//      with global atomics.
//   3. hist_convert: sums each key's words over the parts and converts
//      them to the float32 output layout.
// What bounds it (H100 runs of chip_smoke.py): the latency of each
// thread's (row batch, feature) steps, a load and then up to 6 shared
// atomics, 2 of them waiting on the returned value; not the bytes, and not
// the atomics' throughput: rows outside the nodes cost about what live
// rows cost. So a thread issues the next step's loads before this step's
// atomics, takes 2 rows a step, and a block shares each row's loads and
// quantization among up to ~16 features. The plan in ops/gbdt_kernels.py
// (_plan) sizes the grid to whole waves of resident blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int HEADROOM = 62;        // |sum of hi| < 2^62
constexpr double LO_SCALE = 0x1p14;  // fractional bits of the lo word
constexpr double LO_UNIT = 0x1p-14;
constexpr long long MAX_SPLIT_ROWS = 1LL << 17;  // lo sums stay in int32
constexpr int MAX_SMEM = 232448;
constexpr int MAX_DEVICES = 64;
constexpr int KEY_BYTES = 2 * (8 + 4);  // (g, h) x (hi, lo)
// rows a thread takes per step: 1 leaves the steps' latency exposed, 4
// spill at the 64 registers that 2 blocks of 512 threads leave
constexpr int UNROLL = 2;
constexpr int NAN_BIT = 1, POS_INF_BIT = 2, NEG_INF_BIT = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

// s = 62 - e, (m, e) = frexp(max|v| * n_rows)
__device__ __forceinline__ int fixed_scale(unsigned maxbits,
                                           long long n_rows) {
  int e;
  frexp(__dmul_rn((double)__uint_as_float(maxbits), (double)n_rows), &e);
  return HEADROOM - e;
}

// v -> (hi, lo), or the key's flag bit for a non-finite v
__device__ __forceinline__ void quantize(float v, double p, long long& hi,
                                         int& lo, int& flag) {
  hi = 0;
  lo = 0;
  flag = 0;
  if (isfinite(v)) {
    const double t = __dmul_rn((double)v, p);
    const double r = rint(t);
    hi = __double2ll_rn(r);
    lo = (int)__double2ll_rn(__dmul_rn(__dsub_rn(t, r), LO_SCALE));
  } else {
    flag = isnan(v) ? NAN_BIT : (v > 0.f ? POS_INF_BIT : NEG_INF_BIT);
  }
}

// the 64-bit shared add: sm_90 has no 64-bit shared atomic add
// instruction, and atomicAdd on a u64 compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN.64), which took row 4 up to twice as long; so the two
// 32-bit halves are added with ATOMS.ADD, the carry out of the low half
// read from its returned old value, and the pair holds the exact sum mod
// 2^64 in any order
__device__ __forceinline__ void shared_add64(unsigned long long* w,
                                             long long x) {
  unsigned* p = reinterpret_cast<unsigned*>(w);
  const unsigned lo = (unsigned)x;
  const unsigned old = atomicAdd(p, lo);
  const unsigned hi =
      (unsigned)((unsigned long long)x >> 32) + (unsigned)(old + lo < old);
  if (hi) atomicAdd(p + 1, hi);
}

// row i's bin (mode 0) or id (mode 1) of feature f; -1 past the rows
template <int MODE>
__device__ __forceinline__ int load_bin(const void* bins, long long ld, int f,
                                        long long i, bool ok) {
  if (!ok) return -1;
  if (MODE == 0)
    return static_cast<const uint8_t*>(bins)[(long long)f * ld + i];
  return static_cast<const int*>(bins)[i * ld + f];
}

// the key of a row with bin or id b and node nd, or -1 when it adds nothing
template <int MODE>
__device__ __forceinline__ int key_of(int b, int nd, int nb, int n_nodes,
                                      int n_keys) {
  if (MODE == 0)
    return (b >= 0 && b < nb && nd >= 0 && nd < n_nodes) ? nd * nb + b : -1;
  return (b >= 0 && b < n_keys) ? b : -1;
}

__global__ void hist_absmax(const float* __restrict__ g,
                            const float* __restrict__ h,
                            unsigned* __restrict__ maxbits, long long n) {
  unsigned mg = 0u, mh = 0u;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float a = fabsf(g[i]), b = fabsf(h[i]);
    // NaN fails both comparisons; inf fails the second
    if (a <= 3.402823466e38f) mg = max(mg, __float_as_uint(a));
    if (b <= 3.402823466e38f) mh = max(mh, __float_as_uint(b));
  }
  mg = __reduce_max_sync(FULL_MASK, mg);
  mh = __reduce_max_sync(FULL_MASK, mh);
  if (threadIdx.x % 32 == 0) {
    if (mg) atomicMax(&maxbits[0], mg);
    if (mh) atomicMax(&maxbits[1], mh);
  }
}

// part_hi: (n_splits, F, 2, n_keys) int64 and part_lo: the same in int32,
// one part per row split, quantity q = 0 for g and 1 for h; flags: (F, 2,
// n_keys) int32 non-finite bits
template <int MODE, bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    hist_accumulate(const void* __restrict__ bins,
                    const int* __restrict__ node, const float* __restrict__ g,
                    const float* __restrict__ h,
                    const unsigned* __restrict__ maxbits,
                    unsigned long long* __restrict__ part_hi,
                    int* __restrict__ part_lo, int* __restrict__ flags,
                    long long n_rows, long long ld, int n_feat, int nb,
                    int n_nodes, int n_keys, int fpb,
                    long long rows_per_split) {
  extern __shared__ unsigned long long smem[];  // hi [fl][q][k], lo after
  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, n_feat - f0);
  const int words = nf * 2 * n_keys;
  // this block's part, from its first feature on: [fl][q][k]
  const long long p0 = ((long long)blockIdx.y * n_feat + f0) * 2 * n_keys;
  unsigned long long* shi = SMEM ? smem : part_hi + p0;
  int* slo = SMEM ? reinterpret_cast<int*>(smem + (long long)fpb * 2 * n_keys)
                  : part_lo + p0;
  if (SMEM) {
    for (int j = threadIdx.x; j < words; j += blockDim.x) {
      shi[j] = 0ull;
      slo[j] = 0;
    }
    __syncthreads();
  }
  const double pg = ldexp(1.0, fixed_scale(maxbits[0], n_rows));
  const double ph = ldexp(1.0, fixed_scale(maxbits[1], n_rows));
  const long long r0 = (long long)blockIdx.y * rows_per_split;
  const long long r1 = min(n_rows, r0 + rows_per_split);
  const long long step = (long long)blockDim.x * UNROLL;

  // A thread walks (row batch, feature) steps of UNROLL rows each; the
  // loads of the next step (its bins, and at a batch's last feature the
  // next batch's node ids and g/h) are issued before this step's atomics,
  // so their latency overlaps them.
  int nd_n[UNROLL], b_n[UNROLL];
  float g_n[UNROLL], h_n[UNROLL];
  auto load_rows = [&](long long base) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * blockDim.x + threadIdx.x;
      const bool ok = i < r1;
      nd_n[u] = MODE == 0 ? (ok ? node[i] : -1) : 0;
      g_n[u] = ok ? g[i] : 0.f;
      h_n[u] = ok ? h[i] : 0.f;
    }
  };
  auto load_bins = [&](long long base, int f) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * blockDim.x + threadIdx.x;
      b_n[u] = load_bin<MODE>(bins, ld, f, i, i < r1);
    }
  };
  load_rows(r0);
  load_bins(r0, f0);
  for (long long base = r0; base < r1; base += step) {
    long long ghi[UNROLL], hhi[UNROLL];
    int glo[UNROLL], hlo[UNROLL], fl_bits[UNROLL], nd[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int gf, hf;
      nd[u] = nd_n[u];
      quantize(g_n[u], pg, ghi[u], glo[u], gf);
      quantize(h_n[u], ph, hhi[u], hlo[u], hf);
      fl_bits[u] = gf | hf << 4;
    }
    for (int fl = 0; fl < nf; ++fl) {
      int key[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        key[u] = key_of<MODE>(b_n[u], nd[u], nb, n_nodes, n_keys);
      if (fl + 1 < nf) {
        load_bins(base, f0 + fl + 1);
      } else if (base + step < r1) {
        load_rows(base + step);
        load_bins(base + step, f0);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = key[u];
        if (k < 0) continue;
        const int jg = (fl * 2) * n_keys + k, jh = jg + n_keys;
        if (SMEM) {
          if (ghi[u]) shared_add64(&shi[jg], ghi[u]);
          if (hhi[u]) shared_add64(&shi[jh], hhi[u]);
        } else {
          if (ghi[u]) atomicAdd(&shi[jg], (unsigned long long)ghi[u]);
          if (hhi[u]) atomicAdd(&shi[jh], (unsigned long long)hhi[u]);
        }
        if (glo[u]) atomicAdd(&slo[jg], glo[u]);
        if (hlo[u]) atomicAdd(&slo[jh], hlo[u]);
        // the rare branch: a non-finite value marks its key
        if (fl_bits[u]) {
          int* fk = flags + (long long)(f0 + fl) * 2 * n_keys + k;
          if (fl_bits[u] & 15) atomicOr(fk, fl_bits[u] & 15);
          if (fl_bits[u] >> 4) atomicOr(fk + n_keys, fl_bits[u] >> 4);
        }
      }
    }
  }
  if (SMEM) {  // the part out with plain stores: no global atomics
    __syncthreads();
    for (int j = threadIdx.x; j < words; j += blockDim.x) {
      part_hi[p0 + j] = shi[j];
      part_lo[p0 + j] = slo[j];
    }
  }
}

__device__ __forceinline__ float to_float(long long hi, long long lo,
                                          double unit, int flag) {
  if (flag) {
    const bool nan = (flag & NAN_BIT) ||
                     (flag & (POS_INF_BIT | NEG_INF_BIT)) ==
                         (POS_INF_BIT | NEG_INF_BIT);
    return nan ? __int_as_float(0x7fc00000)
               : __int_as_float(flag & POS_INF_BIT ? 0x7f800000 : 0xff800000);
  }
  const double d = __dadd_rn(__ll2double_rn(hi),
                             __dmul_rn(__ll2double_rn(lo), LO_UNIT));
  return __double2float_rn(__dmul_rn(d, unit));
}

// sums the parts (integers: any order gives the same sums) and converts
// each (feature, key) to the float32 output layout. A block takes 32
// consecutive (feature, key) slots; each of its CONVERT_WARPS warps sums
// every CONVERT_WARPS-th part of them (coalesced), and the first warp adds
// the warps' sums and writes the outputs.
constexpr int CONVERT_WARPS = 8;

template <int MODE>
__global__ void __launch_bounds__(CONVERT_WARPS * 32)
    hist_convert(const unsigned long long* __restrict__ part_hi,
                 const int* __restrict__ part_lo,
                 const int* __restrict__ flags,
                 const unsigned* __restrict__ maxbits,
                 float* __restrict__ out_g, float* __restrict__ out_h,
                 long long n_rows, int n_feat, int n_keys, int nb,
                 int n_parts) {
  __shared__ long long sums[4][CONVERT_WARPS][32];  // H g, H h, L g, L h
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const long long idx = (long long)blockIdx.x * 32 + lane;
  const bool ok = idx < (long long)n_feat * n_keys;
  const int f = ok ? (int)(idx / n_keys) : 0, k = ok ? (int)(idx % n_keys) : 0;
  const long long stride = (long long)n_feat * 2 * n_keys;
  const long long j0 = (long long)f * 2 * n_keys + k;
  long long H[2] = {0, 0}, L[2] = {0, 0};
  if (ok) {
    for (int p = w; p < n_parts; p += CONVERT_WARPS) {
      const long long j = p * stride + j0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        H[q] += (long long)part_hi[j + q * n_keys];
        L[q] += part_lo[j + q * n_keys];
      }
    }
  }
  sums[0][w][lane] = H[0];
  sums[1][w][lane] = H[1];
  sums[2][w][lane] = L[0];
  sums[3][w][lane] = L[1];
  __syncthreads();
  if (w != 0 || !ok) return;
  for (int v = 1; v < CONVERT_WARPS; ++v) {
    H[0] += sums[0][v][lane];
    H[1] += sums[1][v][lane];
    L[0] += sums[2][v][lane];
    L[1] += sums[3][v][lane];
  }
  const int* fk = flags + j0;
  // mode 0: key = node * nb + bin -> (node, f, bin); mode 1: (f, key)
  const long long o = MODE == 0
                          ? ((long long)(k / nb) * n_feat + f) * nb + k % nb
                          : (long long)f * n_keys + k;
  out_g[o] = to_float(H[0], L[0],
                      ldexp(1.0, -fixed_scale(maxbits[0], n_rows)), fk[0]);
  out_h[o] = to_float(H[1], L[1],
                      ldexp(1.0, -fixed_scale(maxbits[1], n_rows)),
                      fk[n_keys]);
}

template <int MODE, bool SMEM>
int launch_accumulate(const void* bins, const int* node, const float* g,
                      const float* h, const unsigned* maxbits,
                      unsigned long long* part_hi, int* part_lo, int* flags,
                      long long n_rows, long long ld, int n_feat, int nb,
                      int n_nodes, int n_keys, int fpb, int n_splits,
                      long long rows_per_split, int threads, cudaStream_t s) {
  const int smem = SMEM ? fpb * n_keys * KEY_BYTES : 0;
  // the shared-memory limit, raised once per instantiation and device
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (SMEM && (dev >= MAX_DEVICES || !smem_set[dev])) {
    e = cudaFuncSetAttribute(hist_accumulate<MODE, SMEM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  const dim3 grid((n_feat + fpb - 1) / fpb, n_splits);
  hist_accumulate<MODE, SMEM><<<grid, threads, smem, s>>>(
      bins, node, g, h, maxbits, part_hi, part_lo, flags, n_rows, ld, n_feat,
      nb, n_nodes, n_keys, fpb, rows_per_split);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(const void* bins, const int* node, const float* g, const float* h,
           void* scratch, float* out_g, float* out_h,
           long long n_rows, long long ld, int n_feat, int nb, int n_nodes,
           int n_keys, int fpb, int n_splits, long long rows_per_split,
           int use_smem, int threads, cudaStream_t s) {
  // scratch: maxbits (2 x uint32 in one int64 word) and flags (F, 2,
  // n_keys) int32, zeroed here; then part_hi and part_lo, zeroed only where
  // the blocks add into them directly
  unsigned* maxbits = static_cast<unsigned*>(scratch);
  int* flags = reinterpret_cast<int*>(static_cast<long long*>(scratch) + 1);
  unsigned long long* part_hi = static_cast<unsigned long long*>(scratch) + 1 +
                                (long long)n_feat * n_keys;
  const long long part_words = (long long)n_splits * n_feat * 2 * n_keys;
  int* part_lo = reinterpret_cast<int*>(part_hi + part_words);
  cudaError_t e = cudaMemsetAsync(
      scratch, 0,
      8 * (1 + (long long)n_feat * n_keys + (use_smem ? 0 : part_words)) +
          (use_smem ? 0 : 4 * part_words),
      s);
  if (e != cudaSuccess) return (int)e;
  const long long absmax_blocks =
      min((n_rows + 256LL * 8 - 1) / (256LL * 8), 1024LL);
  hist_absmax<<<(unsigned)absmax_blocks, 256, 0, s>>>(g, h, maxbits, n_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rc =
      use_smem
          ? launch_accumulate<MODE, true>(bins, node, g, h, maxbits, part_hi,
                                          part_lo, flags, n_rows, ld, n_feat,
                                          nb, n_nodes, n_keys, fpb, n_splits,
                                          rows_per_split, threads, s)
          : launch_accumulate<MODE, false>(bins, node, g, h, maxbits, part_hi,
                                           part_lo, flags, n_rows, ld, n_feat,
                                           nb, n_nodes, n_keys, fpb, n_splits,
                                           rows_per_split, threads, s);
  if (rc != 0) return rc;
  const long long total = (long long)n_feat * n_keys;
  hist_convert<MODE><<<(unsigned)((total + 31) / 32), CONVERT_WARPS * 32, 0,
                       s>>>(
      part_hi, part_lo, flags, maxbits, out_g, out_h, n_rows, n_feat, n_keys,
      nb, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: bins (F, ld) uint8, node (N,) int32, n_keys = n_nodes * nb,
//         out (n_nodes, F, nb); mode 1: bins (N, ld) int32, node unused,
//         out (F, n_keys). scratch: 8 * (1 + F * n_keys) + n_splits * F *
//         2 * n_keys * 12 bytes, 8-byte aligned; out_g and out_h float32.
// A block takes fpb features over rows_per_split (<= 2^17) rows; use_smem
// keeps its sums in shared memory (fpb * n_keys * 24 bytes must fit).
extern "C" int mmlspark_gbdt_histogram(
    int mode, const void* bins, const void* node, const void* g,
    const void* h, void* scratch, void* out_g, void* out_h,
    long long n_rows, long long ld, int n_feat, int nb, int n_nodes,
    int n_keys, int fpb, int n_splits, long long rows_per_split,
    int use_smem, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nd = static_cast<const int*>(node);
  const float* gf = static_cast<const float*>(g);
  const float* hf = static_cast<const float*>(h);
  float* og = static_cast<float*>(out_g);
  float* oh = static_cast<float*>(out_h);
  if (n_rows <= 0 || n_feat <= 0 || n_keys <= 0 || fpb <= 0 ||
      n_splits <= 0 || n_splits > 65535 || rows_per_split <= 0 ||
      rows_per_split > MAX_SPLIT_ROWS ||
      (long long)n_splits * rows_per_split < n_rows || threads % 32 != 0 ||
      threads < 32 || threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  if (use_smem && (long long)fpb * n_keys * KEY_BYTES > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (mode == 0)
    return launch<0>(bins, nd, gf, hf, scratch, og, oh, n_rows, ld,
                     n_feat, nb, n_nodes, n_keys, fpb, n_splits,
                     rows_per_split, use_smem, threads, s);
  if (mode == 1)
    return launch<1>(bins, nd, gf, hf, scratch, og, oh, n_rows, ld,
                     n_feat, nb, n_nodes, n_keys, fpb, n_splits,
                     rows_per_split, use_smem, threads, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
