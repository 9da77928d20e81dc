// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, dq and dk/dv.
//
// Replaces the TPU kernels mmlspark_tpu/ops/pallas_kernels.py:
// _flash_bwd_dq_kernel (pallas_call in _flash_attention_bwd, :295) and
// _flash_bwd_dkv_kernel (:309). They compute the same functions with the
// same masks and rounding points, from the forward's saved row logsumexp
// `lse` and the row dot D = rowsum(dO * O) in float32 (the JAX package
// takes D in XLA outside its kernels; here the bf16 dq kernel computes it
// and writes it for the dk/dv kernel, the float32 path takes it from the
// wrapper):
//   s  = (q k^T) * scale, float32 sums of input-typed products;
//   keys past Tk and, if causal, keys after the query (top-left aligned,
//   query i sees keys j <= i) are masked; p = exp(s - lse), and p = 0 for a
//   row with lse <= NEG_INF / 2 (a row that saw no key);
//   dp = dO v^T in float32, ds = p * (dp - D);
//   dq = scale * ds k,  dv = p^T dO,  dk = scale * ds^T q,
// with P rounded to dO's type before P^T dO and dS to the input type before
// dS k and dS^T q, float32 accumulation, dq and dk scaled once at the end,
// and the gradients written in the input type as (B, T, H, D).
//
// Bound on the H100 (SXM, 989 TFLOP/s dense bf16, 3.35 TB/s) at the training
// slice's shape B=8, H=4, T=4096, D=128, causal: the visible (query, key)
// pairs per head are sum_{i<4096}(i+1) = 8,390,656, over B*H = 32 heads.
// dq does three products per pair (S, dP, dS K), 6*D FLOP: 2.06e11 FLOP
// -> 0.209 ms at the tensor-core peak. dk/dv does four (S^T, dP^T, P^T dO,
// dS^T Q), 8*D FLOP: 2.75e11 FLOP -> 0.278 ms. Each reads q, k, v, dO
// (4 x 33.5 MB) and lse, D (2 x 0.5 MB), about 135 MB (dq also O), and
// writes 34 MB (dq) or 67 MB (dk, dv): 0.05-0.06 ms at the memory rate.
// Both kernels are bound by operations, 4-5x over their bytes, and only
// wgmma reaches the tensor cores' full rate.
//
// Design. The TPU kernels carry their accumulators in VMEM scratch across a
// sequential grid axis; here blocks run in parallel and in no order, so the
// split into two kernels keeps every accumulator in one block's registers
// and needs no atomics: the gradients are deterministic, the same bits for
// the same step. S and dP are computed in both kernels.
//
// bfloat16 (the training path), warp-specialised like the forward
// (flash_attention_fwd.cu), 384 threads: one producer warpgroup (24
// registers a thread) whose first warp issues TMA loads into shared memory,
// and two consumer warpgroups (240 registers) each owning 64 rows of a
// 128-row stationary tile, walking 64-row tiles that arrive through a
// two-stage ring of "full" (the TMA's bytes) and "empty" (the 8 consumer
// warps) mbarriers. Every product is wgmma with bf16 operands in 128-byte
// swizzled shared memory as TMA writes them (hopper_common.cuh):
//   dq (Q-stationary): a tile is one (batch*head, 128-query tile). Q, dO and
//     O are loaded once; each consumer first takes D = rowsum(dO * O) for
//     its rows from shared memory (each quad of lanes sums one row) and
//     writes it to `delta`. Per 64-key K/V tile: S = Q K^T and dP = dO V^T
//     by wgmma m64n64k16 with all four operands K-major in shared memory;
//     P = exp2(S scale log2e - lse log2e) in registers while dP finishes;
//     dS = P (dP - D) rounded to bf16 in registers, where the accumulator
//     already has the layout of wgmma's register A operand; dQ += dS K by
//     wgmma m64n{D}k16 with K read MN-major (transpose bit) from the same
//     tile. V is released when dP retires, K when dQ does.
//   dk/dv (KV-stationary): a tile is one (batch*head, 128-key tile). K and
//     V are loaded once; per 64-query Q/dO tile (the producer's warp also
//     writes the tile's 64 lse values, pre-scaled to base 2, and D values
//     into the ring slot before it arrives): S^T = K Q^T and dP^T = V dO^T
//     by SS wgmma; P^T and dS^T in registers, each lane reading the lse and
//     D of its accumulator's 16 query columns from shared memory; then
//     dV += P^T dO and dK += dS^T Q by RS wgmma with dO and Q MN-major from
//     the same tiles. P^T and dS^T are both packed to bf16 once dP^T has
//     retired, so the float32 scores die before the two accumulators grow.
// Both: a persistent grid, one block per SM, walks its tiles heaviest first
// (dq: every head's last query tile first; dk/dv: the first key tile),
// dealt in a snake (tile_of). Ring tiles wholly above the causal diagonal
// are never loaded; a warpgroup whose rows a ring tile cannot reach skips
// its products. Rows past Tq get lse = +inf, so P = 0 there without a mask;
// keys past Tk (zero-filled by TMA) are masked in dq and only reach the
// dk/dv rows that are never stored; the causal mask runs only on the tiles
// that meet the diagonal. dq is stored straight from the accumulator; dk
// and dv are staged swizzled and written by TMA stores, as the forward
// writes out (each the faster of the two there, PERF.md); rows past the
// end are clipped. q, k, v, dO and O are read in place, and dk and dv
// written, through 4-D tensor maps over (D, H, T, B) with 64-row boxes (a
// 128-row tile is two), encoded once per backward call by the wrapper and
// passed to both launches.
//
// float32 (a tight check of the algorithm on the card): CUDA-core fused
// multiply-adds, 256 threads, shared-memory tiles, D from the wrapper.

#include "flash_common.cuh"
#include "hopper_common.cuh"

#include <string.h>

namespace {

// ---------------------------------------------------------------- bfloat16

constexpr int WG = 128;     // threads of a warpgroup
constexpr int TILE = 128;   // stationary rows: dq's queries, dk/dv's keys
constexpr int RT = 64;      // rows of a ring tile: dq's keys, dk/dv's queries
constexpr int BOX = 64;     // bf16 of D in one swizzled 128-byte row
constexpr int STAGES = 2;   // the ring
constexpr int CONSUMER_WARPS = 8;
constexpr uint32_t BOX_BYTES = RT * BOX * 2;  // one TMA box: 64 rows
constexpr int TMA_ENCODE_FAILED = 20000;      // + the CUresult

// the tensor maps of the five operands and of dk and dv (stored by TMA),
// encoded once per backward call
struct BwdMaps {
  CUtensorMap q, k, v, dout, o, dk, dv;
};
static_assert(sizeof(BwdMaps) == 7 * 128, "the wrapper's buffer size");

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// ROWS rows (from time step t0) of one (batch, head) into `dst` as D / 64
// boxes of ROWS swizzled rows, each loaded as ROWS / 64 boxes of 64 rows;
// ROWS * D * 2 bytes complete on `bar`
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int hd, int t0,
                                          int b) {
#pragma unroll
  for (int c = 0; c < D / BOX; ++c)
#pragma unroll
    for (int h = 0; h < ROWS / RT; ++h)
      tma_load_4d(dst + c * ROWS * BOX + h * RT * BOX, map, bar, c * BOX, hd,
                  t0 + h * RT, b);
}

// descriptor offset (16-byte units) of k-step ks of a K-major operand laid
// out as load_rows<D, ROWS> writes it: 32 bytes along the row, box ks / 4
template <int ROWS>
__device__ __forceinline__ uint32_t kstep(int ks) {
  return ((ks / 4) * ROWS * BOX * 2 + (ks % 4) * 32) >> 4;
}
// of k-step kk of an MN-major operand: 16 rows of 128 bytes
__device__ __forceinline__ uint32_t mnstep(int kk) { return (kk * 16 * 128) >> 4; }

// d (64 x D) += A B for the gradient products: A 16 keys or queries of dS,
// dS^T or P^T in registers, B 16 rows of an MN-major ring tile
template <int D>
__device__ __forceinline__ void wgmma_grad(float (&d)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (D == 128)
    wgmma_m64n128k16_rs(d, a, b, 1);
  else
    wgmma_m64n64k16_rs(d, a, b, 1);
}

// S (or S^T, dP, dP^T) = A B^T over D for one warpgroup: A its 64 rows of a
// 128-row stationary tile, B a 64-row ring tile, both K-major
template <int D>
__device__ __forceinline__ void wgmma_scores(float (&d)[RT / 2], uint64_t a,
                                             uint64_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_m64n64k16_ss(d, a + kstep<TILE>(ks), b + kstep<RT>(ks), ks > 0);
}

// sum of the products of 8 bf16 pairs in float32
__device__ __forceinline__ float dot8_bf16(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), s);
    s = fmaf(__uint_as_float(x[i] & 0xffff0000u),
             __uint_as_float(y[i] & 0xffff0000u), s);
  }
  return s;
}

template <int D>
struct alignas(1024) DqSmem {
  __nv_bfloat16 q[TILE * D], dout[TILE * D], o[TILE * D];
  __nv_bfloat16 k[STAGES][RT * D], v[STAGES][RT * D];
  uint64_t q_full, q_empty, k_full[STAGES], v_full[STAGES], k_empty[STAGES],
      v_empty[STAGES];
};

template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_bwd_dq_bf16(const __grid_constant__ BwdMaps maps,
                      const float* __restrict__ lse,
                      float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int BH, int H, int Tq,
                      int Tk, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment; the launch adds the slack
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int nq = (Tq + TILE - 1) / TILE, n_tiles = nq * BH;
  // tile i: query tile nq - 1 - i / BH of head i % BH, and its K/V tiles
  // up to the last one its rows (those before Tq) see
  auto key_tiles = [&](int q0) {
    const int n = (Tk + RT - 1) / RT;
    return causal ? min(n, (min(q0 + TILE, Tq) - 1) / RT + 1) : n;
  };
  // the warpgroup, as a value the compiler can see is uniform in a warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    mbar_init(&sm.q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], CONSUMER_WARPS);
      mbar_init(&sm.v_empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    regs_release<24>();
    if (threadIdx.x == 0) {
      uint32_t r = 0;  // K/V tiles loaded so far: the ring position
      for (int j = 0, i; (i = tile_of(j, n_tiles)) >= 0; ++j) {
        const int bh = i % BH, b = bh / H, hd = bh % H;
        const int q0 = (nq - 1 - i / BH) * TILE, nk = key_tiles(q0);
        mbar_wait(&sm.q_empty, (j & 1) ^ 1);
        mbar_arrive_expect_tx(&sm.q_full, 3 * TILE * D * 2);
        load_rows<D, TILE>(sm.q, &maps.q, &sm.q_full, hd, q0, b);
        load_rows<D, TILE>(sm.dout, &maps.dout, &sm.q_full, hd, q0, b);
        load_rows<D, TILE>(sm.o, &maps.o, &sm.q_full, hd, q0, b);
        for (int kt = 0; kt < nk; ++kt, ++r) {
          const int s = r % STAGES;
          const uint32_t ph = (r / STAGES) & 1;
          mbar_wait(&sm.k_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&sm.k_full[s], RT * D * 2);
          load_rows<D, RT>(sm.k[s], &maps.k, &sm.k_full[s], hd, kt * RT, b);
          mbar_wait(&sm.v_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&sm.v_full[s], RT * D * 2);
          load_rows<D, RT>(sm.v[s], &maps.v, &sm.v_full[s], hd, kt * RT, b);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    regs_acquire<240>();
    const int cw = wg - 1;  // this warpgroup's rows: 64 cw .. 64 cw + 63
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, lane in quad
    const int rw = cw * 64 + warp * 16 + g;  // the lane's rows in the tile:
                                             // rw and rw + 8
    const float sl2 = scale * LOG2E;         // exp runs in base 2
    const uint64_t qd = desc_sw128(sm.q + cw * 64 * BOX, 16, 1024);
    const uint64_t dod = desc_sw128(sm.dout + cw * 64 * BOX, 16, 1024);

    float acc[D / 2];       // dQ: D/8 n8 tiles x 4, rows rw (e < 2), rw + 8
    float sc[RT / 2];       // S, then P: 8 n8 tiles x 4, laid out as acc
    float dp[RT / 2];       // dP
    uint32_t da[RT / 16][4];  // dS in bf16: the A operand of 4 k-steps
    uint32_t r = 0;           // K/V tiles consumed so far: the ring position

    for (int j = 0, i; (i = tile_of(j, n_tiles)) >= 0; ++j) {
      const int bh = i % BH, b = bh / H, hd = bh % H;
      const int q0 = (nq - 1 - i / BH) * TILE, nk = key_tiles(q0);
      const int row0 = q0 + rw;
      // lse in base 2 of the lane's two rows; +inf (P = 0) for a row past
      // Tq or one that saw no key
      float lse2[2], dd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const float L = row < Tq ? lse[(size_t)bh * Tq + row] : NEG_INF;
        lse2[h] = L > NEG_INF * 0.5f ? L * LOG2E : pos_inf();
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
      mbar_wait(&sm.q_full, j & 1);

      // D = rowsum(dO * O) of the lane's two rows, from the swizzled tiles:
      // the quad's lanes take every fourth 16-byte unit of the row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = rw + 8 * h;
        float sum = 0.f;
#pragma unroll
        for (int m = 0; m < D / 32; ++m) {
          const int u = t + 4 * m, c = u / 8, cc = u % 8;
          const int off = c * TILE * BOX + rr * BOX + ((cc ^ (rr & 7)) << 3);
          sum += dot8_bf16(*reinterpret_cast<const uint4*>(sm.dout + off),
                           *reinterpret_cast<const uint4*>(sm.o + off));
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        dd[h] = sum;
        if (t == 0 && row0 + 8 * h < Tq)
          delta[(size_t)bh * Tq + row0 + 8 * h] = sum;
      }

      for (int kt = 0; kt < nk; ++kt, ++r) {
        const int s = r % STAGES;
        const uint32_t ph = (r / STAGES) & 1;
        const int k0 = kt * RT;
        mbar_wait(&sm.k_full[s], ph);
        mbar_wait(&sm.v_full[s], ph);
        if (causal && k0 > q0 + cw * 64 + 63) {  // every key after every row
          if (lane == 0) {
            mbar_arrive(&sm.v_empty[s]);
            mbar_arrive(&sm.k_empty[s]);
            if (kt == nk - 1) mbar_arrive(&sm.q_empty);
          }
          continue;
        }

        // S = Q K^T and dP = dO V^T, two groups
        wgmma_fence();
        wgmma_scores<D>(sc, qd, desc_sw128(sm.k[s], 16, 1024));
        wgmma_commit();
        wgmma_scores<D>(dp, dod, desc_sw128(sm.v[s], 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        // P while dP runs. Element e of n8 tile jj is row row0 + 8 (e >> 1),
        // key k0 + 8 jj + 2 t + (e & 1); masks only where this warp's rows
        // meet the causal diagonal or the tile runs past Tk
        const bool edge = k0 + RT > Tk ||
                          (causal && k0 + RT - 1 > q0 + cw * 64 + warp * 16);
#pragma unroll
        for (int jj = 0; jj < RT / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(fmaf(sc[4 * jj + e], sl2, -lse2[e >> 1]));
            if (edge) {
              const int qpos = row0 + ((e >> 1) << 3);
              const int kpos = k0 + jj * 8 + t * 2 + (e & 1);
              if (kpos >= Tk || (causal && qpos < kpos)) p = 0.f;
            }
            sc[4 * jj + e] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
        if (lane == 0) {
          mbar_arrive(&sm.v_empty[s]);
          if (kt == nk - 1) mbar_arrive(&sm.q_empty);  // Q's, dO's last reader
        }

        // dS = P (dP - D) in bf16 as the register A operand (n8 tiles 2kk
        // and 2kk + 1 are k-step kk's fragment; unit x holds row h = x & 1)
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e0 = 8 * kk + 2 * x;
            da[kk][x] = pack_bf16(sc[e0] * (dp[e0] - dd[x & 1]),
                                  sc[e0 + 1] * (dp[e0 + 1] - dd[x & 1]));
          }
        }
        // dQ += dS K, K MN-major: lbo the next box of D, a k-step 16 keys
        const uint64_t kt_desc = desc_sw128(sm.k[s], BOX_BYTES, 1024);
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) fence_regs(da[kk]);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk)
          wgmma_grad<D>(acc, da[kk], kt_desc + mnstep(kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) fence_regs(da[kk]);
        if (lane == 0) mbar_arrive(&sm.k_empty[s]);
      }

      // epilogue: dq (scaled) straight from the accumulator, rows past Tq
      // clipped (timed faster here than staging for TMA stores, PERF.md)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= Tq) continue;
        __nv_bfloat16* out = dq + (((size_t)b * Tq + row) * H + hd) * D + 2 * t;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(out + jj * 8) = pack_bf16(
              acc[4 * jj + 2 * h] * scale, acc[4 * jj + 2 * h + 1] * scale);
      }
    }
  }
}

template <int D>
struct alignas(1024) DkvSmem {
  __nv_bfloat16 k[TILE * D], v[TILE * D];
  __nv_bfloat16 q[STAGES][RT * D], dout[STAGES][RT * D];
  __nv_bfloat16 dk[TILE * D], dv[TILE * D];  // staged for the TMA stores
  float lse2[STAGES][RT], dd[STAGES][RT];  // per query: lse log2e, D
  uint64_t kv_full, kv_empty, full[STAGES], empty[STAGES];
};

template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_bwd_dkv_bf16(const __grid_constant__ BwdMaps maps,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int BH, int H,
                       int Tq, int Tk, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int nkt = (Tk + TILE - 1) / TILE, n_tiles = nkt * BH;
  const int nq = (Tq + RT - 1) / RT;
  // tile i: key tile i / BH of head i % BH (the first key tiles see the
  // most queries); causal skips the Q tiles wholly before its first key
  auto first_q = [&](int k0) { return causal ? min(k0 / RT, nq) : 0; };
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    mbar_init(&sm.kv_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // ------------------------------------------- producer
    regs_release<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      uint32_t r = 0;  // Q tiles loaded so far: the ring position
      for (int j = 0, i; (i = tile_of(j, n_tiles)) >= 0; ++j) {
        const int bh = i % BH, b = bh / H, hd = bh % H;
        const int k0 = (i / BH) * TILE;
        if (lane == 0) {
          mbar_wait(&sm.kv_empty, (j & 1) ^ 1);
          mbar_arrive_expect_tx(&sm.kv_full, 2 * TILE * D * 2);
          load_rows<D, TILE>(sm.k, &maps.k, &sm.kv_full, hd, k0, b);
          load_rows<D, TILE>(sm.v, &maps.v, &sm.kv_full, hd, k0, b);
        }
        for (int qt = first_q(k0); qt < nq; ++qt, ++r) {
          const int s = r % STAGES, q0 = qt * RT;
          mbar_wait(&sm.empty[s], ((r / STAGES) & 1) ^ 1);
          // each lane writes two queries' lse (base 2; +inf past Tq or for
          // a row that saw no key) and D before its arrival
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int qr = q0 + lane + 32 * h;
            const bool in = qr < Tq;
            const float L = in ? lse[(size_t)bh * Tq + qr] : NEG_INF;
            sm.lse2[s][lane + 32 * h] =
                L > NEG_INF * 0.5f ? L * LOG2E : pos_inf();
            sm.dd[s][lane + 32 * h] = in ? delta[(size_t)bh * Tq + qr] : 0.f;
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(&sm.full[s], 2 * RT * D * 2);
            load_rows<D, RT>(sm.q[s], &maps.q, &sm.full[s], hd, q0, b);
            load_rows<D, RT>(sm.dout[s], &maps.dout, &sm.full[s], hd, q0, b);
          } else {
            mbar_arrive(&sm.full[s]);
          }
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    regs_acquire<240>();
    const int cw = wg - 1;  // this warpgroup's keys: 64 cw .. 64 cw + 63
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const float sl2 = scale * LOG2E;
    const uint64_t kd = desc_sw128(sm.k + cw * 64 * BOX, 16, 1024);
    const uint64_t vd = desc_sw128(sm.v + cw * 64 * BOX, 16, 1024);

    float dka[D / 2], dva[D / 2];  // dK, dV: key rows kr0 (e < 2), kr0 + 8
    float st[RT / 2];              // S^T, then P^T: 8 n8 tiles of queries
    float dpt[RT / 2];             // dP^T
    uint32_t pa[RT / 16][4], da[RT / 16][4];  // P^T, dS^T in bf16
    uint32_t r = 0;  // Q tiles consumed so far: the ring position

    for (int j = 0, i; (i = tile_of(j, n_tiles)) >= 0; ++j) {
      const int bh = i % BH, b = bh / H, hd = bh % H;
      const int k0 = (i / BH) * TILE;
      const int kw = k0 + cw * 64;               // this warpgroup's first key
      const int kr0 = kw + warp * 16 + g;        // the lane's keys: kr0, +8
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dka[e] = dva[e] = 0.f;
      mbar_wait(&sm.kv_full, j & 1);

      for (int qt = first_q(k0); qt < nq; ++qt, ++r) {
        const int s = r % STAGES, q0 = qt * RT;
        mbar_wait(&sm.full[s], (r / STAGES) & 1);
        if (causal && q0 + RT - 1 < kw) {  // every query before every key
          if (lane == 0) mbar_arrive(&sm.empty[s]);
          continue;
        }

        // S^T = K Q^T and dP^T = V dO^T, two groups
        wgmma_fence();
        wgmma_scores<D>(st, kd, desc_sw128(sm.q[s], 16, 1024));
        wgmma_commit();
        wgmma_scores<D>(dpt, vd, desc_sw128(sm.dout[s], 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P^T while dP^T runs. Element e of n8 tile jj is key kr0 +
        // 8 (e >> 1), query q0 + 8 jj + 2 t + (e & 1); the causal mask only
        // where this warp's keys meet the diagonal
        const bool diag = causal && q0 < kw + warp * 16 + 15;
#pragma unroll
        for (int jj = 0; jj < RT / 8; ++jj) {
          const float2 L =
              *reinterpret_cast<const float2*>(&sm.lse2[s][8 * jj + 2 * t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_approx(
                fmaf(st[4 * jj + e], sl2, -((e & 1) ? L.y : L.x)));
            if (diag && q0 + 8 * jj + 2 * t + (e & 1) < kr0 + ((e >> 1) << 3))
              p = 0.f;
            st[4 * jj + e] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dpt);

        // P^T and dS^T = P^T (dP^T - D) in bf16 as register A operands:
        // unit x of k-step kk covers n8 tile 2kk + (x >> 1), queries
        // 8 (2kk + (x >> 1)) + 2t and + 1
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e0 = 8 * kk + 2 * x;
            const float2 Dq = *reinterpret_cast<const float2*>(
                &sm.dd[s][8 * (2 * kk + (x >> 1)) + 2 * t]);
            pa[kk][x] = pack_bf16(st[e0], st[e0 + 1]);
            da[kk][x] = pack_bf16(st[e0] * (dpt[e0] - Dq.x),
                                  st[e0 + 1] * (dpt[e0 + 1] - Dq.y));
          }
        }
        // dV += P^T dO and dK += dS^T Q, dO and Q MN-major (rows are the
        // queries): lbo the next box of D, a k-step 16 queries
        const uint64_t dob = desc_sw128(sm.dout[s], BOX_BYTES, 1024);
        const uint64_t qb = desc_sw128(sm.q[s], BOX_BYTES, 1024);
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(da[kk]);
        }
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk)
          wgmma_grad<D>(dva, pa[kk], dob + mnstep(kk));
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk)
          wgmma_grad<D>(dka, da[kk], qb + mnstep(kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
#pragma unroll
        for (int kk = 0; kk < RT / 16; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(da[kk]);
        }
        if (lane == 0) mbar_arrive(&sm.empty[s]);
      }
      if (lane == 0) mbar_arrive(&sm.kv_empty);  // K's and V's last reader

      // epilogue: dk (scaled) and dv staged in this warpgroup's rows,
      // swizzled as TMA reads them, then one TMA store per box, which
      // clips the rows past Tk. The staging rows are free once the
      // previous tile's stores have read them.
      __nv_bfloat16* sk = sm.dk + cw * 64 * BOX;
      __nv_bfloat16* sv = sm.dv + cw * 64 * BOX;
      if (tid == 0) tma_store_wait_read();
      named_barrier(1 + cw, WG);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = warp * 16 + g + 8 * h;  // row among the warpgroup's 64
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          const int off = (jj / 8) * TILE * BOX + rr * BOX +
                          (((jj % 8) ^ g) << 3) + t * 2;
          *reinterpret_cast<uint32_t*>(sk + off) =
              pack_bf16(dka[4 * jj + 2 * h] * scale,
                        dka[4 * jj + 2 * h + 1] * scale);
          *reinterpret_cast<uint32_t*>(sv + off) =
              pack_bf16(dva[4 * jj + 2 * h], dva[4 * jj + 2 * h + 1]);
        }
      }
      fence_proxy_async();
      named_barrier(1 + cw, WG);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < D / BOX; ++c) {
          tma_store_4d(&maps.dk, sk + c * TILE * BOX, c * BOX, hd, kw, b);
          tma_store_4d(&maps.dv, sv + c * TILE * BOX, c * BOX, hd, kw, b);
        }
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_read();  // before the block's memory goes
  }
}

// A check of the wgmma forms the backward adds, on one tile, one
// warpgroup: s = A B^T (SS m64n64k16, A and B 64 rows of D, K-major, as S
// reads Q and K) and o = bf16(s) B (RS, B MN-major over 64-row boxes, as
// dQ += dS K reads K).
template <int D>
struct alignas(1024) ProbeSmem {
  __nv_bfloat16 a[RT * D], b[RT * D];
  uint64_t full;
};

template <int D>
__global__ void __launch_bounds__(WG, 1)
    wgmma_tile_probe(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     float* __restrict__ s_out, float* __restrict__ o_out) {
  extern __shared__ unsigned char smem_raw[];
  ProbeSmem<D>& sm = *reinterpret_cast<ProbeSmem<D>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) {
    mbar_init(&sm.full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.full, 2 * RT * D * 2);
    load_rows<D, RT>(sm.a, &ta, &sm.full, 0, 0, 0);
    load_rows<D, RT>(sm.b, &tb, &sm.full, 0, 0, 0);
  }
  mbar_wait(&sm.full, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float sc[RT / 2], o[D / 2];
  uint32_t pa[RT / 16][4];
  const uint64_t ad = desc_sw128(sm.a, 16, 1024), bd = desc_sw128(sm.b, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_m64n64k16_ss(sc, ad + kstep<RT>(ks), bd + kstep<RT>(ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < RT / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
  const uint64_t bm = desc_sw128(sm.b, BOX_BYTES, 1024);
#pragma unroll
  for (int kk = 0; kk < RT / 16; ++kk) fence_regs(pa[kk]);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < RT / 16; ++kk) wgmma_grad<D>(o, pa[kk], bm + mnstep(kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h;
#pragma unroll
    for (int jj = 0; jj < RT / 8; ++jj) {
      s_out[row * RT + 8 * jj + 2 * t] = sc[4 * jj + 2 * h];
      s_out[row * RT + 8 * jj + 2 * t + 1] = sc[4 * jj + 2 * h + 1];
    }
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      o_out[row * D + 8 * jj + 2 * t] = o[4 * jj + 2 * h];
      o_out[row * D + 8 * jj + 2 * t + 1] = o[4 * jj + 2 * h + 1];
    }
  }
}

// ----------------------------------------------------------------- float32

constexpr int FMA_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int PAD = 1;            // odd row stride: column walks hit distinct banks
constexpr int BQ_F = 64;          // dq: query rows per block
constexpr int BK_F = 32;          // dq: keys per inner tile
constexpr int BKV_F = 64;         // dk/dv: key rows per block
constexpr int BQV_F = 32;         // dk/dv: query rows per inner tile

// zero-filled copy of `rows` rows past `valid` into a (rows, D + PAD) tile
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long st, int rows,
                                              int valid, int tid) {
  for (int i = tid; i < rows * D; i += FMA_THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + PAD) + c] = r < valid ? src[r * st + c] : 0.f;
  }
}

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BQ_F + 2 * BK_F) * (D + PAD) +
                          (size_t)BQ_F * (BK_F + PAD) + 2 * BQ_F);
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout, Rows ql, Rows kl,
                     Rows vl, Rows dl, const float* __restrict__ lse,
                     const float* __restrict__ dvec, float* __restrict__ dq,
                     int H, int Tq, int Tk, int causal, float scale) {
  constexpr int BQ = BQ_F, BK = BK_F, LD = D + PAD, LS = BK + PAD;
  constexpr int DC = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LD
  float* dOs = Qs + BQ * LD;   // BQ x LD
  float* Ks = dOs + BQ * LD;   // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Ss = Vs + BK * LD;    // BQ x LS: dS
  float* Ls = Ss + BQ * LS;    // lse per row
  float* Dd = Ls + BQ;         // D per row

  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* kb = k + b * kl.sb + hd * kl.sh;
  const float* vb = v + b * vl.sb + hd * vl.sh;

  load_rows_f32<D>(Qs, q + b * ql.sb + hd * ql.sh + q0 * ql.st, ql.st, BQ,
                   Tq - q0, tid);
  load_rows_f32<D>(dOs, dout + b * dl.sb + hd * dl.sh + q0 * dl.st, dl.st, BQ,
                   Tq - q0, tid);
  if (tid < BQ) {
    const bool in = q0 + tid < Tq;
    Ls[tid] = in ? lse[(size_t)bh * Tq + q0 + tid] : NEG_INF;
    Dd[tid] = in ? dvec[(size_t)bh * Tq + q0 + tid] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers of Ks, Vs and Ss are done
    load_rows_f32<D>(Ks, kb + k0 * kl.st, kl.st, BK, Tk - k0, tid);
    load_rows_f32<D>(Vs, vb + k0 * vl.st, vl.st, BK, Tk - k0, tid);
    __syncthreads();

    // S and dP: rows ty + 16 i, keys tx + 16 j of this tile
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[2], vv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        ov[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        const float L = Ls[r];
        const bool valid = L > NEG_INF * 0.5f && kpos < Tk &&
                           (!causal || qpos >= kpos);
        const float p = valid ? expf(s[i][j] * scale - L) : 0.f;
        Ss[r * LS + c] = p * (dp[i][j] - Dd[r]);
      }
    }
    __syncthreads();

    // dq += dS K: rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * LS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr < Tq) {
      float* row = dq + (((size_t)b * Tq + qr) * H + hd) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) row[tx + 16 * c] = acc[i][c] * scale;
    }
  }
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BKV_F + 2 * BQV_F) * (D + PAD) +
                          2 * (size_t)BKV_F * (BQV_F + PAD) + 2 * BQV_F);
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_bwd_dkv_f32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout, Rows ql, Rows kl,
                      Rows vl, Rows dl, const float* __restrict__ lse,
                      const float* __restrict__ dvec, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int Tq, int Tk,
                      int causal, float scale) {
  constexpr int BKV = BKV_F, BQ = BQV_F, LD = D + PAD, LS = BQ + PAD;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;            // BKV x LD
  float* Vs = Ks + BKV * LD;   // BKV x LD
  float* Qs = Vs + BKV * LD;   // BQ x LD
  float* dOs = Qs + BQ * LD;   // BQ x LD
  float* Ps = dOs + BQ * LD;   // BKV x LS: P^T
  float* dSs = Ps + BKV * LS;  // BKV x LS: dS^T
  float* Ls = dSs + BKV * LS;  // lse per query of the tile
  float* Dd = Ls + BQ;         // D per query of the tile

  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int k0 = blockIdx.y * BKV;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = q + b * ql.sb + hd * ql.sh;
  const float* db = dout + b * dl.sb + hd * dl.sh;

  load_rows_f32<D>(Ks, k + b * kl.sb + hd * kl.sh + k0 * kl.st, kl.st, BKV,
                   Tk - k0, tid);
  load_rows_f32<D>(Vs, v + b * vl.sb + hd * vl.sh + k0 * vl.st, vl.st, BKV,
                   Tk - k0, tid);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int nq = (Tq + BQ - 1) / BQ;
  const int qt0 = causal ? min(k0 / BQ, nq) : 0;
  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_rows_f32<D>(Qs, qb + q0 * ql.st, ql.st, BQ, Tq - q0, tid);
    load_rows_f32<D>(dOs, db + q0 * dl.st, dl.st, BQ, Tq - q0, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < Tq;
      Ls[tid] = in ? lse[(size_t)bh * Tq + q0 + tid] : NEG_INF;
      Dd[tid] = in ? dvec[(size_t)bh * Tq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: key rows ty + 16 i, queries tx + 16 j of this tile
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[2], ov[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * LD + d];
        vv[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + d];
        ov[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kpos = k0 + r, qpos = q0 + c;
        const float L = Ls[c];
        const bool valid = L > NEG_INF * 0.5f && kpos < Tk &&
                           (!causal || qpos >= kpos);
        const float p = valid ? expf(s[i][j] * scale - L) : 0.f;
        Ps[r * LS + c] = p;
        dSs[r * LS + c] = p * (dp[i][j] - Dd[c]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: key rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < BQ; ++j) {
      float pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[(ty + 16 * i) * LS + j];
        sv[i] = dSs[(ty + 16 * i) * LS + j];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float ov = dOs[j * LD + tx + 16 * c];
        const float qv = Qs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][c] = fmaf(pv[i], ov, dva[i][c]);
          dka[i][c] = fmaf(sv[i], qv, dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr < Tk) {
      const size_t off = (((size_t)b * Tk + kr) * H + hd) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[off + tx + 16 * c] = dka[i][c] * scale;
        dv[off + tx + 16 * c] = dva[i][c];
      }
    }
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dq_bf16(const BwdMaps& maps, const float* lse, float* delta,
                   void* dq, int B, int H, int Tq, int Tk, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(DqSmem<D>) + 1024;  // + alignment slack
  cudaError_t err = prepare(flash_bwd_dq_bf16<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid((Tq + TILE - 1) / TILE * B * H, &err);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_bf16<D><<<grid, 3 * WG, smem, stream>>>(
      maps, lse, delta, static_cast<__nv_bfloat16*>(dq), B * H, H, Tq, Tk,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const BwdMaps& maps, const float* lse,
                    const float* delta, int B, int H, int Tq, int Tk,
                    int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  cudaError_t err = prepare(flash_bwd_dkv_bf16<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid((Tk + TILE - 1) / TILE * B * H, &err);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_bf16<D><<<grid, 3 * WG, smem, stream>>>(
      maps, lse, delta, B * H, H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int launch_dq_f32(Kernel kernel, size_t smem, const void* q, const void* k,
                  const void* v, const void* dout, Rows ql, Rows kl, Rows vl,
                  Rows dl, const float* lse, const float* dvec, void* dq,
                  int B, int H, int Tq, int Tk, int causal, float scale,
                  cudaStream_t stream) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BQ_F - 1) / BQ_F);
  kernel<<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), ql, kl,
      vl, dl, lse, dvec, static_cast<float*>(dq), H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int launch_dkv_f32(Kernel kernel, size_t smem, const void* q, const void* k,
                   const void* v, const void* dout, Rows ql, Rows kl,
                   Rows vl, Rows dl, const float* lse, const float* dvec,
                   void* dk, void* dv, int B, int H, int Tq, int Tk,
                   int causal, float scale, cudaStream_t stream) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tk + BKV_F - 1) / BKV_F);
  kernel<<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), ql, kl,
      vl, dl, lse, dvec, static_cast<float*>(dk), static_cast<float*>(dv), H,
      Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 kernels' tensor maps, encoded once per backward call into
// `maps` (896 bytes: q, k, v, dout, out, dk, dv, in that order) and handed
// to both launches. q, dout, out: (B, Tq, H, D), k and v: (B, Tk, H, D)
// bf16, each with its own batch, time and head strides (in elements; D
// contiguous, every stride a multiple of 8 and every base 16-byte aligned,
// as TMA reads them); dk and dv: contiguous (B, Tk, H, D) bf16. Returns 0,
// 20000 + the CUresult when cuTensorMapEncodeTiled refuses an operand, or
// cudaErrorInvalidValue for another D.
extern "C" int mmlspark_flash_attention_bwd_encode(
    void* maps, const void* q, const void* k, const void* v,
    const void* dout, const void* out, const void* dk, const void* dv,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long d_sb, long long d_st, long long d_sh,
    long long o_sb, long long o_st, long long o_sh, int B, int H, int Tq,
    int Tk, int D) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  BwdMaps m;
  CUtensorMap* dst[7] = {&m.q, &m.k, &m.v, &m.dout, &m.o, &m.dk, &m.dv};
  const void* base[7] = {q, k, v, dout, out, dk, dv};
  const Rows packed{(long long)Tk * H * D, (long long)H * D, D};
  const Rows layout[7] = {{q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
                          {v_sb, v_st, v_sh}, {d_sb, d_st, d_sh},
                          {o_sb, o_st, o_sh}, packed, packed};
  const int len[7] = {Tq, Tk, Tk, Tq, Tq, Tk, Tk};
  for (int i = 0; i < 7; ++i) {
    const int rc =
        encode_operand(dst[i], base[i], layout[i], B, H, len[i], D, RT);
    if (rc != 0) return TMA_ENCODE_FAILED + rc;
  }
  memcpy(maps, &m, sizeof m);
  return 0;
}

// dtype 1 (bfloat16): `maps` from mmlspark_flash_attention_bwd_encode; the
// pointers and strides of q, k, v, dout (and dk, dv below) are not read. lse: contiguous
// (B*H, Tq) float32, the forward's logsumexp; the kernel writes
// rowsum(dO * O) into dvec, contiguous (B*H, Tq) float32, for the dk/dv
// launch that follows on the same stream.
// dtype 0 (float32): maps unused (may be null); q, k, v, dout as described
// above, in float32; dvec holds rowsum(dO * O) and is read.
// dq: contiguous (B, Tq, H, D) of the input type. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success); an unsupported dtype or D, or bf16 without maps, gives
// cudaErrorInvalidValue.
extern "C" int mmlspark_flash_attention_bwd_dq(
    const void* maps, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, void* dvec, void* dq, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long d_sb, long long d_st, long long d_sh, int B, int H, int Tq,
    int Tk, int D, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows ql{q_sb, q_st, q_sh}, kl{k_sb, k_st, k_sh}, vl{v_sb, v_st, v_sh},
      dl{d_sb, d_st, d_sh};
  const float* L = static_cast<const float*>(lse);
  float* Dv = static_cast<float*>(dvec);
  if (dtype == 1 && maps != nullptr && (D == 64 || D == 128)) {
    BwdMaps m;
    memcpy(&m, maps, sizeof m);
    return D == 64 ? launch_dq_bf16<64>(m, L, Dv, dq, B, H, Tq, Tk, causal,
                                        scale, s)
                   : launch_dq_bf16<128>(m, L, Dv, dq, B, H, Tq, Tk, causal,
                                         scale, s);
  }
  if (dtype == 0 && D == 64)
    return launch_dq_f32(flash_bwd_dq_f32<64>, dq_f32_smem_bytes<64>(), q, k,
                         v, dout, ql, kl, vl, dl, L, Dv, dq, B, H, Tq, Tk,
                         causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_dq_f32(flash_bwd_dq_f32<128>, dq_f32_smem_bytes<128>(), q,
                         k, v, dout, ql, kl, vl, dl, L, Dv, dq, B, H, Tq, Tk,
                         causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As above; dvec is read (for bf16, as the dq launch wrote it); dk and dv:
// contiguous (B, Tk, H, D) of the input type.
extern "C" int mmlspark_flash_attention_bwd_dkv(
    const void* maps, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dvec, void* dk, void* dv,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long d_sb, long long d_st, long long d_sh, int B,
    int H, int Tq, int Tk, int D, int causal, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows ql{q_sb, q_st, q_sh}, kl{k_sb, k_st, k_sh}, vl{v_sb, v_st, v_sh},
      dl{d_sb, d_st, d_sh};
  const float* L = static_cast<const float*>(lse);
  const float* Dv = static_cast<const float*>(dvec);
  if (dtype == 1 && maps != nullptr && (D == 64 || D == 128)) {
    BwdMaps m;
    memcpy(&m, maps, sizeof m);
    return D == 64 ? launch_dkv_bf16<64>(m, L, Dv, B, H, Tq, Tk, causal,
                                         scale, s)
                   : launch_dkv_bf16<128>(m, L, Dv, B, H, Tq, Tk, causal,
                                          scale, s);
  }
  if (dtype == 0 && D == 64)
    return launch_dkv_f32(flash_bwd_dkv_f32<64>, dkv_f32_smem_bytes<64>(), q,
                          k, v, dout, ql, kl, vl, dl, L, Dv, dk, dv, B, H, Tq,
                          Tk, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_dkv_f32(flash_bwd_dkv_f32<128>, dkv_f32_smem_bytes<128>(),
                          q, k, v, dout, ql, kl, vl, dl, L, Dv, dk, dv, B, H,
                          Tq, Tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The wgmma probe on one tile: a and b contiguous (64, D) bf16 (D 64 or
// 128), s (64, 64) and o (64, D) contiguous float32 (see wgmma_tile_probe).
// Returns as the launches above.
extern "C" int mmlspark_wgmma_tile_probe(const void* a, const void* b,
                                         void* s_out, void* o_out, int D,
                                         void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const Rows l{(long long)RT * D, D, D};
  int rc = encode_operand(&ta, a, l, 1, 1, RT, D, RT);
  if (rc == 0) rc = encode_operand(&tb, b, l, 1, 1, RT, D, RT);
  if (rc != 0) return TMA_ENCODE_FAILED + rc;
  auto kernel = D == 64 ? wgmma_tile_probe<64> : wgmma_tile_probe<128>;
  const size_t smem =
      (D == 64 ? sizeof(ProbeSmem<64>) : sizeof(ProbeSmem<128>)) + 1024;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, WG, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<float*>(s_out), static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  if (code >= TMA_ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused an operand (code - 20000 is its "
           "CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
