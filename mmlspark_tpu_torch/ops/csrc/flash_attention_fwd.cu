// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel mmlspark_tpu/ops/pallas_kernels.py:_flash_kernel
// (reached through _flash_attention_fwd_impl's pallas_call). It computes the
// same function: online-softmax attention of each (batch, head), optional
// causal mask aligned top-left (query i sees keys j <= i), keys past Tk
// masked, output in the input type and the row logsumexp in float32. A row
// that sees no key gets output 0 and lse = NEG_INF (-1e30, not -inf), as on
// the TPU: the guards `m <= NEG_INF / 2` below are the TPU kernel's. Scores
// are float32 sums of input-typed products times `scale`; P is rounded to
// the input type before the PV product, while the denominator sums
// unrounded P.
//
// Bound on the H100 (SXM, 989 TFLOP/s dense bf16, 3.35 TB/s): at the
// serving slice's shape B=8, H=4, T=4096, D=128, causal, one call does
// 2 products x 2 FLOP x 8*4 heads x (4096*4097/2 visible pairs) x 128
// = 1.37e11 FLOP -> 0.14 ms at the tensor-core peak, and moves q, k, v and
// out once (4 x 33.5 MB = 134 MB, + 0.5 MB of lse) -> 0.04 ms at the memory
// rate. So the kernel is bound by operations, about 3.5x over its bytes,
// and only wgmma reaches the tensor cores' full rate.
//
// Design. The TPU kernel's 512x1024 tiles are sized for VMEM and carry the
// softmax state across a sequential grid axis; here a tile is one
// (batch*head, 128-row query tile), walked over its 128-key K/V tiles in an
// inner loop with the online-softmax state (row max m, denominator l,
// output accumulator) in float32 registers. Causal K/V tiles wholly above
// the diagonal are never loaded. The grid is persistent, one block per SM:
// tiles are numbered heaviest first (every head's last query tile, then
// the one before) and dealt to the blocks in a snake, so each block's
// causal work comes out even and the next tile's loads overlap this one's
// epilogue. q, k and v are read in place through their (batch, time, head)
// strides, so the model's fused qkv projection feeds the kernel without a
// copy; out is written as a contiguous (B, Tq, H, D) tensor.
//
// bfloat16 (the serving and training path), warp-specialised, 384 threads:
// - one producer warpgroup (its registers released to 24 a thread with
//   setmaxnreg) in which one thread issues TMA loads: each tile's Q once,
//   then its K and V tiles into a two-stage ring, each buffer guarded by a
//   "full" mbarrier (the TMA's bytes) and an "empty" one (the 8 consumer
//   warps);
// - two consumer warpgroups (240 registers a thread), each owning 64 query
//   rows. Per K/V tile: S = Q K^T by wgmma m64n128k16 with both operands in
//   shared memory (K-major, 128-byte swizzle, as the tensor maps write
//   them); the online softmax in registers on the accumulator layout (base
//   2 with one MUFU.EX2 per score, the scale folded into its multiply-add,
//   masks only on tiles that meet the causal diagonal or the Tk edge, row
//   max over the 4 lanes holding a row, the denominator's lane partials
//   summed once at the end); P rounded to bf16 in registers, where the
//   accumulator of S already has the layout of wgmma's register A operand;
//   O += P V by wgmma m64n{D}k16 with V read MN-major through the transpose
//   bit. K's buffer is released as soon as S has retired, so the next K
//   loads while the softmax runs, and Q's after the tile's last S, so the
//   next tile's Q loads during this one's last PV and epilogue. Each
//   warpgroup stages its rows of out, divided by the denominator, in a
//   swizzled buffer and writes them with TMA stores.
// The two consumer warpgroups already keep the tensor cores fed between
// them: issuing the next tile's S before this tile's softmax, and making
// the warpgroups take turns at their products, each timed within the
// run-to-run spread of this loop at the slice shape (PERF.md).
// The tensor maps are 4-D over (D, H, T, B) with the operand's own byte
// strides and boxes of 64 x 1 x 128 x 1 (one 128-byte swizzled row per
// time step; D = 128 takes two boxes), encoded on the host per call through
// cuTensorMapEncodeTiled; TMA zero-fills the rows past Tq and Tk on loads
// and clips them on stores.
//
// float32 (a tight check of the algorithm on the card): the tensor cores
// have no full-precision f32 product, so this variant runs on the CUDA
// cores: 256 threads, each computing a 4x4 tile of S and a 4 x D/16 tile of
// the output with fused multiply-adds, one softmax row per warp step.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block (float32)

// ---------------------------------------------------------------- bfloat16

constexpr int WG = 128;     // threads of a warpgroup
constexpr int TILE = 128;   // query rows of a tile, keys of a K/V tile
constexpr int BOX = 64;     // bf16 of D in one swizzled 128-byte row
constexpr int STAGES = 2;   // K/V ring
constexpr int CONSUMER_WARPS = 8;
constexpr uint32_t BOX_BYTES = TILE * BOX * 2;  // one TMA box of TILE rows
constexpr int TMA_ENCODE_FAILED = 20000;        // + the CUresult

template <int D>
struct alignas(1024) FwdSmem {
  __nv_bfloat16 q[TILE * D];  // D / BOX boxes of TILE swizzled rows
  __nv_bfloat16 k[STAGES][TILE * D];
  __nv_bfloat16 v[STAGES][TILE * D];
  __nv_bfloat16 o[TILE * D];  // out, staged for the TMA store
  uint64_t q_full, q_empty, k_full[STAGES], v_full[STAGES], k_empty[STAGES],
      v_empty[STAGES];
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128)
    wgmma_m64n128k16_rs(o, a, b, 1);
  else
    wgmma_m64n64k16_rs(o, a, b, 1);
}

template <int D>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   float* __restrict__ lse, int BH, int H, int Tq, int Tk,
                   int causal, float scale) {
  constexpr int CH = D / BOX;  // boxes per tile row
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment; the launch adds the slack
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  const int nq = (Tq + TILE - 1) / TILE, n_tiles = nq * BH;
  // tile i: query tile nq - 1 - i / BH of head i % BH, and its K/V tiles
  // (those wholly above the causal diagonal skipped)
  auto key_tiles = [&](int q0) {
    const int n = (Tk + TILE - 1) / TILE;
    return causal ? min(n, (q0 + TILE - 1) / TILE + 1) : n;
  };
  // the warpgroup, as a value the compiler can see is uniform in a warp
  // (setmaxnreg and wgmma run on whole warpgroups)
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
        mbar_arrive_expect_tx(&sm.q_full, CH * BOX_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_load_4d(sm.q + c * TILE * BOX, &tq, &sm.q_full, c * BOX, hd,
                      q0, b);
        for (int kt = 0; kt < nk; ++kt, ++r) {
          const int s = r % STAGES;
          const uint32_t ph = (r / STAGES) & 1;
          mbar_wait(&sm.k_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&sm.k_full[s], CH * BOX_BYTES);
#pragma unroll
          for (int c = 0; c < CH; ++c)
            tma_load_4d(sm.k[s] + c * TILE * BOX, &tk, &sm.k_full[s],
                        c * BOX, hd, kt * TILE, b);
          mbar_wait(&sm.v_empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&sm.v_full[s], CH * BOX_BYTES);
#pragma unroll
          for (int c = 0; c < CH; ++c)
            tma_load_4d(sm.v[s] + c * TILE * BOX, &tv, &sm.v_full[s],
                        c * BOX, hd, kt * TILE, b);
        }
      }
    }
  } else {  // ------------------------------------------------ consumers
    regs_acquire<240>();
    const int cw = wg - 1;  // this warpgroup's rows: 64 cw .. 64 cw + 63
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, lane in quad
    const float sl2 = scale * LOG2E;       // softmax runs in base 2
    // K-major descriptors (sbo: 8 rows of 128 bytes); k-step ks reads 32
    // bytes further along the row, box ks / 4
    const uint64_t dq = desc_sw128(sm.q + cw * 64 * BOX, 16, 1024);
    __nv_bfloat16* stage = sm.o + cw * 64 * BOX;  // box c at + c * TILE * BOX

    float o[D / 2];  // D/8 n8 tiles x 4: rows row0 (e < 2), row0 + 8 (e >= 2)
    float sc[TILE / 2];         // S, then P: 16 n8 tiles x 4, laid out as o
    uint32_t pa[TILE / 16][4];  // P in bf16: the A operand of 8 k-steps
    float m[2], l[2];           // running max (log2 units), lane's partial sum
    float corr[2];              // this tile's rescale of o's two rows
    uint32_t r = 0;             // K/V tiles consumed so far: the ring position

    for (int j = 0, i; (i = tile_of(j, n_tiles)) >= 0; ++j) {
      const int bh = i % BH, b = bh / H, hd = bh % H;
      const int q0 = (nq - 1 - i / BH) * TILE, nk = key_tiles(q0);
      const int row0 = q0 + cw * 64 + warp * 16 + g;  // and row0 + 8
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
      mbar_wait(&sm.q_full, j & 1);

      for (int kt = 0; kt < nk; ++kt, ++r) {
        const int s = r % STAGES;
        const uint32_t ph = (r / STAGES) & 1;
        const int k0 = kt * TILE;

        // S = Q K^T
        const uint64_t dk = desc_sw128(sm.k[s], 16, 1024);
        mbar_wait(&sm.k_full[s], ph);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = ((ks / 4) * BOX_BYTES + (ks % 4) * 32) >> 4;
          wgmma_m64n128k16_ss(sc, dq + off, dk + off, ks > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(&sm.k_empty[s]);
          if (kt == nk - 1) mbar_arrive(&sm.q_empty);  // Q's last reader
        }

        // to base-2 logits. Masks only where this warpgroup's rows meet the
        // causal diagonal or the tile runs past Tk: element e of n8 tile jj
        // is row row0 + 8 (e >> 1), key k0 + 8 jj + 2 t + (e & 1). Elsewhere,
        // with a positive scale, max and exp read the raw scores and the
        // scale folds into the exp's multiply-add.
        const bool edge =
            k0 + TILE > Tk || (causal && k0 + TILE - 1 > q0 + cw * 64);
        const bool raw = !edge && sl2 > 0.f;
        if (edge) {
#pragma unroll
          for (int jj = 0; jj < TILE / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qpos = row0 + ((e >> 1) << 3);
              const int kpos = k0 + jj * 8 + t * 2 + (e & 1);
              const bool valid = kpos < Tk && (!causal || qpos >= kpos);
              sc[4 * jj + e] = valid ? sc[4 * jj + e] * sl2 : NEG_INF;
            }
          }
        } else if (!raw) {
#pragma unroll
          for (int e = 0; e < TILE / 2; ++e) sc[e] *= sl2;
        }
        const float a = raw ? sl2 : 1.f;

        // online softmax of the lane's two rows; a row lives in one quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = NEG_INF;
#pragma unroll
          for (int jj = 0; jj < TILE / 8; ++jj)
            mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * h], sc[4 * jj + 2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[h], mx * a);
          // a row that has seen no key keeps p = 0: exp2(NEG_INF - 0)
          const float mu = m_new <= NEG_INF * 0.5f ? 0.f : m_new;
          corr[h] = m[h] <= NEG_INF * 0.5f ? 0.f : exp2_approx(m[h] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int jj = 0; jj < TILE / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2_approx(fmaf(sc[4 * jj + 2 * h + e], a, -mu));
              sc[4 * jj + 2 * h + e] = p;
              sum += p;
            }
          }
          l[h] = l[h] * corr[h] + sum;  // the quad sums its lanes at the end
          m[h] = m_new;
        }
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          o[4 * jj + 0] *= corr[0];
          o[4 * jj + 1] *= corr[0];
          o[4 * jj + 2] *= corr[1];
          o[4 * jj + 3] *= corr[1];
        }

        // O += P V: P rounded to bf16 as the register A operand (n8 tiles
        // 2kk and 2kk + 1 are k-step kk's fragment); V MN-major, lbo the
        // next box of D, a k-step 16 rows of 128 bytes
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        const uint64_t dv = desc_sw128(sm.v[s], BOX_BYTES, 1024);
        mbar_wait(&sm.v_full[s], ph);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) fence_regs(pa[kk]);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk)
          wgmma_pv<D>(o, pa[kk], dv + ((kk * 16 * 128) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) fence_regs(pa[kk]);
        if (lane == 0) mbar_arrive(&sm.v_empty[s]);
      }

      // epilogue: out divided by the denominator, staged in this
      // warpgroup's rows swizzled as TMA reads them, then one TMA store per
      // box, which clips the rows past Tq; lse from registers. The staging
      // rows are free once the previous tile's store has read them.
      if (tid == 0) tma_store_wait_read();
      named_barrier(1 + cw, WG);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int rr = warp * 16 + g + 8 * h;  // row among the warpgroup's 64
        const float inv = 1.f / fmaxf(l[h], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(stage + (jj / 8) * TILE * BOX +
                                       rr * BOX + (((jj % 8) ^ g) << 3) +
                                       t * 2) =
              pack_bf16(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
        if (t == 0 && row0 + 8 * h < Tq)
          lse[(size_t)bh * Tq + row0 + 8 * h] =
              m[h] <= NEG_INF * 0.5f ? NEG_INF
                                     : m[h] * LN2 + logf(fmaxf(l[h], 1e-30f));
      }
      fence_proxy_async();
      named_barrier(1 + cw, WG);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < CH; ++c)
          tma_store_4d(&to, stage + c * TILE * BOX, c * BOX, hd,
                       q0 + cw * 64, b);
        tma_store_commit();
      }
    }
    if (tid == 0) tma_store_wait_read();  // before the block's memory goes
  }
}

// ----------------------------------------------------------------- float32

constexpr int FMA_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int BK_FMA = 64;        // keys per inner tile
constexpr int PAD = 1;            // odd row stride: column walks hit distinct banks

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK_FMA) * (D + PAD) +
                          (size_t)BQ * (BK_FMA + PAD) + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, Rows ql, Rows kl, Rows vl,
                  float* __restrict__ out, float* __restrict__ lse, int H,
                  int Tq, int Tk, int causal, float scale) {
  constexpr int BK = BK_FMA;
  constexpr int LD = D + PAD;   // row stride of the Q, K, V tiles
  constexpr int LS = BK + PAD;  // row stride of the score tile
  constexpr int DC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LD
  float* Ks = Qs + BQ * LD;    // BK x LD
  float* Vs = Ks + BK * LD;    // BK x LD
  float* Ss = Vs + BK * LD;    // BQ x LS: scores, then P
  float* m_s = Ss + BQ * LS;   // running row max
  float* l_s = m_s + BQ;       // running row denominator
  float* c_s = l_s + BQ;       // this tile's rescale factor per row

  const int bh = blockIdx.y, b = bh / H, hd = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // most causal work first
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* qb = q + b * ql.sb + hd * ql.sh;
  const float* kb = k + b * kl.sb + hd * kl.sh;
  const float* vb = v + b * vl.sb + hd * vl.sh;

  for (int i = tid; i < BQ * D; i += FMA_THREADS) {
    const int r = i / D, c = i % D, qr = q0 + r;
    Qs[r * LD + c] = qr < Tq ? qb[qr * ql.st + c] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
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
    for (int i = tid; i < BK * D; i += FMA_THREADS) {
      const int r = i / D, c = i % D, kr = k0 + r;
      const bool ok = kr < Tk;
      Ks[r * LD + c] = ok ? kb[kr * kl.st + c] : 0.f;
      Vs[r * LD + c] = ok ? vb[kr * vl.st + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T: rows ty + 16 i, columns tx + 16 j of this tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qpos = q0 + r, kpos = k0 + c;
        const bool valid = kpos < Tk && (!causal || qpos >= kpos);
        Ss[r * LS + c] = valid ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: each of the 8 warps updates 8 rows, 2 scores per lane
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float s0 = Ss[r * LS + lane];
      const float s1 = Ss[r * LS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool none = m_new <= NEG_INF * 0.5f;
      const float p0 = none ? 0.f : expf(s0 - m_new);
      const float p1 = none ? 0.f : expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      Ss[r * LS + lane] = p0;
      Ss[r * LS + lane + 32] = p1;
      if (lane == 0) {
        const float corr = m_prev <= NEG_INF * 0.5f ? 0.f : expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty + 16 i, columns tx + 16 c
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty + 16 * i) * LS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qr = q0 + r;
    if (qr < Tq) {
      const float denom = fmaxf(l_s[r], 1e-30f);
      float* orow = out + (((size_t)b * Tq + qr) * H + hd) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] / denom;
    }
  }
  if (tid < BQ && q0 + tid < Tq) {
    const float m = m_s[tid];
    lse[(size_t)bh * Tq + q0 + tid] =
        m <= NEG_INF * 0.5f ? NEG_INF : m + logf(fmaxf(l_s[tid], 1e-30f));
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, Rows ql, Rows kl,
                Rows vl, void* out, void* lse, int B, int H, int Tq, int Tk,
                int causal, float scale, cudaStream_t stream) {
  // 4-D maps over (D, H, T, B); a box is 64 of D x 1 head x `rows` time
  // steps x 1 batch. out is contiguous and stored 64 rows (a warpgroup's)
  // at a time.
  CUtensorMap maps[4];
  const void* base[4] = {q, k, v, out};
  const Rows layout[4] = {ql, kl, vl,
                          Rows{(long long)Tq * H * D, (long long)H * D, D}};
  const int len[4] = {Tq, Tk, Tk, Tq};
  const int rows[4] = {TILE, TILE, TILE, 64};
  for (int i = 0; i < 4; ++i) {
    const int rc = encode_operand(&maps[i], base[i], layout[i], B, H, len[i],
                                  D, rows[i]);
    if (rc != 0) return TMA_ENCODE_FAILED + rc;
  }
  const size_t smem = sizeof(FwdSmem<D>) + 1024;  // + alignment slack
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a persistent grid: one block per SM, each walking its share of tiles
  const int grid = persistent_grid((Tq + TILE - 1) / TILE * B * H, &err);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_bf16<D><<<grid, 3 * WG, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<float*>(lse), B * H, H,
      Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, Rows ql, Rows kl,
               Rows vl, void* out, void* lse, int B, int H, int Tq, int Tk,
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_f32<D><<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), ql, kl, vl, static_cast<float*>(out),
      static_cast<float*>(lse), H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Tq, H, D), k and v: (B, Tk, H, D), each with its own batch, time
// and head strides (in elements; D contiguous; for bfloat16 every stride a
// multiple of 8 and every base 16-byte aligned, as TMA reads them), all of
// one type (dtype 0 = float32, 1 = bfloat16). out: contiguous (B, Tq, H, D)
// of that type; lse: contiguous (B*H, Tq) float32. Launches on `stream`
// without synchronising and returns the launch's cudaError_t (0 on
// success), or 20000 + the CUresult when cuTensorMapEncodeTiled refuses an
// operand; an unsupported dtype or D gives cudaErrorInvalidValue.
extern "C" int mmlspark_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, int B, int H, int Tq, int Tk, int D, int causal,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows ql{q_sb, q_st, q_sh}, kl{k_sb, k_st, k_sh}, vl{v_sb, v_st, v_sh};
  auto launch = dtype == 0 ? (D == 64 ? launch_f32<64> : launch_f32<128>)
                           : (D == 64 ? launch_bf16<64> : launch_bf16<128>);
  if ((dtype != 0 && dtype != 1) || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, ql, kl, vl, out, lse, B, H, Tq, Tk, causal, scale,
                s);
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  if (code >= TMA_ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused an operand (code - 20000 is its "
           "CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
