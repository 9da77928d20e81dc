// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++: two
// kernels, dq and dk/dv.
//
// Replaces the TPU kernels mmlspark_tpu/ops/pallas_kernels.py:
// _flash_bwd_dq_kernel (pallas_call in _flash_attention_bwd, :295) and
// _flash_bwd_dkv_kernel (:309). They compute the same functions with the
// same masks and rounding points, from the forward's saved row logsumexp
// `lse` and the row dot D = rowsum(dO * O) (float32, computed by the
// wrapper as the JAX package computes it in XLA outside its kernels):
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
// -> 0.208 ms at the tensor-core peak. dk/dv does four (S^T, dP^T, P^T dO,
// dS^T Q), 8*D FLOP: 2.75e11 FLOP -> 0.278 ms. Each reads q, k, v, dO
// (4 x 33.5 MB) and lse, D (2 x 0.5 MB), about 135 MB, and writes 34 MB (dq)
// or 67 MB (dk, dv): 0.05-0.06 ms at the memory rate. Both kernels are
// bound by operations, 4-5x over their bytes.
//
// Design. The TPU kernels carry their accumulators in VMEM scratch across a
// sequential grid axis; here blocks run in parallel and in no order, so the
// split into two kernels keeps every accumulator in one block's registers
// and needs no atomics: the gradients are deterministic, the same bits for
// the same step.
//   dq:   one block per (batch*head, 64-row query tile), looping over 32-key
//         K/V tiles (double-buffered with cp.async). Per tile it recomputes
//         S = Q K^T exactly as the forward does (same fragments, same
//         k-step order), forms P from lse, dP = dO V^T, dS, and adds dS K.
//         Tiles wholly above the causal diagonal are never loaded; the
//         blocks with the most causal work are numbered first.
//   dk/dv: one block per (batch*head, 64-row key tile), looping over
//         32-row Q/dO tiles (double-buffered, with their lse and D rows).
//         It computes S^T = K Q^T and dP^T = V dO^T directly, so P^T and
//         dS^T sit in registers in the A-fragment layout of dV += P^T dO
//         and dK += dS^T Q, and nothing is transposed through shared memory.
//         Causal Q tiles wholly above the diagonal are skipped.
// Both read q, k, v and dO in place through their (batch, time, head)
// strides, mask the ragged Tq/Tk edges in-kernel (only on the tiles that
// meet an edge or the diagonal), and run the softmax in base 2 with the
// scale folded into one multiply.
//
// bfloat16 (the training path): 4 warps of mma.sync.m16n8k16, each warp
// owning 16 rows, with the products of flash_common.cuh. float32 (a tight
// check of the algorithm on the card): CUDA-core fused multiply-adds,
// 256 threads, shared-memory tiles.
//
// Not yet done, and the way to the bound: wgmma from shared memory, TMA
// loads, warp-specialised pipelining, larger tiles per block.

#include "flash_common.cuh"

namespace {

constexpr int BQ_DQ = 64;  // query rows per dq block (4 warps x 16)
constexpr int BK_DQ = 32;  // keys per inner tile of dq
constexpr int BK_KV = 64;  // key rows per dk/dv block (4 warps x 16)
constexpr int BQ_KV = 32;  // query rows per inner tile of dk/dv

// ---------------------------------------------------------------- bfloat16

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO + two buffers each of K and V
  return sizeof(__nv_bfloat16) * (size_t)(2 * BQ_DQ + 4 * BK_DQ) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout, Rows ql,
                      Rows kl, Rows vl, Rows dl, const float* __restrict__ lse,
                      const float* __restrict__ dvec,
                      __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk,
                      int causal, float scale) {
  constexpr int BQ = BQ_DQ, BK = BK_DQ;
  constexpr int LD = D + 8;
  constexpr int NT = BK / 8;  // n-tiles of S per warp
  constexpr int DT = D / 8;   // n-tiles of dq per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* Ks0 = dOs + BQ * LD;  // K and V, double-buffered
  __nv_bfloat16* Vs0 = Ks0 + 2 * BK * LD;

  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // most causal work first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in quad
  const int wr = warp * 16 + g;           // this lane's first row in the tile
  const __nv_bfloat16* kb = k + b * kl.sb + hd * kl.sh;
  const __nv_bfloat16* vb = v + b * vl.sb + hd * vl.sh;
  const float sl2 = scale * LOG2E;

  stage_rows_async<D, LD>(Qs, q + b * ql.sb + hd * ql.sh + q0 * ql.st, ql.st,
                          BQ, Tq - q0, tid);
  stage_rows_async<D, LD>(dOs, dout + b * dl.sb + hd * dl.sh + q0 * dl.st,
                          dl.st, BQ, Tq - q0, tid);
  stage_rows_async<D, LD>(Ks0, kb, kl.st, BK, Tk, tid);
  stage_rows_async<D, LD>(Vs0, vb, vl.st, BK, Tk, tid);
  cp_async_commit();

  // the lane's two rows: lse in log2 units and D; a row past Tq, or one
  // that saw no key, is not live and gets P = 0
  float lse2[2], dd[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + wr + 8 * h;
    const bool in = qr < Tq;
    const float L = in ? lse[(size_t)bh * Tq + qr] : NEG_INF;
    live[h] = L > NEG_INF * 0.5f;
    lse2[h] = live[h] ? L * LOG2E : 0.f;
    dd[h] = in ? dvec[(size_t)bh * Tq + qr] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int nk = (Tk + BK - 1) / BK;
  if (causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);  // skip tiles above the diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    const __nv_bfloat16* Kc = Ks0 + (kt & 1) * BK * LD;
    const __nv_bfloat16* Vc = Vs0 + (kt & 1) * BK * LD;
    if (kt + 1 < nk) {  // the next tile loads while this one computes
      const int k1 = k0 + BK;
      stage_rows_async<D, LD>(Ks0 + ((kt + 1) & 1) * BK * LD,
                              kb + k1 * kl.st, kl.st, BK, Tk - k1, tid);
      stage_rows_async<D, LD>(Vs0 + ((kt + 1) & 1) * BK * LD,
                              vb + k1 * vl.st, vl.st, BK, Tk - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
    mma_abt<D, NT>(s, Qs, Kc, warp, lane);    // S = Q K^T, as the forward
    mma_abt<D, NT>(dp, dOs, Vc, warp, lane);  // dP = dO V^T

    // P from lse, then dS = P (dP - D) in place of S. Element e of n-tile
    // nt is row wr + 8*(e>>1), key nt*8 + 2t + (e&1); masks only where
    // this warp's rows meet the causal diagonal or the tile passes Tk
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + warp * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qpos = q0 + wr + (h << 3);
        const int kpos = k0 + nt * 8 + t * 2 + (e & 1);
        const bool valid =
            live[h] && (!edge || (kpos < Tk && (!causal || qpos >= kpos)));
        const float p = valid ? exp2f(s[nt][e] * sl2 - lse2[h]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dd[h]);
      }
    }

    mma_pb<D, NT>(acc, s, Kc, lane);  // dq += dS K, dS rounded to bf16
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + wr + 8 * h;
    if (qr >= Tq) continue;
    __nv_bfloat16* row = dq + (((size_t)b * Tq + qr) * H + hd) * D + t * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // K, V + two buffers each of Q, dO,
                                     // lse and D
  return sizeof(__nv_bfloat16) * (size_t)(2 * BK_KV + 4 * BQ_KV) * (D + 8) +
         sizeof(float) * 4 * BQ_KV;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout, Rows ql,
                       Rows kl, Rows vl, Rows dl,
                       const float* __restrict__ lse,
                       const float* __restrict__ dvec,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk,
                       int causal, float scale) {
  constexpr int BKV = BK_KV, BQ = BQ_KV;
  constexpr int LD = D + 8;
  constexpr int NT = BQ / 8;  // n-tiles of S^T per warp
  constexpr int DT = D / 8;   // n-tiles of dk and dv per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BKV * LD;
  __nv_bfloat16* Qs0 = Vs + BKV * LD;  // Q and dO, double-buffered
  __nv_bfloat16* dOs0 = Qs0 + 2 * BQ * LD;
  float* Ls0 = reinterpret_cast<float*>(dOs0 + 2 * BQ * LD);  // lse, D rows
  float* Ds0 = Ls0 + 2 * BQ;

  const int bh = blockIdx.x, b = bh / H, hd = bh % H;
  const int k0 = blockIdx.y * BKV;  // the first key tiles see the most queries
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16 + g;  // this lane's first key row in the tile
  const __nv_bfloat16* qb = q + b * ql.sb + hd * ql.sh;
  const __nv_bfloat16* db = dout + b * dl.sb + hd * dl.sh;
  const float* lb = lse + (size_t)bh * Tq;
  const float* vecb = dvec + (size_t)bh * Tq;
  const float sl2 = scale * LOG2E;

  // one Q tile's rows: Q, dO, and the per-row lse and D (zeros past Tq)
  auto stage_q = [&](int q0, int buf) {
    stage_rows_async<D, LD>(Qs0 + buf * BQ * LD, qb + q0 * ql.st, ql.st, BQ,
                            Tq - q0, tid);
    stage_rows_async<D, LD>(dOs0 + buf * BQ * LD, db + q0 * dl.st, dl.st, BQ,
                            Tq - q0, tid);
    for (int i = tid; i < BQ; i += MMA_THREADS) {
      const bool ok = q0 + i < Tq;
      cp_async_4(Ls0 + buf * BQ + i, ok ? lb + q0 + i : lb, ok ? 4 : 0);
      cp_async_4(Ds0 + buf * BQ + i, ok ? vecb + q0 + i : vecb, ok ? 4 : 0);
    }
  };

  stage_rows_async<D, LD>(Ks, k + b * kl.sb + hd * kl.sh + k0 * kl.st, kl.st,
                          BKV, Tk - k0, tid);
  stage_rows_async<D, LD>(Vs, v + b * vl.sb + hd * vl.sh + k0 * vl.st, vl.st,
                          BKV, Tk - k0, tid);
  const int nq = (Tq + BQ - 1) / BQ;
  // causal: the first Q tile holding a query >= k0 (none past Tq: zeros out)
  const int qt0 = causal ? min(k0 / BQ, nq) : 0;
  if (qt0 < nq) stage_q(qt0 * BQ, 0);
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * BQ, buf = (qt - qt0) & 1;
    if (qt + 1 < nq) {  // the next tile loads while this one computes
      stage_q(q0 + BQ, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qc = Qs0 + buf * BQ * LD;
    const __nv_bfloat16* dOc = dOs0 + buf * BQ * LD;
    const float* Lc = Ls0 + buf * BQ;
    const float* Dc = Ds0 + buf * BQ;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
    mma_abt<D, NT>(s, Ks, Qc, warp, lane);    // S^T = K Q^T
    mma_abt<D, NT>(dp, Vs, dOc, warp, lane);  // dP^T = V dO^T

    // P^T into s, dS^T into dp. Element e of n-tile nt is key row
    // wr + 8*(e>>1), query nt*8 + 2t + (e&1) of this tile; masks only
    // where the tile meets the causal diagonal or a ragged edge
    const bool edge = q0 + BQ > Tq || k0 + BKV > Tk ||
                      (causal && q0 < k0 + warp * 16 + 15);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + wr + ((e >> 1) << 3);
        const int qc = nt * 8 + t * 2 + (e & 1);
        const int qpos = q0 + qc;
        const float L = Lc[qc];
        const bool valid =
            L > NEG_INF * 0.5f &&
            (!edge || (qpos < Tq && kpos < Tk && (!causal || qpos >= kpos)));
        const float p = valid ? exp2f(s[nt][e] * sl2 - L * LOG2E) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - Dc[qc]);
      }
    }

    mma_pb<D, NT>(dva, s, dOc, lane);  // dV += P^T dO, P rounded to bf16
    mma_pb<D, NT>(dka, dp, Qc, lane);  // dK += dS^T Q, dS rounded to bf16
    __syncthreads();  // every warp is done with this buffer before it refills
  }
  cp_async_wait<0>();  // a block no query sees still has K and V in flight

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = k0 + wr + 8 * h;
    if (kr >= Tk) continue;
    const size_t off = (((size_t)b * Tk + kr) * H + hd) * D + t * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + j * 8) =
          pack_bf16(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + j * 8) =
          pack_bf16(dva[j][2 * h], dva[j][2 * h + 1]);
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

template <typename T, typename Kernel>
int launch_dq(Kernel kernel, size_t smem, int threads, int rows_per_block,
              const void* q, const void* k, const void* v, const void* dout,
              Rows ql, Rows kl, Rows vl, Rows dl, const float* lse,
              const float* dvec, void* dq, int B, int H, int Tq, int Tk,
              int causal, float scale, cudaStream_t stream) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), ql, kl, vl, dl,
      lse, dvec, static_cast<T*>(dq), H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename Kernel>
int launch_dkv(Kernel kernel, size_t smem, int threads, int rows_per_block,
               const void* q, const void* k, const void* v, const void* dout,
               Rows ql, Rows kl, Rows vl, Rows dl, const float* lse,
               const float* dvec, void* dk, void* dv, int B, int H, int Tq,
               int Tk, int causal, float scale, cudaStream_t stream) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tk + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), ql, kl, vl, dl,
      lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout: (B, Tq, H, D), k and v: (B, Tk, H, D), each with its own batch,
// time and head strides (in elements; D contiguous; for bfloat16 every
// stride a multiple of 8 and every base 16-byte aligned), all of one type
// (dtype 0 = float32, 1 = bfloat16). lse, dvec: contiguous (B*H, Tq)
// float32 (the forward's logsumexp and rowsum(dO * O)). dq: contiguous
// (B, Tq, H, D) of the input type. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success); an
// unsupported dtype or D gives cudaErrorInvalidValue.
extern "C" int mmlspark_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dvec, void* dq, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long d_sb, long long d_st, long long d_sh, int B, int H, int Tq,
    int Tk, int D, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows ql{q_sb, q_st, q_sh}, kl{k_sb, k_st, k_sh}, vl{v_sb, v_st, v_sh},
      dl{d_sb, d_st, d_sh};
  const float* L = static_cast<const float*>(lse);
  const float* Dv = static_cast<const float*>(dvec);
  if (dtype == 0 && D == 64)
    return launch_dq<float>(flash_bwd_dq_f32<64>, dq_f32_smem_bytes<64>(),
                            FMA_THREADS, BQ_F, q, k, v, dout, ql, kl, vl, dl,
                            L, Dv, dq, B, H, Tq, Tk, causal, scale, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float>(flash_bwd_dq_f32<128>, dq_f32_smem_bytes<128>(),
                            FMA_THREADS, BQ_F, q, k, v, dout, ql, kl, vl, dl,
                            L, Dv, dq, B, H, Tq, Tk, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16>(flash_bwd_dq_bf16<64>, dq_smem_bytes<64>(),
                                    MMA_THREADS, BQ_DQ, q, k, v, dout, ql, kl,
                                    vl, dl, L, Dv, dq, B, H, Tq, Tk, causal,
                                    scale, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16>(flash_bwd_dq_bf16<128>,
                                    dq_smem_bytes<128>(), MMA_THREADS, BQ_DQ,
                                    q, k, v, dout, ql, kl, vl, dl, L, Dv, dq,
                                    B, H, Tq, Tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As above; dk and dv: contiguous (B, Tk, H, D) of the input type.
extern "C" int mmlspark_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dvec, void* dk, void* dv, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long d_sb, long long d_st, long long d_sh, int B, int H, int Tq,
    int Tk, int D, int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows ql{q_sb, q_st, q_sh}, kl{k_sb, k_st, k_sh}, vl{v_sb, v_st, v_sh},
      dl{d_sb, d_st, d_sh};
  const float* L = static_cast<const float*>(lse);
  const float* Dv = static_cast<const float*>(dvec);
  if (dtype == 0 && D == 64)
    return launch_dkv<float>(flash_bwd_dkv_f32<64>, dkv_f32_smem_bytes<64>(),
                             FMA_THREADS, BKV_F, q, k, v, dout, ql, kl, vl,
                             dl, L, Dv, dk, dv, B, H, Tq, Tk, causal, scale,
                             s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float>(flash_bwd_dkv_f32<128>,
                             dkv_f32_smem_bytes<128>(), FMA_THREADS, BKV_F, q,
                             k, v, dout, ql, kl, vl, dl, L, Dv, dk, dv, B, H,
                             Tq, Tk, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16>(
        flash_bwd_dkv_bf16<64>, dkv_smem_bytes<64>(), MMA_THREADS, BK_KV, q,
        k, v, dout, ql, kl, vl, dl, L, Dv, dk, dv, B, H, Tq, Tk, causal,
        scale, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16>(
        flash_bwd_dkv_bf16<128>, dkv_smem_bytes<128>(), MMA_THREADS, BK_KV, q,
        k, v, dout, ql, kl, vl, dl, L, Dv, dk, dv, B, H, Tq, Tk, causal,
        scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
