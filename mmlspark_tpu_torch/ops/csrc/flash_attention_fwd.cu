// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel mmlspark_tpu/ops/pallas_kernels.py:_flash_kernel
// (reached through _flash_attention_fwd_impl's pallas_call). It computes the
// same function: online-softmax attention of each (batch, head), optional
// causal mask aligned top-left (query i sees keys j <= i), keys past Tk
// masked, output in the input type and the row logsumexp in float32. A row
// that sees no key gets output 0 and lse = NEG_INF (-1e30, not -inf), as on
// the TPU: the guards `m <= NEG_INF / 2` below are the TPU kernel's. Scores
// are float32 sums of input-typed products times `scale`; P is rounded to the
// input type before the PV product, while the denominator sums unrounded P.
//
// Bound on the H100 (SXM, 989 TFLOP/s dense bf16, 3.35 TB/s): at the
// serving slice's shape B=8, H=4, T=4096, D=128, causal, one call does
// 2 products x 2 FLOP x 8*4 heads x (4096*4097/2 visible pairs) x 128
// = 1.37e11 FLOP -> 0.14 ms at the tensor-core peak, and moves q, k, v and
// out once (4 x 33.5 MB = 134 MB, + 0.5 MB of lse) -> 0.04 ms at the memory
// rate. So the kernel is bound by operations, about 3.5x over its bytes.
//
// Design. The TPU kernel's 512x1024 tiles are sized for VMEM and carry the
// softmax state across a sequential grid axis; here blocks run in parallel
// and in no order, so each thread block owns one (batch*head, 64-row query
// tile) and walks the K/V tiles in an inner loop, with the online-softmax
// state (row max m, denominator l, output accumulator) in float32 registers.
// Causal tiles wholly above the diagonal are never loaded, and the blocks
// with the most causal work are numbered first so they do not form the
// tail. The ragged Tq/Tk edges are zero-filled on load and masked in the
// scores. q, k and v are read in place through their (batch, time, head)
// strides, so the model's fused qkv projection feeds the kernel without a
// copy; out is written as a contiguous (B, Tq, H, D) tensor.
//
// bfloat16 (the serving path): 4 warps, each owning 16 query rows, 32-key
// tiles. Both products run on the tensor cores as mma.sync.m16n8k16 (bf16
// in, f32 accumulate). The score accumulator of S = Q K^T has exactly the
// register layout of the A fragments of the PV product, so P is rounded to
// bf16 and fed back without touching shared memory (the FlashAttention-2
// arrangement). K and V tiles are double-buffered and copied with cp.async,
// so the next tile loads while this one computes; Q, K and V fragments come
// from ldmatrix (transposing for V), one instruction per two fragments. The
// softmax runs in base 2 with the scale folded into one multiply, masks
// only the tiles that meet the causal diagonal or the Tk edge, and needs two
// shuffles per row within the quad of lanes that holds it. (Tile shape and
// keeping Q in shared memory rather than registers were chosen by timing
// the alternatives at the slice shape: 64-key tiles and Q held in registers
// took 10-20 % longer, as their register use halves the blocks per SM.)
//
// float32 (a tight check of the algorithm on the card): the tensor cores
// have no full-precision f32 product, so this variant runs on the CUDA
// cores: 256 threads, each computing a 4x4 tile of S and a 4 x D/16 tile of
// the output with fused multiply-adds, one softmax row per warp step.
//
// Not yet done, and the way to the bound above: wgmma from shared memory
// (the only path to the full tensor-core rate), TMA loads, warp-specialised
// producer/consumer pipelining, and larger query tiles per block.

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;      // query rows per block (both variants)
constexpr int BK_MMA = 32;  // keys per inner tile (bfloat16)

// ---------------------------------------------------------------- bfloat16

template <int D>
constexpr size_t mma_smem_bytes() {  // Q + two buffers each of K and V
  return sizeof(__nv_bfloat16) * (size_t)(BQ + 4 * BK_MMA) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, Rows ql, Rows kl,
                   Rows vl, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int H, int Tq, int Tk, int causal,
                   float scale) {
  constexpr int BK = BK_MMA;
  constexpr int LD = D + 8;      // 16-byte rows; ldmatrix rows hit 32 banks
  constexpr int NT = BK / 8;     // n-tiles of S per warp
  constexpr int DT = D / 8;      // n-tiles of the output per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks0 = Qs + BQ * LD;   // K and V, double-buffered
  __nv_bfloat16* Vs0 = Ks0 + 2 * BK * LD;

  const int bh = blockIdx.y, b = bh / H, hd = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // most causal work first
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, lane in quad
  const int wr = warp * 16 + g;           // this lane's first row in the tile
  const __nv_bfloat16* kb = k + b * kl.sb + hd * kl.sh;
  const __nv_bfloat16* vb = v + b * vl.sb + hd * vl.sh;
  const float sl2 = scale * LOG2E;  // softmax runs in base 2

  stage_rows_async<D, LD>(Qs, q + b * ql.sb + hd * ql.sh + q0 * ql.st, ql.st,
                          BQ, Tq - q0, tid);
  stage_rows_async<D, LD>(Ks0, kb, kl.st, BK, Tk, tid);
  stage_rows_async<D, LD>(Vs0, vb, vl.st, BK, Tk, tid);
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m in log2 units

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

    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_abt<D, NT>(s, Qs, Kc, warp, lane);

    // to base-2 logits; mask only where this warp's rows meet the causal
    // diagonal or the tile runs past Tk. Element e of n-tile nt is row
    // wr + 8*(e>>1), column nt*8 + 2t + (e&1).
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + warp * 16);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + wr + ((e >> 1) << 3);
        const int kpos = k0 + nt * 8 + t * 2 + (e & 1);
        const bool valid =
            !edge || (kpos < Tk && (!causal || qpos >= kpos));
        s[nt][e] = valid ? s[nt][e] * sl2 : NEG_INF;
      }
    }

    // online softmax for the lane's two rows; a row lives in one quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const bool none = m_new <= NEG_INF * 0.5f;
      const float corr = m[h] <= NEG_INF * 0.5f ? 0.f : exp2f(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p = none ? 0.f : exp2f(s[nt][2 * h + i] - m_new);
          s[nt][2 * h + i] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * corr + sum;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * h] *= corr;
        o[j][2 * h + 1] *= corr;
      }
    }

    // O += P V, P rounded to bf16 in registers
    mma_pb<D, NT>(o, s, Vc, lane);
    __syncthreads();  // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + wr + 8 * h;
    if (qr >= Tq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * Tq + qr) * H + hd) * D + t * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(o[j][2 * h] / denom, o[j][2 * h + 1] / denom);
    if (t == 0)
      lse[(size_t)bh * Tq + qr] =
          m[h] <= NEG_INF * 0.5f ? NEG_INF
                                 : m[h] * LN2 + logf(fmaxf(l[h], 1e-30f));
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

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, const void* q,
           const void* k, const void* v, Rows ql, Rows kl, Rows vl, void* out,
           void* lse, int B, int H, int Tq, int Tk, int causal, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ql, kl, vl, static_cast<T*>(out),
      static_cast<float*>(lse), H, Tq, Tk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Tq, H, D), k and v: (B, Tk, H, D), each with its own batch, time
// and head strides (in elements; D contiguous; for bfloat16 every stride a
// multiple of 8 and every base 16-byte aligned), all of one type (dtype
// 0 = float32, 1 = bfloat16). out: contiguous (B, Tq, H, D) of that type;
// lse: contiguous (B*H, Tq) float32. Launches on `stream` without
// synchronising and returns the launch's cudaError_t (0 on success); an
// unsupported dtype or D gives cudaErrorInvalidValue.
extern "C" int mmlspark_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, int B, int H, int Tq, int Tk, int D, int causal,
    float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Rows ql{q_sb, q_st, q_sh}, kl{k_sb, k_st, k_sh}, vl{v_sb, v_st, v_sh};
  if (dtype == 0 && D == 64)
    return launch<float>(flash_fwd_f32<64>, fma_smem_bytes<64>(), FMA_THREADS,
                         q, k, v, ql, kl, vl, out, lse, B, H, Tq, Tk, causal,
                         scale, s);
  if (dtype == 0 && D == 128)
    return launch<float>(flash_fwd_f32<128>, fma_smem_bytes<128>(),
                         FMA_THREADS, q, k, v, ql, kl, vl, out, lse, B, H, Tq,
                         Tk, causal, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16>(flash_fwd_bf16<64>, mma_smem_bytes<64>(),
                                 MMA_THREADS, q, k, v, ql, kl, vl, out, lse, B,
                                 H, Tq, Tk, causal, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16>(flash_fwd_bf16<128>, mma_smem_bytes<128>(),
                                 MMA_THREADS, q, k, v, ql, kl, vl, out, lse, B,
                                 H, Tq, Tk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mmlspark_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
