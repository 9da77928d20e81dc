// Device helpers shared by the flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu and flash_attention_bwd.cu each include this file
// and are compiled into their own library, so everything here has internal
// linkage.
//
// The bf16 backward kernels run 4 warps of mma.sync.m16n8k16 (bf16 in, f32
// accumulate), each warp owning 16 rows of the block's tile. Operand tiles
// sit in shared memory with rows of D + 8 elements (16-byte rows whose
// ldmatrix row addresses hit 32 distinct banks), copied there with cp.async.
// Two products cover every matrix multiply of the backward (the bf16
// forward runs wgmma, flash_attention_fwd.cu):
//   mma_abt: acc += A B^T, A and B both row-major tiles in shared memory
//            (S = Q K^T, dP = dO V^T, and their transposes);
//   mma_pb:  acc += P B, P a score accumulator kept in registers and
//            rounded to bf16 (its C-fragment layout is the A-fragment layout
//            of the next product), B a row-major tile read transposed
//            (O = P V, dQ = dS K, dV = P^T dO, dK = dS^T Q).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_common.cuh"  // smem_addr

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows

// row pointers of one (batch, head): element (t, d) at base + t * st + d
struct Rows {
  long long sb, st, sh;  // strides of batch, time and head, in elements
};

// four 8x8 bf16 matrices, one per quarter-warp of row addresses; lane l
// gets row l/4, columns 2(l%4) and 2(l%4)+1 of each (.trans: the transpose)
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without passing through registers; nbytes 0
// writes zeros (the ragged edge) and reads nothing
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes));
}
// the same for one 4-byte word (per-row float32 statistics)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int nbytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x in one MUFU.EX2 (subnormal results flush to 0, as no softmax weight
// that small moves a float32 sum)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// start copying `rows` rows (row stride `st` elements) into shared memory
// with row stride LD; rows at or past `valid` become zeros
template <int D, int LD>
__device__ __forceinline__ void stage_rows_async(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* src,
                                                 long long st, int rows,
                                                 int valid, int tid) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < rows * VPR; i += MMA_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool ok = r < valid;
    cp_async_16(dst + r * LD + c, ok ? src + r * st + c : src, ok ? 16 : 0);
  }
}

// acc[nt] += A B^T for this warp: A is rows warp*16 .. +15 of a row-major
// shared tile (row stride D + 8), B is rows 0 .. NT*8-1 of another. Element
// e of n-tile nt is A row warp*16 + lane/4 + 8*(e>>1), B row nt*8 +
// 2*(lane%4) + (e&1). ldmatrix_x4 gives A's fragment for one 16-wide
// k-step and the B fragments of two n-tiles, matrices (B rows +0..7 |
// +8..15) x (k +0..7 | +8..15). The k-steps run in order 0 .. D/16-1 in
// both backward kernels, so dq and dk/dv recompute the same scores.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float acc[][4],
                                        const __nv_bfloat16* As,
                                        const __nv_bfloat16* Bs, int warp,
                                        int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, As + (warp * 16 + (mi & 1) * 8 + mr) * LD + ks * 16 +
                        (mi >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, Bs + (np * 16 + (mi >> 1) * 8 + mr) * LD + ks * 16 +
                          (mi & 1) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[j] += P B for this warp: P is its 16 x NT*8 tile held as NT score
// accumulators (the layout mma_abt leaves), rounded here to bf16 as the A
// fragments; B is rows 0 .. NT*8-1 (the k index) of a row-major shared tile
// of width D (the n index). One transposing ldmatrix_x4 gives the B
// fragments of two output n-tiles: matrices (k +0..7 | +8..15) x (n tile
// j | j+1).
template <int D, int NT>
__device__ __forceinline__ void mma_pb(float acc[][4], const float p[][4],
                                       const __nv_bfloat16* Bs, int lane) {
  constexpr int LD = D + 8;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, Bs + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                                (2 * jp + (mi >> 1)) * 8);
      mma_bf16(acc[2 * jp], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], pa, bf[2], bf[3]);
    }
  }
}

}  // namespace
