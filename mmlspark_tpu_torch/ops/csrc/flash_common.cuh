// Device helpers shared by the flash-attention kernels for Hopper (sm_90a):
// flash_attention_fwd.cu and flash_attention_bwd.cu each include this file
// and are compiled into their own library, so everything here has internal
// linkage. The bf16 kernels' TMA, mbarrier and wgmma building blocks are in
// hopper_common.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_common.cuh"  // encode_bf16_4d

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// row pointers of one (batch, head): element (t, d) at base + t * st + d
struct Rows {
  long long sb, st, sh;  // strides of batch, time and head, in elements
};

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

// the 4-D tensor map over (D, H, T, B) of a (B, T, H, D) bf16 operand with
// its own strides `l` (elements), in boxes of 64 of D x 1 head x `rows`
// time steps x 1 batch; returns encode_bf16_4d's CUresult
inline int encode_operand(CUtensorMap* map, const void* base, Rows l, int B,
                          int H, int T, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)l.sh * 2, (cuuint64_t)l.st * 2,
                                 (cuuint64_t)l.sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return encode_bf16_4d(map, base, dims, strides, box);
}

}  // namespace
