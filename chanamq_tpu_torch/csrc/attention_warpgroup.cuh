// What the long-window attention kernels share: forecaster.cu's warpgroup
// forward and forecaster_train.cu's backward pair (64 rows a block on one
// consumer warpgroup, 64-row tiles on a TMA ring, wgmma). Their tile sizes,
// the divisions that give the 16-row kernels' bits without a division
// instruction a value, and the tensor maps that cut a [B, T, heads * width]
// operand into boxes of 64 rows of one head.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace wg_att {

constexpr int kRows = 64;  // query rows of a block: wgmma's m64
constexpr int kKeys = 64;  // keys of a ring tile: the n64 of Q K^T
constexpr int kAtomBytes = 64 * 128;  // a box: 64 rows of 64 bf16

// x / d, correctly rounded, from r = 1 / d correctly rounded (one
// correction step, Markstein's) for x a bf16 logit of 2^-100 or more in
// magnitude and d = sqrt(HD): every such bf16 value at every width that
// takes it (32, 48, 80, 96, 112, 128) gives the division's bits, while
// some under 2^-118 do not, their residuals underflowing.
__device__ __forceinline__ float quotient(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

// x / d with the bits of the division (correctly rounded, as
// chana_att::divide gives it) for 0 <= x <= 1 and d >= 1/2 where the
// quotient is 0 or a normal float (2^-126 or more), from r = 1 / d
// correctly rounded, without the division's reciprocal and branches for
// each x: at x 2^100, so that every residual is exact, a product within
// two ulp, a correction step that leaves it within one and Markstein's
// step that rounds it correctly, scaled back exactly. (Under 2^-126 the
// scaling back would round a second time.)
__device__ __forceinline__ float quotient_rn(float x, float d, float r) {
  const float xs = x * 0x1p100f;
  float q = xs * r;
  q = fmaf(fmaf(-q, d, xs), r, q);
  return fmaf(fmaf(-q, d, xs), r, q) * 0x1p-100f;
}

// The widest span of a row's logits (max - min, at their true scale) under
// which every weight exp(logit - m) / l is 0 or a normal float, l being at
// most T < 2^31: e^-64 / 2^31 > 2^-124.
constexpr float kQuotientSpan = 64.f;

// The least exponential e = exp(logit - m) > 0 for which quotient_rn(e, l)
// holds at any l < 2^31: e / l >= 2^-126.
constexpr float kQuotientLeast = 0x1p-95f;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special function unit (relative error ~2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The map of a bf16 [B, T, heads * width] tensor as [B][T][heads][width]:
// boxes of 64 rows of one head of one batch, 64 values of it a row,
// 128-byte swizzled, zeros past every edge (past width, past T). qkv is
// 3 H heads of HD (q heads, then k's, then v's); dout H heads of HDV.
inline cudaError_t encode_heads(CUtensorMap* map, const void* base, int B,
                                int T, int heads, int width) {
  const chana_tma::EncodeTiled fn = chana_tma::encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)heads * width * 2;  // bytes
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2, row,
                                 row * (cuuint64_t)T};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg_att
