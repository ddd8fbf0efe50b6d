// Layernorm rows on Hopper: the launch geometry and the row helpers that the
// forward kernel (forecaster.cu) and the backward kernel
// (forecaster_train.cu) share.
//
// Both kernels are bound by latency, not by bytes or operations, at the
// forecaster's sizes: a row of 256 bf16 values is 512 bytes, and the
// service's batches give 64 (B = 1), 1,024 (B = 16) or 2,048 (B = 32) rows.
// A warp's time is its chain of dependent steps: the loads, then two (the
// forward) or three (the backward) butterfly sums of five shuffles each,
// then the stores. So the geometry spreads the rows over the SMs, one row a
// warp, and a warp issues every load of its row (and the scale's, 16 bytes
// at a time) before its first sum.
//
// Geometry (kernels/forecaster.py's layernorm_geometry computes the same;
// the C launchers refuse any other):
//   - a block is kWarps warps; warp w of block b takes row b * kWarps + w,
//     and lane l of it the 8 values at columns 8 * (32 * c + l),
//     c < chunks = ceil(D / 256);
//   - the backward's blocks form clusters of the largest power of two up to
//     8 that is not over the blocks; its grid is the blocks rounded up to
//     a whole number of clusters, and the blocks past the rows add zero
//     rows.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace chana_ln {

constexpr int kWarps = 8;  // warps a block, both kernels
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunks = 4;   // 16-byte chunks a lane holds a row
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSmemNoOptIn = 48 * 1024;  // dynamic smem without opting in

struct Geometry {
  int chunks;   // ceil(D / 256)
  int blocks;   // blocks that hold rows: ceil(R / kWarps)
  int cluster;  // the backward's blocks a cluster: 1, 2, 4 or 8
  int grid;     // the backward's grid: blocks, padded to clusters
  int smem;     // the backward's dynamic shared memory, bytes: a float
                // row of D a warp and one a cluster block
};

inline bool geometry(int R, int D, Geometry* g) {
  if (R <= 0 || D <= 0 || D % 8 != 0 || D > kMaxChunks * 256) return false;
  g->chunks = (D + 255) / 256;
  g->blocks = (int)((R + (long long)kWarps - 1) / kWarps);
  int c = kMaxCluster;
  while (c > g->blocks) c /= 2;
  g->cluster = c;
  g->grid = (g->blocks + c - 1) / c * c;
  g->smem = (kWarps + c) * D * (int)sizeof(float);
  return true;
}

// The geometry as five ints (chunks, blocks, cluster, grid, smem) for the
// C interface; 0 when the shape is refused.
inline int geometry_ints(int R, int D, int* out) {
  Geometry g;
  if (!geometry(R, D, &g)) return 0;
  out[0] = g.chunks;
  out[1] = g.blocks;
  out[2] = g.cluster;
  out[3] = g.grid;
  out[4] = g.smem;
  return 1;
}

// N butterfly sums over the warp side by side: every lane gets each total,
// added in the order a single chain of xor 16, 8, 4, 2, 1 adds it.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// The butterfly sum of one float a lane: every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
  float a[1] = {v};
  warp_sums(a);
  return a[0];
}

// Eight bf16 values of a 16-byte word as float32.
__device__ __forceinline__ void unpack8(const uint4 raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 p;
    *reinterpret_cast<uint32_t*>(&p) = w[k];
    const float2 f = __bfloat1622float2(p);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Eight float32 values rounded to bf16, as one 16-byte word.
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The scale's 8 values at column col, as two 16-byte loads.
__device__ __forceinline__ void load_scale8(const float* __restrict__ scale,
                                            int col, float (&s)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(scale + col);
  const float4 b = *reinterpret_cast<const float4*>(scale + col + 4);
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

}  // namespace chana_ln
