// Tensor-core building blocks of the causal attention kernels: the forward
// in csrc/forecaster.cu and the backward in csrc/forecaster_train.cu.
//
// A head's rows are staged into shared memory with cp.async (16-byte copies
// where 2 * head_dim allows, else 8 or 4), zero-filled to a padded width
// HDP (a multiple of 16) and to whole 16-row tiles, so the padding adds
// nothing to a dot product. Rows are `ld` bf16 apart: HDP + 8, which puts
// the eight 16-byte rows an ldmatrix phase reads in eight different bank
// groups; at HDP = 16 the rows stay unpadded (two-way conflicts) so that
// the longest windows of the narrowest heads still fit.
//
// Products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on
// fragments loaded with ldmatrix (.trans for an operand stored transposed),
// float32 accumulation. In a warp, lane = 4 g + c holds, of a 16 x 8 float
// accumulator (the C fragment), rows g and g + 8 at columns 2c and 2c + 1;
// a 16 x 16 bf16 A fragment holds the same rows at columns 2c, 2c + 1,
// 8 + 2c and 9 + 2c. So the C fragments of two neighbouring n8 tiles,
// rounded to bf16 and paired, are the A fragment of the next product with
// no trip through shared memory, and a row's max or sum over a tile is a
// lane's own values and two __shfl_xor_sync steps over its quad.
//
// A warp holds the logits of one 16-row query tile against a chunk of key
// tiles in registers: two in the forward, whose four warps share a row's
// key tiles (128 keys a block), four in the backward (64 keys a warp). A
// longer row is taken chunk by chunk, each recomputed from shared memory
// in every pass over the row: the softmax needs the row's max before its
// exponentials and their sum before its weights, and a recomputed chunk
// gives the same bits.
//
// mma.sync, not wgmma: the tiles are 16 x 64 per warp at the forecaster's
// T = 64, head_dim = 64, far under the 64 x N x 16 warpgroup tile's best
// use, and both kernels are bound by launch latency and parallelism (more
// than 20x from either roof), not by the tensor cores' rate.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace chana_att {

constexpr int kTile = 16;      // rows of a query tile, keys of a key tile
constexpr int kFwdChunk = 2;   // key tiles whose logits a forward warp holds
constexpr int kBwdChunk = 4;   // ... and a backward warp
constexpr int kColChunk = 64;  // output columns a warp accumulates at once
constexpr int kTileLd = kTile + 8;  // stride of a [rows][16] bf16 buffer
constexpr int kOutLd = kColChunk + 8;  // stride of a float [16][64] buffer
constexpr int kFwdWarps = 4;  // the forward's warps a query tile
constexpr int kBwdWarps = 4;  // the backward's warps a tile

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  __nv_bfloat162 p;
  *reinterpret_cast<uint32_t*>(&p) = w;
  return __bfloat1622float2(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = smem_u32(dst);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [r0, r0 + n) of one head's slice (hd bf16 at src + row * stride)
// into dst[n][ld]: copies of `bytes` (16, 8 or 4, a divisor of 2 * hd) for
// rows < T and columns < hd, zeros up to column hdp and in rows >= T. Every
// thread of the block takes part; the caller waits and synchronizes.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0, int n,
                                           int T, int hd, int hdp, int ld,
                                           int bytes) {
  const int per_row = hdp * 2 / bytes;
  const int step = bytes / 2;
  // (row, chunk) of this thread's copy, advanced without a divide a copy
  int r = threadIdx.x / per_row, k = threadIdx.x - r * per_row;
  const int dr = blockDim.x / per_row, dk = blockDim.x - dr * per_row;
  for (int idx = threadIdx.x; idx < n * per_row; idx += blockDim.x) {
    const int col = k * step;
    __nv_bfloat16* d = dst + r * ld + col;
    if (r0 + r < T && col < hd) {
      cp_async(d, src + (size_t)(r0 + r) * stride + col, bytes);
    } else if (bytes == 16) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (bytes == 8) {
      *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    } else {
      *reinterpret_cast<uint32_t*>(d) = 0u;
    }
    r += dr;
    k += dk;
    if (k >= per_row) {
      k -= per_row;
      ++r;
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The A fragment of a 16 x 16 block stored [m][k] (row-major) at p.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, p + (lane & 15) * ld + (lane >> 4) * 8);
}

// The A fragment of the transpose of a 16 x 16 block stored [k][m].
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4],
                                             const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(a, p + ((lane & 7) + (lane >> 4) * 8) * ld +
                       ((lane >> 3) & 1) * 8);
}

// The B fragments of two n8 tiles (b[0..1]: n 0-7, b[2..3]: n 8-15) of a
// 16 (k) x 16 (n) block stored [n][k], as K is for q . k^T.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, p + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
}

// The same from a block stored [k][n], as V is for W . V.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                       (lane >> 4) * 8);
}

// c += a . b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16-key tile from its two C fragments (s[0..3] keys
// 0-7, s[4..7] keys 8-15), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* s) {
  a[0] = pack_bf16(s[0], s[1]);
  a[1] = pack_bf16(s[2], s[3]);
  a[2] = pack_bf16(s[4], s[5]);
  a[3] = pack_bf16(s[6], s[7]);
}

// Row (within the tile) and key (within the 16-key tile) of the value a
// lane holds at index e of a key tile's two C fragments.
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + ((e >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int e) {
  return (e >> 2) * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// s[kt] = a_rows (16 x hdp) . b_rows[kt * kt_rows ..]^T (16 x hdp each)
// for kt < nkt, float32: q . k^T when a_rows is a query tile and b_rows
// the keys, dout . v^T when they are dout and V. Tiles kt >= nkt are zero.
template <int CH>
__device__ __forceinline__ void tile_products(float (&s)[CH][8],
                                              const __nv_bfloat16* a_rows,
                                              const __nv_bfloat16* b_rows,
                                              int kt_rows, int ld, int hdp,
                                              int nkt) {
#pragma unroll
  for (int kt = 0; kt < CH; ++kt) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[kt][e] = 0.f;
  }
  for (int kk = 0; kk < hdp; kk += 16) {
    uint32_t a[4];
    load_a(a, a_rows + kk, ld);
#pragma unroll
    for (int kt = 0; kt < CH; ++kt) {
      if (kt < nkt) {
        uint32_t b[4];
        load_b_nk(b, b_rows + kt * kt_rows * ld + kk, ld);
        mma_bf16(&s[kt][0], a, b[0], b[1]);
        mma_bf16(&s[kt][4], a, b[2], b[3]);
      }
    }
  }
}

// The logits of query rows row0.. against a chunk's key tiles, tile kt at
// keys key0 + kt * kt_keys ..: float(bf16(q . k)) / scale_div (the
// reference's bf16 einsum, then its float32 divide) where key <= row and
// key < T, -inf elsewhere (exp gives 0 there, as the reference's -1e30
// does; every row keeps its first key, so its max is finite). Only a tile
// that reaches past the tile's first row or past T is masked key by key.
template <int CH>
__device__ __forceinline__ void chunk_logits(float (&s)[CH][8],
                                             const __nv_bfloat16* q_tile,
                                             const __nv_bfloat16* sK, int ld,
                                             int hdp, int row0, int key0,
                                             int kt_keys, int nkt, int T,
                                             float scale_div) {
  tile_products(s, q_tile, sK + key0 * ld, kt_keys, ld, hdp, nkt);
#pragma unroll
  for (int kt = 0; kt < CH; ++kt) {
    const int first = key0 + kt * kt_keys;  // the tile's first key
    if (kt < nkt && first + kTile - 1 <= row0 && first + kTile <= T) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[kt][e] = round_bf16(s[kt][e]) / scale_div;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = first + frag_col(e);
        s[kt][e] = (kt < nkt && key <= row0 + frag_row(e) && key < T)
                       ? round_bf16(s[kt][e]) / scale_div
                       : neg_inf();
      }
    }
  }
}

// s = exp(s - max of its row).
template <int CH>
__device__ __forceinline__ void chunk_exp(float (&s)[CH][8], float m0,
                                          float m1) {
#pragma unroll
  for (int kt = 0; kt < CH; ++kt) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[kt][e] = expf(s[kt][e] - (((e >> 1) & 1) ? m1 : m0));
    }
  }
}

// Each row's max (m0: row g, m1: row g + 8) and sum of a lane's values.
template <int CH>
__device__ __forceinline__ void row_max(const float (&s)[CH][8], float& m0,
                                        float& m1) {
#pragma unroll
  for (int kt = 0; kt < CH; ++kt) {
    m0 = fmaxf(m0, fmaxf(fmaxf(s[kt][0], s[kt][1]), fmaxf(s[kt][4], s[kt][5])));
    m1 = fmaxf(m1, fmaxf(fmaxf(s[kt][2], s[kt][3]), fmaxf(s[kt][6], s[kt][7])));
  }
}

template <int CH>
__device__ __forceinline__ void row_sum(const float (&s)[CH][8], float& l0,
                                        float& l1) {
#pragma unroll
  for (int kt = 0; kt < CH; ++kt) {
    l0 += (s[kt][0] + s[kt][1]) + (s[kt][4] + s[kt][5]);
    l1 += (s[kt][2] + s[kt][3]) + (s[kt][6] + s[kt][7]);
  }
}

// Launch geometry for T rows of head width HD (false when the shape is
// refused: HD odd). kernels/forecaster.py's attention_geometry computes
// the same from the same rules; the launchers refuse a mismatch.
struct Geometry {
  int hdp;          // HD rounded up to 16 (zero columns)
  int ld;           // shared-memory row stride, bf16
  int tiles;        // 16-row tiles covering T (the rows past T masked)
  int bytes;        // cp.async width: the largest of 16, 8, 4 dividing 2 HD
  size_t fwd_smem;  // the forward's row statistics, output tile, q tile,
                    // k and v rows
  size_t bwd_smem;  // the backward's q, k, v, dout rows, W and dlog tiles
                    // and the dlog rows of its query tile
};

constexpr size_t kSmemLimit = 227 * 1024;

inline bool geometry(int T, int HD, Geometry* g) {
  if (T <= 0 || HD <= 0 || HD % 2 != 0) return false;
  g->hdp = (HD + kTile - 1) / kTile * kTile;
  g->ld = g->hdp == kTile ? kTile : g->hdp + 8;
  g->tiles = (T + kTile - 1) / kTile;
  g->bytes = (2 * HD) % 16 == 0 ? 16 : (2 * HD) % 8 == 0 ? 8 : 4;
  const size_t rows = (size_t)g->tiles * kTile;
  g->fwd_smem = sizeof(float) * kTile * (2 * kFwdWarps + kOutLd) +
                sizeof(__nv_bfloat16) * g->ld * (kTile + 2 * rows);
  g->bwd_smem = sizeof(__nv_bfloat16) * (4 * rows * g->ld +
                                         2 * rows * kTileLd +
                                         kTile * (rows + 8));
  return true;
}

// True when the launch parameters a wrapper passed are the geometry's.
inline bool geometry_matches(const Geometry& g, int hdp, int ld, int tiles,
                             int bytes) {
  return hdp == g.hdp && ld == g.ld && tiles == g.tiles && bytes == g.bytes;
}

}  // namespace chana_att
