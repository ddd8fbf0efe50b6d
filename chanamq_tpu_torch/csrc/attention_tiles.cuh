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
// Any window: no kernel holds a whole head. A block keeps its own 16-row
// tiles and streams the other side's tiles (the keys and values of a
// query tile's prefix, or the queries and douts below a key tile) through
// a ring of two slots of `stage` tiles each, filled with cp.async while
// the slot before is in use (for_each_slot). Shared memory is then fixed
// by the head width alone, whatever T is. A slot holds one tile a warp
// (kWarps) while that fits, so a window of 64 (the flagship's) fits one
// slot: such a block stages its tiles once, as a block that held the
// whole prefix did. Heads too wide for that take slots of two tiles, or
// one (Geometry::stage), and leave warps idle. A window of one tile
// streams nothing: heads too wide even for slots of one tile run there
// with a ring of one slot (Geometry::slots), which the backward lays over
// its own tiles.
//
// A warp holds the logits of one 16 x 16 tile in registers. The softmax
// needs a row's max before its exponentials and their sum before its
// weights, so a streamed row is taken in passes, each recomputing its
// tiles' logits from shared memory; a recomputed tile gives the same bits.
// Warp w takes key tiles w, w + 4, ... of a row in order (slot_tile), in
// every pass and whatever the ring's size, so the sums run in the same
// order as when the prefix was held whole.
//
// Which shapes each design serves. These 16-row tiles on mma.sync serve
// the forward and the backward up to windows of 127 rows (the service's
// default window 64, run_node's compact model at its window) and at head
// widths that are not multiples of 16 or are over 128: at T = 64 a call
// is bound by launch latency and parallelism (more than 20x from either
// roof), and a 64-row warpgroup tile would leave most of the card idle.
// From 128 rows the 16-row kernels re-read a tile's whole prefix for
// every 16 rows; there the forward is forecaster.cu's
// causal_attention_warpgroup_kernel (64 query rows a block, wgmma, a TMA
// key ring, two passes), which writes the same row statistics, and the
// backward forecaster_train.cu's warpgroup pair (64 rows a block, dq by
// query rows, dk and dv by key rows).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace chana_att {

constexpr int kTile = 16;      // rows of a query tile, keys of a key tile
constexpr int kWarps = 4;      // warps a block
constexpr int kColChunk = 64;  // output columns summed at once
constexpr int kTileLd = kTile + 8;  // stride of a [rows][16] bf16 buffer
constexpr int kOutLd = kColChunk + 8;  // stride of a float [16][64] buffer

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

// A float32 divisor. x / d is correctly rounded either way; when d is a
// power of two (sqrt(head_dim) at head widths 16, 64 and 256) it is the
// multiply by 1/d, exactly, and a zero dividend is returned as it is (its
// quotient), so the causal mask's zeros never take the division's slow
// path.
struct Divisor {
  float d, inv;  // inv: 1 / d when that is exact, else 0
};

__device__ __forceinline__ Divisor divisor(float d) {
  return {d, (__float_as_uint(d) & 0x007fffffu) == 0u ? 1.0f / d : 0.0f};
}

__device__ __forceinline__ float divide(float x, const Divisor& q) {
  if (q.inv != 0.0f) return x * q.inv;
  return x == 0.0f ? x : x / q.d;
}

__device__ __forceinline__ float divide(float x, float d) {
  return x == 0.0f ? x : x / d;
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One head's slice of a [B, T, *] bf16 tensor as the kernels stage it: hd
// values a row at src + row * stride, zero-padded to hdp columns and to
// whole tiles, rows ld apart in shared memory, copied `bytes` at a time
// (16, 8 or 4, a divisor of 2 * hd).
struct Head {
  size_t stride;
  int T, hd, hdp, ld, bytes;
};

// Rows [r0, r0 + n) of a head's slice at src into dst[n][ld]: copies for
// rows < T and columns < hd, zeros up to column hdp and in rows >= T.
// Every thread of the block takes part; the caller commits, waits and
// synchronizes.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           const Head& h, int r0, int n) {
  const int per_row = h.hdp * 2 / h.bytes;
  const int step = h.bytes / 2;
  // (row, chunk) of this thread's copy, advanced without a divide a copy
  int r = threadIdx.x / per_row, k = threadIdx.x - r * per_row;
  const int dr = blockDim.x / per_row, dk = blockDim.x - dr * per_row;
  for (int idx = threadIdx.x; idx < n * per_row; idx += blockDim.x) {
    const int col = k * step;
    __nv_bfloat16* d = dst + r * h.ld + col;
    if (r0 + r < h.T && col < h.hd) {
      cp_async(d, src + (size_t)(r0 + r) * h.stride + col, h.bytes);
    } else if (h.bytes == 16) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (h.bytes == 8) {
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

// Tiles [tile0, tile0 + ntiles) of one head slice (src_a, laid out as ha)
// and, unless src_b is null, of a second one at the same rows (src_b, as
// hb; the same shared-memory layout), through the two slots
// of ring_a and ring_b (each slot `stage` tiles of ld columns): fn(slot_a,
// slot_b, first tile, tiles in the slot) for each slot's worth in order,
// called by every thread of the block between two barriers. The next
// slot's copies are in flight while fn runs. With `staged` the tiles (at
// most `stage`) are in slot 0 already, waited for and visible, and fn runs
// once with no copy.
template <class Fn>
__device__ __forceinline__ void for_each_slot(
    __nv_bfloat16* ring_a, __nv_bfloat16* ring_b,
    const __nv_bfloat16* src_a, const __nv_bfloat16* src_b, const Head& ha,
    const Head& hb, int stage, int tile0, int ntiles, bool staged,
    Fn&& fn) {
  if (staged) {
    fn(ring_a, ring_b, tile0, ntiles);
    __syncthreads();
    return;
  }
  const int slot = stage * kTile * ha.ld;
  const int nslots = (ntiles + stage - 1) / stage;
  auto issue = [&](int s) {
    const int n = min(stage, ntiles - s * stage) * kTile;
    const int r0 = (tile0 + s * stage) * kTile;
    stage_rows(ring_a + (s & 1) * slot, src_a, ha, r0, n);
    if (src_b != nullptr) {
      stage_rows(ring_b + (s & 1) * slot, src_b, hb, r0, n);
    }
    cp_async_commit();
  };
  issue(0);
  for (int s = 0; s < nslots; ++s) {
    if (s + 1 < nslots) {
      issue(s + 1);  // into the slot the last fn is done with
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    fn(ring_a + (s & 1) * slot, ring_b + (s & 1) * slot,
       tile0 + s * stage, min(stage, ntiles - s * stage));
    __syncthreads();
  }
}

// The place in a slot of the key tile warp `warp` takes (tiles j with
// j % kWarps == warp), in a slot whose first tile is j0 and which holds n
// tiles; -1 when the slot has none of its tiles. A slot's first tile is a
// multiple of its size (1, 2 or kWarps), so a slot of kWarps tiles gives
// every warp its own place.
__device__ __forceinline__ int slot_tile(int warp, int j0, int n) {
  const int i = (warp - j0) & (kWarps - 1);
  return i < n ? i : -1;
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

// s = a_rows (16 x hdp) . b_rows^T (16 x hdp), float32, as two n8 C
// fragments (s[0..3] columns 0-7, s[4..7] columns 8-15): q . k^T when
// a_rows is a query tile and b_rows a key tile, dout . v^T for dout and V.
__device__ __forceinline__ void tile_product(float (&s)[8],
                                             const __nv_bfloat16* a_rows,
                                             const __nv_bfloat16* b_rows,
                                             int ld, int hdp) {
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = 0.f;
  for (int kk = 0; kk < hdp; kk += 16) {
    uint32_t a[4], b[4];
    load_a(a, a_rows + kk, ld);
    load_b_nk(b, b_rows + kk, ld);
    mma_bf16(&s[0], a, b[0], b[1]);
    mma_bf16(&s[4], a, b[2], b[3]);
  }
}

// The logits of query rows row0.. against keys key0..: float(bf16(q . k))
// / scale_div (the reference's bf16 einsum, then its float32 divide) where
// key <= row and key < T, -inf elsewhere (exp gives 0 there, as the
// reference's -1e30 does; every row keeps its first key, so its max is
// finite). Only a tile that reaches past its first row or past T is
// masked key by key.
__device__ __forceinline__ void tile_logits(float (&s)[8],
                                            const __nv_bfloat16* q_rows,
                                            const __nv_bfloat16* k_rows,
                                            int ld, int hdp, int row0,
                                            int key0, int T,
                                            const Divisor& scale) {
  tile_product(s, q_rows, k_rows, ld, hdp);
  if (key0 + kTile - 1 <= row0 && key0 + kTile <= T) {
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = divide(round_bf16(s[e]), scale);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int key = key0 + frag_col(e);
      s[e] = (key <= row0 + frag_row(e) && key < T)
                 ? divide(round_bf16(s[e]), scale)
                 : neg_inf();
    }
  }
}

// s = exp(s - max of its row).
__device__ __forceinline__ void tile_exp(float (&s)[8], float m0, float m1) {
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = expf(s[e] - (((e >> 1) & 1) ? m1 : m0));
}

// Each row's max (m0: row g, m1: row g + 8) and sum of a lane's values.
__device__ __forceinline__ void tile_max(const float (&s)[8], float& m0,
                                         float& m1) {
  m0 = fmaxf(m0, fmaxf(fmaxf(s[0], s[1]), fmaxf(s[4], s[5])));
  m1 = fmaxf(m1, fmaxf(fmaxf(s[2], s[3]), fmaxf(s[6], s[7])));
}

__device__ __forceinline__ void tile_sum(const float (&s)[8], float& l0,
                                         float& l1) {
  l0 += (s[0] + s[1]) + (s[4] + s[5]);
  l1 += (s[2] + s[3]) + (s[6] + s[7]);
}

// A value of each of a tile's 16 rows, one a warp, combined over the
// block's warps in warp order through part[kWarps][16] (lanes of quad
// lane 0 write). Every thread returns the combined values of its rows g
// and g + 8; the barrier inside makes part reusable after the next one.
template <class Op>
__device__ __forceinline__ void combine_rows(float* part, float& v0,
                                             float& v1, Op op) {
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  if ((threadIdx.x & 3) == 0) {
    part[warp * kTile + g] = v0;
    part[warp * kTile + g + 8] = v1;
  }
  __syncthreads();
  v0 = part[g];
  v1 = part[g + 8];
  for (int w = 1; w < kWarps; ++w) {
    v0 = op(v0, part[w * kTile + g]);
    v1 = op(v1, part[w * kTile + g + 8]);
  }
}

// Launch geometry for T rows of head width HD (false when the shape is
// refused: HD odd, or too wide for a slot of one tile). kernels/
// forecaster.py's attention_geometry computes the same from the same
// rules; the launchers refuse a mismatch. Shared memory depends on the
// head width alone.
struct Geometry {
  int hdp;            // HD rounded up to 16 (zero columns)
  int ld;             // shared-memory row stride, bf16
  int tiles;          // 16-row tiles covering T (the rows past T masked)
  int bytes;          // cp.async width: the largest of 16, 8, 4 dividing 2 HD
  int stage;          // tiles a ring slot holds: kWarps, 2 or 1, the most
                      // whose shared memory fits
  int slots;          // slots a ring has: 2, or 1 in a window of one tile
                      // whose head is too wide for two
  size_t fwd_smem;    // the forward's row statistics of each warp, output
                      // tile, q tile and the k and v rings
  size_t stats_smem;  // the backward's row pass: a statistic of each
                      // warp, q and dout tiles, the k and v rings
  size_t bwd_smem;    // the backward's own four tiles, two rings and
                      // the dlog and W tiles of a slot for each half
};

constexpr size_t kSmemLimit = 227 * 1024;

inline bool geometry(int T, int HD, Geometry* g) {
  if (T <= 0 || HD <= 0 || HD % 2 != 0) return false;
  g->hdp = (HD + kTile - 1) / kTile * kTile;
  g->ld = g->hdp == kTile ? kTile : g->hdp + 8;
  g->tiles = (T + kTile - 1) / kTile;
  g->bytes = (2 * HD) % 16 == 0 ? 16 : (2 * HD) % 8 == 0 ? 8 : 4;
  for (int stage = kWarps; stage >= 1; stage /= 2) {
    // the one-slot ring only where it is needed: one tile, slots of one
    for (int slots = 2; slots >= (stage == 1 && g->tiles == 1 ? 1 : 2);
         --slots) {
      const size_t ring = (size_t)slots * stage * kTile * g->ld;
      g->stage = stage;
      g->slots = slots;
      g->fwd_smem = sizeof(float) * kTile * (2 * kWarps + kOutLd) +
                    sizeof(__nv_bfloat16) * (kTile * g->ld + 2 * ring);
      g->stats_smem = sizeof(float) * kTile * kWarps +
                      sizeof(__nv_bfloat16) * (2 * kTile * g->ld + 2 * ring);
      // one slot: the backward's rings are its own four tiles
      g->bwd_smem = sizeof(__nv_bfloat16) *
                    (4 * kTile * g->ld + (slots == 2 ? 2 * ring : 0) +
                     3 * stage * kTile * kTileLd);
      if (g->fwd_smem <= kSmemLimit && g->stats_smem <= kSmemLimit &&
          g->bwd_smem <= kSmemLimit) {
        return true;
      }
    }
  }
  return false;
}

// Opts `kernel` into `smem` bytes of dynamic shared memory (past the
// 48 KB a block has without it) on the current device, once: `allowed`
// keeps, for each device, the most it was opted into there, so launches at
// a width already seen make no attribute call.
constexpr int kMaxDevices = 64;

inline cudaError_t allow_smem(const void* kernel, size_t smem,
                              size_t (&allowed)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && kept) allowed[dev] = smem;
  return err;
}

// True when the launch parameters a wrapper passed are the geometry's.
inline bool geometry_matches(const Geometry& g, int hdp, int ld, int tiles,
                             int bytes, int stage, int slots) {
  return hdp == g.hdp && ld == g.ld && tiles == g.tiles &&
         bytes == g.bytes && stage == g.stage && slots == g.slots;
}

}  // namespace chana_att
