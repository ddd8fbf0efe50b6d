// Forecaster kernels for Hopper (sm_90a): layernorm, causal attention and
// tanh-GELU, the three non-product steps of the telemetry forecaster's
// forward pass. The products around them (embed, qkv, proj, w1, w2, head)
// are products.cu's; the forward path takes GELU in the w1 product's
// epilogue, and this standalone kernel stays for the op set's gelu_tanh.
//
// What they replace. chanamq_tpu/models/forecaster.py::forward, the
// XLA-jitted program the forecast service runs for every forecast:
// _layernorm (forecaster.py:77), the attention core of _attention between
// its two projections (forecaster.py:88-99), and jax.nn.gelu's tanh form
// (forecaster.py:116). Each computes what the reference computes, at the
// reference's rounding points: bf16 in and out, float32 inside.
//
// What bounds them on this card. All three move far more bytes than they
// do operations: a layernorm row of 256 bf16 values costs ~7 float32
// operations a value, GELU ~12, and attention at T = 64, head_dim = 64 does
// about 2 * 64 multiply-adds a loaded bf16 value over the causal half, far
// under the ~295 operations a byte at which the tensor cores become the
// limit. So the roof is device memory: each input read once, each output
// written once. At the service's batch of 1 the whole forward is a few
// hundred kilobytes and the launch latency, not either roof, sets the time.
//
// What the design does about it. Nothing is staged through device memory
// that the reference does not also produce: layernorm keeps a row in
// registers between its two passes (one row a warp, 8 values a lane from
// each 16-byte load, every load issued before the first sum; see
// layernorm_rows.cuh); attention reads q, k and v straight out of the fused
// qkv product and writes the [B, T, D] layout the proj product takes, so
// the reference's splits, reshapes and transposes become indexing; GELU is
// one pass of 16-byte loads and stores. Nothing is fused across kernels.
//
// Attention has two designs, one launch a call either way, chosen by the
// wrapper from the shape. Up to windows of 127 rows, and at head widths the
// second does not take, the tensor-core design of attention_tiles.cuh: both
// of its products (q . k^T and W . V) on mma.sync, its softmax on the
// accumulator fragments in registers, one block of four warps per (batch,
// head, 16-row query tile), so that the service's batch of 1 runs on 16
// blocks at T = 64; key and value tiles stream through a ring in shared
// memory, so any window fits. From 128 rows at head widths that are
// multiples of 16 up to 128, causal_attention_warpgroup_kernel: 64 query
// rows a block on wgmma, 64-key tiles on a TMA ring, two passes over the
// keys (its note is below).

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attention_tiles.cuh"
#include "attention_warpgroup.cuh"
#include "gelu.cuh"
#include "layernorm_rows.cuh"
#include "tma_wgmma.cuh"

#define CHANA_GELU_THREADS 256

namespace {

__device__ __forceinline__ float2 pair_to_float2(uint32_t w) {
  __nv_bfloat162 p;
  *reinterpret_cast<uint32_t*>(&p) = w;
  return __bfloat1622float2(p);
}

__device__ __forceinline__ uint32_t float2_to_pair(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

// -- layernorm --------------------------------------------------------------
//
// out[r, :] = bf16((x - mean) * rsqrt(var + eps) * scale), float32
// statistics over the row: the mean, then the mean of squared deviations
// from it (two passes over the values held in registers, as the reference
// computes them; not E[x^2] - mean^2). Scale only, no bias. The geometry of
// layernorm_rows.cuh: one row a warp, lane l the 8 values at columns
// 8 * (32 * c + l); every load (the row and the scale) is issued before the
// first sum.

template <int CHUNKS>
__global__ void __launch_bounds__(chana_ln::kThreads) layernorm_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * chana_ln::kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps leave together
  float sc[CHUNKS][8];
  uint4 raw[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    raw[c] = make_uint4(0u, 0u, 0u, 0u);
    if (col < D) {
      chana_ln::load_scale8(scale, col, sc[c]);
      raw[c] = *reinterpret_cast<const uint4*>(x + (size_t)row * D + col);
    }
  }
  float v[CHUNKS][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    chana_ln::unpack8(raw[c], v[c]);
    if ((c * 32 + lane) * 8 < D) {
#pragma unroll
      for (int k = 0; k < 4; ++k) sum += v[c][2 * k] + v[c][2 * k + 1];
    }
  }
  const float mu = chana_ln::warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if ((c * 32 + lane) * 8 < D) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[c][k] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(chana_ln::warp_sum(sq) / (float)D + eps);
  __nv_bfloat16* orow = out + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < D) {
      float o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[c][k] - mu) * rstd * sc[c][k];
      *reinterpret_cast<uint4*>(orow + col) = chana_ln::pack8(o);
    }
  }
}

using LayerNormFn = void (*)(const __nv_bfloat16*, const float*,
                             __nv_bfloat16*, int, int, float);

// The instance for a geometry's chunks (1-4).
LayerNormFn layernorm_fn(int chunks) {
  switch (chunks) {
    case 1: return layernorm_kernel<1>;
    case 2: return layernorm_kernel<2>;
    case 3: return layernorm_kernel<3>;
    case 4: return layernorm_kernel<4>;
    default: return nullptr;
  }
}

// An empty kernel: what a launch costs the card with no work in it, the
// floor under the time of every kernel here.
__global__ void empty_kernel() {}

// -- causal attention -------------------------------------------------------
//
// qkv [B, T, 3D] (q | k | v, head h at columns h * HD of each third) ->
// out [B, T, D], head h at columns h * HD. One block of kWarps (4) warps
// per (b, h, 16-row query tile), the longest rows first. The block stages
// its query tile and streams the key tiles the tile sees (keys < 16 (tile
// + 1)) of k, and in the last pass of v, through the ring of
// attention_tiles.cuh, `stage` tiles a slot: warp w takes key tiles w,
// w + 4, ... and, on the tensor cores, forms
//   logit = float(bf16(q_i . k_j)) / sqrt(HD)       (the einsum's bf16 out)
// for j <= i in registers. The float32 two-pass softmax runs on those
// accumulator fragments in three passes over the keys: each warp's row max
// over its lane quads, then over the warps in warp order; the exponentials'
// row sums the same way (keys past the query get exp(-inf) = 0, as the
// reference's -1e30 does, which is exact); then W = bf16(e / sum),
// repacked in registers as the A fragment of W . V. Each warp's float32
// partial of sum_j W_ij v_j is added into one shared buffer in warp order,
// and out = bf16 of the total, 64 columns at a time. A prefix of at most
// a slot (every tile at T <= 64 at head widths up to 336) is staged once
// and its logits held through the passes; a longer one is streamed again
// in every pass (and for every 64 output columns), its logits recomputed.
// Given `stats` (training), the block also writes each row's max and sum
// of exponentials, float32, into its first two planes ([3][B H rows]):
// the backward reads them instead of recomputing them.

__global__ void __launch_bounds__(chana_att::kWarps * 32, 4)
    causal_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ stats, int T, int H, int HD,
                            int HDP, int ld, int tiles, int bytes, int stage,
                            int slots, float scale_div) {
  using namespace chana_att;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_max = reinterpret_cast<float*>(smem_raw);  // [kWarps][16]
  float* s_sum = s_max + kWarps * kTile;              // [kWarps][16]
  float* s_o = s_sum + kWarps * kTile;                // [16][kOutLd]
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(s_o + kTile * kOutLd);
  const int slot = stage * kTile * ld;
  __nv_bfloat16* ring_k = s_q + kTile * ld;  // [slots][stage * 16][ld]
  __nv_bfloat16* ring_v = ring_k + slots * slot;
  const int bh = blockIdx.x / tiles;
  const int tile = tiles - 1 - (blockIdx.x - bh * tiles);
  const int h = bh % H;
  const int b = bh / H;
  const int D = H * HD;
  const Head head{(size_t)3 * D, T, HD, HDP, ld, bytes};
  const __nv_bfloat16* src = qkv + (size_t)b * T * head.stride + h * HD;
  const int row0 = tile * kTile;
  const int nkt = tile + 1;  // key tiles the query tile sees
  const bool staged = nkt <= stage;  // the whole prefix in one slot
  const Divisor scale = divisor(scale_div);
  stage_rows(s_q, src, head, row0, kTile);
  if (staged) {
    stage_rows(ring_k, src + D, head, 0, nkt * kTile);
    stage_rows(ring_v, src + 2 * D, head, 0, nkt * kTile);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int c = threadIdx.x & 3;
  float s[8];  // this warp's key tile of a slot: logits, then e
  auto logits = [&](const __nv_bfloat16* k_slot, int j0, int i) {
    tile_logits(s, s_q, k_slot + i * kTile * ld, ld, HDP, row0,
                (j0 + i) * kTile, T, scale);
  };
  float m0 = neg_inf(), m1 = neg_inf();  // rows g and g + 8
  for_each_slot(ring_k, ring_v, src + D, nullptr, head, head, stage, 0,
                nkt, staged,
                [&](const __nv_bfloat16* k_slot, const __nv_bfloat16*,
                    int j0, int n) {
                  const int i = slot_tile(warp, j0, n);
                  if (i >= 0) {
                    logits(k_slot, j0, i);
                    tile_max(s, m0, m1);
                  }
                });
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  combine_rows(s_max, m0, m1, [](float x, float y) { return fmaxf(x, y); });
  float l0 = 0.f, l1 = 0.f;
  for_each_slot(ring_k, ring_v, src + D, nullptr, head, head, stage, 0,
                nkt, staged,
                [&](const __nv_bfloat16* k_slot, const __nv_bfloat16*,
                    int j0, int n) {
                  const int i = slot_tile(warp, j0, n);
                  if (i >= 0) {
                    if (!staged) logits(k_slot, j0, i);
                    tile_exp(s, m0, m1);
                    tile_sum(s, l0, l1);
                  }
                });
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  combine_rows(s_sum, l0, l1, [](float x, float y) { return x + y; });
  if (stats != nullptr && threadIdx.x < 32 && c == 0) {
    const size_t plane = (size_t)gridDim.x * kTile;  // B H rows
    float* row = stats + (size_t)bh * tiles * kTile + row0;
    row[g] = m0;
    row[g + 8] = m1;
    row[plane + g] = l0;
    row[plane + g + 8] = l1;
  }

  const int active = min(kWarps, nkt);  // warps with keys
  __nv_bfloat16* dst = out + (size_t)b * T * D + h * HD;
  for (int col0 = 0; col0 < HDP; col0 += kColChunk) {
    float o[kColChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kColChunk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    }
    for_each_slot(
        ring_k, ring_v, src + D, src + 2 * D, head, head, stage, 0, nkt,
        staged,
        [&](const __nv_bfloat16* k_slot, const __nv_bfloat16* v_slot,
            int j0, int n) {
          const int i = slot_tile(warp, j0, n);
          if (i < 0) return;
          if (!staged) {
            logits(k_slot, j0, i);
            tile_exp(s, m0, m1);
          }
          float w[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            w[e] = divide(s[e], ((e >> 1) & 1) ? l1 : l0);
          }
          uint32_t a[4];
          pack_a(a, w);
          const __nv_bfloat16* v_tile = v_slot + i * kTile * ld + col0;
#pragma unroll
          for (int p = 0; p < kColChunk / 16; ++p) {
            if (col0 + p * 16 < HDP) {
              uint32_t bv[4];
              load_b_kn(bv, v_tile + p * 16, ld);
              mma_bf16(o[2 * p], a, bv[0], bv[1]);
              mma_bf16(o[2 * p + 1], a, bv[2], bv[3]);
            }
          }
        });
    // the warps' partials, added in warp order
    for (int w = 0; w < active; ++w) {
      if (warp == w) {
#pragma unroll
        for (int n = 0; n < kColChunk / 8; ++n) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* p = reinterpret_cast<float2*>(
                s_o + (g + 8 * half) * kOutLd + n * 8 + 2 * c);
            float2 v = make_float2(o[n][2 * half], o[n][2 * half + 1]);
            if (w > 0) {
              v.x += p->x;
              v.y += p->y;
            }
            *p = v;
          }
        }
      }
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < kTile * kColChunk / 2;
         idx += kWarps * 32) {
      const int row = idx / (kColChunk / 2);
      const int col = 2 * (idx - row * (kColChunk / 2));
      if (row0 + row < T && col0 + col < HD) {
        const float2 v =
            *reinterpret_cast<const float2*>(s_o + row * kOutLd + col);
        *reinterpret_cast<uint32_t*>(dst + (size_t)(row0 + row) * D + col0 +
                                     col) = pack_bf16(v.x, v.y);
      }
    }
    __syncthreads();  // s_o is rewritten for the next 64 columns
  }
}

// -- causal attention for long windows: a warpgroup on a TMA key ring -------
//
// The same function as causal_attention_kernel, for windows of 128 rows and
// more at head widths that are multiples of 16 up to 128 (the wrapper's
// attention_warpgroup_geometry; every other shape takes the kernel above),
// and for latent attention's heads: q and k 192 wide (three boxes), v read
// to its first 128 columns (two boxes a ring stage, two output atoms; the
// operand's v heads are 192 wide, zeros past 128), out [B, T, H 128].
//
// What bounds it. Two bf16 products over the causal pairs, 4 HD operations
// a pair (the flagship's training call, B = 16, T = 2,048, 4 heads of 64:
// 3.4e10, 35 us at 989 TFLOP/s), and the softmax: each pair's exponential
// twice, once a pass, on the special function units (16 a clock an SM:
// ~75 us at that shape), pass 2's division, and some ten more float32
// instructions a pair. The second pass computes Q K^T again and 64 x 64
// tiles take the diagonal whole, so the tensor cores do ~5.5e10 operations
// (~55 us). The 16-row kernel above spends ~1.3 ms there: each 16-row
// query tile streams its whole key prefix three times through a two-slot
// cp.async ring (~4.3 GB of L2 reads a call), a block barrier every 2 KB
// tile. Here a key or value tile serves 64 query rows and the prefix is
// read twice (~0.83 GB), so the tensor cores' and the softmax's work bound
// it; they overlap within a warpgroup, and three blocks an SM overlap one
// block's softmax with another's products.
//
// The design:
// - A block takes 64 query rows of one (b, h) on one consumer warpgroup
//   (wgmma's m64), plus one producer warp. Blocks go longest rows first.
//   Up to head width 64 an SM holds three blocks.
// - One 4-d tensor map views qkv [B, T, 3D] as [B][T][3H][HD] and gives
//   every operand as a box of 64 rows of one head, 64 columns (128 bytes,
//   128-byte swizzle; two boxes at widths over 64). Rows past T and
//   columns past HD arrive as zeros, never from the next batch or head,
//   so q . k runs over whole boxes and W . V's extra columns are zeros.
// - The producer warp loads the block's q rows once, then streams 64-key
//   tiles through a ring of kStages stages (full and empty mbarriers): the
//   key tiles of the block's prefix for pass 1, then key and value tiles
//   again for pass 2.
// - Pass 1: S = Q K^T on wgmma m64n64k16 (both from shared memory);
//   logit = float(bf16(S)) / sqrt(HD), -inf past the row or past T, as the
//   16-row kernel forms it; each row's max and sum of exponentials in one
//   online pass, a running max that rescales the running sum.
// - Pass 2: S again (the same bits), W = bf16(expf(logit - m) / l), the
//   reference's rounding of the weights and, from the statistics written
//   out, the backward's W bit for bit; the division by each row's
//   reciprocal and two correction steps (quotient_rn) where the row's
//   logits span under kQuotientSpan (pass 1 finds each row's least), the
//   division itself elsewhere. W is packed in registers as the A operand
//   of O += W . V on wgmma (V from shared memory, N-major).
// - The tensor cores' work overlaps the softmax's: in pass 1 the second of
//   two key tiles' S runs while the first is worked on, in pass 2 a tile's
//   W is worked out while the last tile's W . V runs. No wgmma is in
//   flight across a loop's back edge, and no accumulator is read before
//   the wait that retires it; otherwise the compiler serializes every
//   wgmma.
// - out = bf16(O); with `stats`, each row's max and sum go to the first two
//   planes at the rows the 16-row kernel writes (rows < stat_rows of each
//   (b, h)), for the backward, which takes either forward's statistics.

namespace wg_fwd {

using namespace ::wg_att;  // attention_warpgroup.cuh: the shared pieces

// Heads of up to 64 kAtoms (q and k), values of up to 64 kVAtoms.
template <int kAtoms, int kVAtoms = kAtoms>
struct Shape {
  static constexpr int kThreads = 128 + 32;  // consumers, the producer
  // blocks an SM holds: three up to width 64 (136 registers a thread,
  // 3 x 74,752 bytes of shared memory), one above (its output's registers
  // and stages of twice the bytes)
  static constexpr int kBlocksPerSM = kAtoms == 1 ? 3 : 1;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;    // a k tile
  static constexpr int kVTileBytes = kVAtoms * kAtomBytes;  // a v tile
  static constexpr int kStageBytes = kTileBytes + kVTileBytes;
  // ring stages (a pass-2 stage is released a stage late, once its W . V
  // is done)
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kAtoms * kAtomBytes;
  // + 1024 bytes to align the boxes for the swizzle
  static constexpr int kSmem = kQBytes + kStages * kStageBytes + 1024;
};

}  // namespace wg_fwd

template <int kAtoms, int kVAtoms>
__global__ void __launch_bounds__(wg_fwd::Shape<kAtoms, kVAtoms>::kThreads,
                                  wg_fwd::Shape<kAtoms, kVAtoms>::kBlocksPerSM)
    causal_attention_warpgroup_kernel(const __grid_constant__ CUtensorMap map,
                                      __nv_bfloat16* __restrict__ out,
                                      float* __restrict__ stats, int T, int H,
                                      int HD, int HDV, int BH, int stat_rows,
                                      float scale_div) {
  using namespace chana_tma;
  using namespace wg_att;
  using S = wg_fwd::Shape<kAtoms, kVAtoms>;
  using chana_att::neg_inf;
  using chana_att::pack_bf16;
  using chana_att::unpack_bf16;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full[S::kStages];
  __shared__ __align__(8) uint64_t empty[S::kStages];
  __shared__ __align__(8) uint64_t q_full;
  uint8_t* const q_smem =
      wg_smem + ((1024u - (smem_u32(wg_smem) & 1023u)) & 1023u);
  uint8_t* const ring = q_smem + S::kQBytes;

  const int qb = (int)gridDim.x / BH - 1 - (int)blockIdx.x / BH;
  const int bh = (int)blockIdx.x % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int D = H * HDV;  // the output's row
  const int r0 = qb * kRows;
  // key tiles the block's rows see, rounded up to even (a tile past them
  // is masked whole) so that each pass is whole pairs of stages
  int n = (min(r0 + kRows, T) + kKeys - 1) / kKeys;
  n += n & 1;
  const int warp = (int)threadIdx.x >> 5;
  const int lane = (int)threadIdx.x & 31;

  if (threadIdx.x == 128) {
    tma_prefetch(&map);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    mbar_init(&q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(&q_full, S::kQBytes);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(q_smem + a * kAtomBytes, &map, &q_full, 64 * a, h, r0,
                    b);
      }
      // stage i: key tile i (pass 1), then key and value tile i - n
      for (int i = 0; i < 2 * n; ++i) {
        const int slot = i % S::kStages;
        if (i >= S::kStages) {
          mbar_wait(&empty[slot], ((i / S::kStages) - 1) & 1);
        }
        const bool second = i >= n;
        const int key0 = (second ? i - n : i) * kKeys;
        uint8_t* const st = ring + slot * S::kStageBytes;
        mbar_expect_tx(&full[slot],
                       second ? S::kStageBytes : S::kTileBytes);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_4d(st + a * kAtomBytes, &map, &full[slot], 64 * a, H + h,
                      key0, b);
          if (second && a < kVAtoms) {
            tma_load_4d(st + S::kTileBytes + a * kAtomBytes, &map,
                        &full[slot], 64 * a, 2 * H + h, key0, b);
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroup: lane l of warp w holds rows
  // row_a = r0 + 16 w + l / 4 and row_a + 8
  const int row_a = r0 + 16 * warp + (lane >> 2);
  const int c = lane & 3;
  const uint32_t q_base = smem_u32(q_smem);
  // 1 / sqrt(HD), correctly rounded. Where sqrt(HD) is a power of two the
  // logits are kept as float(bf16(S)) and the exact scale sc rides in the
  // exponent's multiplier and in the max written out; elsewhere each logit
  // is divided (quotient) and sc is 1.
  const float inv_scale = __frcp_rn(scale_div);
  const bool pow2_scale = (__float_as_uint(scale_div) & 0x007fffffu) == 0u;
  const float sc = pow2_scale ? inv_scale : 1.f;
  const float scl = sc * kLog2e;  // exp(sc (x - m)) = 2^(x scl - m scl)
  mbar_wait(&q_full, 0);

  // stage i's S = Q K^T into d (its key tile i, or i - n in pass 2)
  auto issue_qk = [&](float (&d)[32], int i) {
    const int slot = i % S::kStages;
    mbar_wait(&full[slot], (i / S::kStages) & 1);
    const uint32_t k_base = smem_u32(ring + slot * S::kStageBytes);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kAtoms; ++kk) {  // columns past HD are zeros
      const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
      wgmma_m64n64k16<0, 0>(d, sw128_desc(q_base + off),
                            sw128_desc(k_base + off), kk > 0);
    }
    wgmma_commit();
  };
  // S to logits (over sc) in place: float(bf16(S)), divided by sqrt(HD)
  // where that is not a power of two, with the 16-row kernel's bits
  // (quotient, or the division where the tile holds a logit under
  // 2^-100); -inf past the row or past T (only a
  // tile that reaches past its first row or past T is masked key by key).
  // With `low` (pass 1), each row's least logit before the mask goes into
  // lo: a bound on its span that holds the masked keys too.
  float lo[2] = {-neg_inf(), -neg_inf()};
  auto to_logits = [&](float (&x)[32], int key0, bool low) {
#pragma unroll
    for (int e = 0; e < 32; e += 2) {  // one conversion a pair
      const float2 p = unpack_bf16(pack_bf16(x[e], x[e + 1]));
      x[e] = p.x;
      x[e + 1] = p.y;
    }
    if (!pow2_scale) {
      int tiny = 0;  // a logit too small for quotient: the tile divides
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        tiny |= fabsf(x[e]) < 0x1p-100f && x[e] != 0.f;
      }
      if (tiny) {
#pragma unroll
        for (int e = 0; e < 32; ++e) x[e] = chana_att::divide(x[e], scale_div);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          x[e] = quotient(x[e], scale_div, inv_scale);
        }
      }
    }
    if (low) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        lo[(e >> 1) & 1] = fminf(lo[(e >> 1) & 1], x[e]);
      }
    }
    if (key0 + kKeys - 1 > r0 || key0 + kKeys > T) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = key0 + 8 * (e >> 2) + 2 * c + (e & 1);
        if (key > row_a + 8 * ((e >> 1) & 1) || key >= T) x[e] = neg_inf();
      }
    }
  };

  // pass 1: each row's max and sum of exponentials, online (a new max
  // rescales the sum); pass 2: W = bf16(expf(logit - m) / l), O += W . V
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};  // m over sc
  float mt[2], rl[2];  // pass 2: the true max, m sc (exact: sc is 1 or
                      // 2^-k), and 1 / l correctly rounded
  float o[kVAtoms][32];  // zeroed after pass 1, where it starts to live
  // a row's 16 values a thread go to four partial maxima and sums (value
  // e to partial (e / 4) % 4), so that the chains are short
  auto pass1 = [&](float (&x)[32]) {
    float top[2][4], part[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        top[r][q] = m[r];
        part[r][q] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float& t = top[(e >> 1) & 1][(e >> 2) & 3];
      t = fmaxf(t, x[e]);
    }
    float mx[2], nml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = chana_att::quad_max(fmaxf(fmaxf(top[r][0], top[r][1]),
                                        fmaxf(top[r][2], top[r][3])));
      nml[r] = -mx[r] * scl;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      part[(e >> 1) & 1][(e >> 2) & 3] +=
          exp2_approx(fmaf(x[e], scl, nml[(e >> 1) & 1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * exp2_approx((m[r] - mx[r]) * scl) +
             chana_att::quad_sum((part[r][0] + part[r][1]) +
                                 (part[r][2] + part[r][3]));
      m[r] = mx[r];
    }
  };
  // pass 2's work on a tile of logits: W = expf(logit - m) / l in float32,
  // in place, with the bits the 16-row kernel and the backward give it
  // from the same m and l (logit = x sc exactly, so fmaf(x, sc, -m sc) is
  // their rounded logit - m; expf is theirs; the division theirs, as
  // quotient_rn where both of the thread's rows span under
  // kQuotientSpan, l being a sum that holds the max's own exp(0)); then
  // W's k16 slices, rounded to bf16, into w (the A operands of O += W . V,
  // issued for a stage's value tile without a wait)
  uint32_t w[4][4];
  int narrow = 0;  // set after pass 1
  auto weights = [&](float (&x)[32]) {
    int fast = narrow;
    asm volatile("" : "+r"(fast));  // a branch here, not two pass-2 loops
    if (fast) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        x[e] = quotient_rn(expf(fmaf(x[e], sc, -mt[r])), l[r], rl[r]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        x[e] = chana_att::divide(expf(fmaf(x[e], sc, -mt[r])), l[r]);
      }
    }
  };
  auto pack_w = [&](const float (&x)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        w[kk][p] = pack_bf16(x[8 * kk + 2 * p], x[8 * kk + 2 * p + 1]);
      }
    }
  };
  auto issue_pv = [&](int i) {
    const uint32_t v_base =
        smem_u32(ring + (i % S::kStages) * S::kStageBytes) + S::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int a = 0; a < kVAtoms; ++a) {
        wgmma_m64n64k16_rs<1>(
            o[a], w[kk],
            sw128_desc(v_base + a * kAtomBytes + kk * 16 * 128));
      }
    }
    wgmma_commit();
  };

  // Stage i is key tile i in pass 1 and tile i - n in pass 2. No wgmma is
  // in flight across a loop's back edge, and none is read before the
  // wait that retires it, which lets the compiler keep them in flight
  // within an iteration. Pass 1 takes two tiles an iteration: the second
  // tile's S runs on the tensor cores while the first's is worked on.
  // Pass 2 takes one: stage i's S and stage i - 1's W . V are issued
  // together, stage i's W is worked out in float32 while that W . V runs,
  // and is packed into w once it has finished.
  const int stages = 2 * n;
  float sa[32], sb[32];
  for (int i = 0; i < n; i += 2) {  // pass 1 (n is even)
    issue_qk(sa, i);
    issue_qk(sb, i + 1);
    wgmma_wait<1>();
    fence_acc(sa);
    if (lane == 0) mbar_arrive(&empty[i % S::kStages]);  // key tile read
    to_logits(sa, i * kKeys, true);
    pass1(sa);
    wgmma_wait<0>();
    fence_acc(sb);
    if (lane == 0) mbar_arrive(&empty[(i + 1) % S::kStages]);
    to_logits(sb, (i + 1) * kKeys, true);
    pass1(sb);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = m[r] * sc;
    rl[r] = __frcp_rn(l[r]);
  }
  narrow = (m[0] - lo[0]) * sc < kQuotientSpan &&
           (m[1] - lo[1]) * sc < kQuotientSpan;
#pragma unroll
  for (int a = 0; a < kVAtoms; ++a) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[a][e] = 0.f;
  }
  issue_qk(sa, n);  // pass 2
  wgmma_wait<0>();
  fence_acc(sa);
  to_logits(sa, 0, false);
  weights(sa);
  pack_w(sa);
  for (int i = n + 1; i < stages; ++i) {
    issue_qk(sa, i);
    issue_pv(i - 1);
    wgmma_wait<1>();
    fence_acc(sa);
    to_logits(sa, (i - n) * kKeys, false);
    weights(sa);
    wgmma_wait<0>();
    // stage i - 1's key and value tiles are read
    if (lane == 0) mbar_arrive(&empty[(i - 1) % S::kStages]);
    pack_w(sa);
  }
  issue_pv(stages - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < kVAtoms; ++a) fence_acc(o[a]);

  __nv_bfloat16* const dst = out + (size_t)b * T * D + h * HDV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int a = 0; a < kVAtoms; ++a) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * a + 8 * j + 2 * c;
        if (col < HDV) {
          *reinterpret_cast<uint32_t*>(dst + (size_t)row * D + col) =
              pack_bf16(o[a][4 * j + 2 * r], o[a][4 * j + 2 * r + 1]);
        }
      }
    }
  }
  if (stats != nullptr && c == 0) {
    const size_t plane = (size_t)BH * stat_rows;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row < stat_rows) {
        stats[(size_t)bh * stat_rows + row] = mt[r];
        stats[plane + (size_t)bh * stat_rows + row] = l[r];
      }
    }
  }
}

// -- tanh-GELU --------------------------------------------------------------
//
// out = bf16(x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))) in
// float32, jax.nn.gelu's default (approximate=True) form (gelu.cuh). Each
// thread takes 8 values with one 16-byte load and store; the tail that
// does not fill 8 values is done one value at a time.

using chana_gelu::gelu_tanh_f;  // gelu.cuh, shared with the w1 product

__global__ void __launch_bounds__(CHANA_GELU_THREADS) gelu_tanh_kernel(
    const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
    long long N) {
  const long long base =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (base + 8 <= N) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + base);
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = pair_to_float2(in[k]);
      o[k] = float2_to_pair(gelu_tanh_f(f.x), gelu_tanh_f(f.y));
    }
    *reinterpret_cast<uint4*>(out + base) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    for (long long n = base; n < N; ++n) {
      out[n] = __float2bfloat16_rn(gelu_tanh_f(__bfloat162float(x[n])));
    }
  }
}

// -- host side of the long-window attention kernel ---------------------------

// Shared memory of the instance for q and k heads of width HD and v
// heads of width HDV; 0 where the kernel takes no such widths: one width
// up to 128, or latent attention's 192 and 128.
size_t warpgroup_smem(int HD, int HDV) {
  if (HD == 192 && HDV == 128) return wg_fwd::Shape<3, 2>::kSmem;
  if (HDV != HD || HD < 16 || HD > 128 || HD % 16 != 0) return 0;
  return HD > 64 ? wg_fwd::Shape<2>::kSmem : wg_fwd::Shape<1>::kSmem;
}

// The map of qkv [B, T, 3 H HD] as [B][T][3 H][HD] (q heads, then k's,
// then v's).
cudaError_t encode_qkv(CUtensorMap* map, const void* qkv, int B, int T, int H,
                       int HD) {
  return wg_att::encode_heads(map, qkv, B, T, 3 * H, HD);
}

struct WarpgroupCall {
  CUtensorMap map;
  __nv_bfloat16* out;
  float* stats;
  int T, H, HD, HDV, BH, stat_rows, blocks;
  float scale_div;
  cudaStream_t stream;
};

template <int kAtoms, int kVAtoms = kAtoms>
cudaError_t launch_warpgroup(const WarpgroupCall& c) {
  using S = wg_fwd::Shape<kAtoms, kVAtoms>;
  static size_t allowed[chana_att::kMaxDevices] = {};
  const cudaError_t err = chana_att::allow_smem(
      (const void*)causal_attention_warpgroup_kernel<kAtoms, kVAtoms>,
      S::kSmem, allowed);
  if (err != cudaSuccess) return err;
  causal_attention_warpgroup_kernel<kAtoms, kVAtoms>
      <<<c.blocks, S::kThreads, S::kSmem, c.stream>>>(
          c.map, c.out, c.stats, c.T, c.H, c.HD, c.HDV, c.BH, c.stat_rows,
          c.scale_div);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// (0 = launched). The Python wrapper checks dtypes, shapes, contiguity and
// 16-byte alignment; the checks here refuse what the kernels cannot take.

// The layernorm geometry for R rows of width D (layernorm_rows.cuh) as
// five ints; 0 when the shape is refused.
int chana_layernorm_geometry(int R, int D, int* out) {
  return chana_ln::geometry_ints(R, D, out);
}

// blocks of kWarps warps, one row a warp. The wrapper passes the
// geometry's blocks (kernels/forecaster.py's layernorm_geometry); a
// mismatch with this file's is refused.
int chana_layernorm(const void* x, const void* scale, void* out, int R,
                    int D, float eps, int blocks, void* stream) {
  chana_ln::Geometry g;
  if (!chana_ln::geometry(R, D, &g) || blocks != g.blocks) {
    return (int)cudaErrorInvalidValue;
  }
  const LayerNormFn fn = layernorm_fn(g.chunks);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  fn<<<g.blocks, chana_ln::kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)out, R, D,
      eps);
  return (int)cudaGetLastError();
}

// blocks empty blocks of threads threads.
int chana_empty(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Dynamic shared memory the attention kernel needs for T rows of head
// width HD (0 when the shape is refused).
size_t chana_causal_attention_smem(int T, int HD) {
  chana_att::Geometry g;
  return chana_att::geometry(T, HD, &g) ? g.fwd_smem : 0;
}

// One block of kWarps warps per (b, h, query tile): B * H * tiles
// blocks. The wrapper passes the geometry (kernels/forecaster.py's
// attention_geometry); a mismatch with this file's is refused. `stats`
// (float32 [3][B * H * tiles * 16], or null) receives each row's max and
// sum of exponentials in its first two planes, for the backward.
int chana_causal_attention(const void* qkv, void* out, void* stats, int B,
                           int T, int H, int HD, int HDP, int ld, int tiles,
                           int bytes, int stage, int slots, size_t smem,
                           float scale_div, void* stream) {
  chana_att::Geometry g;
  if (B <= 0 || H <= 0 || !chana_att::geometry(T, HD, &g) ||
      !chana_att::geometry_matches(g, HDP, ld, tiles, bytes, stage, slots) ||
      smem != g.fwd_smem || smem > chana_att::kSmemLimit ||
      (long long)B * H * tiles > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  static size_t allowed[chana_att::kMaxDevices] = {};
  const cudaError_t err = chana_att::allow_smem(
      (const void*)causal_attention_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  causal_attention_kernel<<<B * H * tiles, chana_att::kWarps * 32, smem,
                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, (float*)stats, T, H,
      HD, HDP, ld, tiles, bytes, stage, slots, scale_div);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the long-window attention kernel needs at head
// width HD (a multiple of 16 up to 128); 0 when the width is refused.
size_t chana_causal_attention_warpgroup_smem(int HD) {
  return warpgroup_smem(HD, HD);
}

// The long-window kernel: B * H * ceil(T / 64) blocks of 64 query rows.
// The wrapper passes its geometry (kernels/forecaster.py's
// attention_warpgroup_geometry); shared memory that differs from this
// file's is refused. `stats`, as for chana_causal_attention, with
// stat_rows = the 16-row tiles' rows of a (b, h) (T rounded up to 16).
// q, k and v are each H heads HD wide in qkv; the kernel reads the first
// HDV columns of each v head (HDV = HD, or 128 at HD = 192) and writes out
// [B, T, H HDV].
int chana_causal_attention_warpgroup(const void* qkv, void* out, void* stats,
                                     int B, int T, int H, int HD, int HDV,
                                     int stat_rows, size_t smem,
                                     float scale_div, void* stream) {
  const size_t need = warpgroup_smem(HD, HDV);
  const int rows = wg_att::kRows;
  if (B <= 0 || T <= 0 || H <= 0 || need == 0 || smem != need ||
      stat_rows != (T + chana_att::kTile - 1) / chana_att::kTile *
                       chana_att::kTile ||
      (long long)B * H * ((T + rows - 1) / rows) > 0x7fffffffLL ||
      (long long)T * 3 * H * HD * 2 >= (1ll << 40)) {  // TMA's batch stride
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  cudaError_t err = encode_qkv(&map, qkv, B, T, H, HD);
  if (err != cudaSuccess) return (int)err;
  const WarpgroupCall call = {map,
                              (__nv_bfloat16*)out,
                              (float*)stats,
                              T,
                              H,
                              HD,
                              HDV,
                              B * H,
                              stat_rows,
                              B * H * ((T + rows - 1) / rows),
                              scale_div,
                              (cudaStream_t)stream};
  err = HDV != HD  ? launch_warpgroup<3, 2>(call)
        : HD > 64 ? launch_warpgroup<2>(call)
                  : launch_warpgroup<1>(call);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


int chana_gelu_tanh(const void* x, void* out, long long N, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const long long threads = (N + 7) / 8;
  const long long blocks =
      (threads + CHANA_GELU_THREADS - 1) / CHANA_GELU_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gelu_tanh_kernel<<<(unsigned)blocks, CHANA_GELU_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (__nv_bfloat16*)out, N);
  return (int)cudaGetLastError();
}

const char* chana_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
