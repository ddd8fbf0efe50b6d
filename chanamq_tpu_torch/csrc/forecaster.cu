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
// Attention is the tensor-core design of attention_tiles.cuh: both of its
// products (q . k^T and W . V) on mma.sync, its softmax on the accumulator
// fragments in registers, one block of four warps per (batch, head, 16-row
// query tile), so that the service's batch of 1 runs on 16 blocks at
// T = 64, in one launch a call; key and value tiles stream through a ring
// in shared memory, so any window fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "gelu.cuh"
#include "layernorm_rows.cuh"

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
// the backward's row pass reads them instead of recomputing them.

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
