// Forecaster training kernels for Hopper (sm_90a): the backward passes of
// layernorm, causal attention and tanh-GELU, and the clipped momentum SGD
// update, the non-product steps of the telemetry forecaster's train step.
// The products' gradients stay plain matrix products, as the reference
// leaves them to XLA.
//
// What they replace. chanamq_tpu/models/forecaster.py::make_train_step's
// step (forecaster.py:130-157), the XLA-jitted program the forecast service
// runs for every train step (models/service.py:277): the gradients JAX's
// autodiff derives for _layernorm (:77), the attention core of _attention
// (:88-99) and jax.nn.gelu (:116), and the global-norm clip, momentum and
// SGD update (:142-152). Each computes what the reference computes, at the
// reference's rounding points: bf16 cotangents in and out, float32 inside,
// float32 parameters, momentum and gradients.
//
// What bounds them on this card. All four move far more bytes than they do
// operations. The three backward passes read a few bf16 tensors and write
// one; the attention backward does about 4 * head_dim multiply-adds a
// causal pair, under the ~295 operations a byte at which the tensor cores
// would become the limit. The update reads the gradients twice (once for
// the global norm, once to apply it), reads the parameters and the
// momentum and writes both: 6 * 4 bytes a parameter, 76 MB at the flagship
// width, and it is the one kernel of the step whose bytes take real time.
//
// What the design does about it. Nothing is staged through device memory
// that the reference does not also produce, and every cross-block sum is
// deterministic (per-block partials, then the last block to finish sums
// them in a fixed order; no float atomics), so a run repeats bit for bit
// and each kernel can be held against its plain version. Layernorm keeps
// its rows in registers and recomputes their statistics from x, and its
// dscale partials meet through a thread-block cluster's distributed
// shared memory before the last block adds one row a cluster; attention
// recomputes the softmax from q and k exactly as csrc/forecaster.cu's
// forward does and writes dq | dk | dv straight into the fused [B, T, 3D]
// cotangent of the qkv product; GELU is one pass of 16-byte loads; the
// update walks all parameter tensors in one launch from a table of
// pointers passed by value, two launches a step in all.
//
// Attention's backward has two designs, two launches a call each, no
// float atomics, and any window: up to 127 rows the tensor-core design of
// attention_tiles.cuh (all five of its products, q . k^T, dout . v^T,
// dlog . K, dlog^T . Q and W^T . dout, on mma.sync, one block per (batch,
// head, 16-row tile), a row pass for a softmax statistic, then the
// gradients, tiles streamed through a cp.async ring); from 128 rows, where
// the forward is the warpgroup kernel, a pair of warpgroup kernels on
// wgmma over TMA rings (64-row blocks: dq by query rows, dk and dv by key
// rows; the note at causal attention backward says which serves what).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attention_tiles.cuh"
#include "attention_warpgroup.cuh"
#include "layernorm_rows.cuh"

namespace cg = cooperative_groups;

#define CHANA_GELU_THREADS 256
#define CHANA_UPD_THREADS 256
#define CHANA_UPD_PER_THREAD 16
#define CHANA_UPD_CHUNK (CHANA_UPD_THREADS * CHANA_UPD_PER_THREAD)
#define CHANA_UPD_MAX_TENSORS 96

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 pair_to_float2(uint32_t w) {
  __nv_bfloat162 p;
  *reinterpret_cast<uint32_t*>(&p) = w;
  return __bfloat1622float2(p);
}

__device__ __forceinline__ uint32_t float2_to_pair(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Sum of one float a thread over the block (blockDim.x a multiple of 32,
// at most 1024), in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  return total;
}

// Shared-memory address of p, for the PTX below.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The cluster barrier in two halves: every thread arrives early (relaxed),
// and waits (acquire) only where it needs its peers.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// One arrival, with release semantics at cluster scope, on the mbarrier at
// shared-memory address addr of the cluster's block rank.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr,
                                                   uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      :: "r"(remote) : "memory");
}

// Wait (acquire, cluster scope) until the phase of parity `parity` of the
// mbarrier at shared-memory address addr has completed.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// True in the last of n blocks to call it. One thread adds to the counter
// with an acquire-release atomic after a block barrier, which orders the
// block's writes before it (release) and the other blocks' before the last
// block's reads (acquire) without a fence in every thread.
__device__ bool last_of(unsigned int* counter, unsigned int n) {
  __shared__ bool is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(counter) : "memory");
    is_last = old == n - 1;
  }
  __syncthreads();
  return is_last;
}

// -- layernorm backward -----------------------------------------------------
//
// y = bf16(xhat * scale), xhat = (x - mean) * rsqrt(var + eps), float32
// statistics recomputed from x as the forward computes them. With g = dy *
// scale (dy read as float32, the cotangent of the forward's cast):
//   dx     = bf16(rstd * (g - mean(g) - xhat * mean(g * xhat)))
//   dscale = sum over rows of dy * xhat                     (float32)
// The geometry of layernorm_rows.cuh: one row a warp, lane l the 8 values
// at columns 8 * (32 * c + l). Every load of the warp (x, dy and the
// scale, 16 bytes each) is issued before the first sum; mean(g) and
// mean(g * xhat) are summed side by side.
//
// dscale, in a fixed order and without float atomics: each lane's
// dy * xhat meet in shared memory and are added in warp order; each block
// stores its row into the shared memory of its cluster's rank 0
// (distributed shared memory) and arrives on rank 0's mbarrier, and only
// rank 0 waits: it adds the rows in rank order and writes one partial row
// (or, with a single cluster, dscale itself); the last rank 0 to finish
// adds the clusters' rows: thread groups ("phases") take every phases-th
// row in order with independent loads, and their sums are added in phase
// order.

template <int CHUNKS>
__global__ void __launch_bounds__(chana_ln::kThreads) layernorm_bwd_kernel(
    const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ dx,
    float* __restrict__ partial, float* __restrict__ dscale,
    unsigned int* __restrict__ counter, int R, int D, float eps) {
  // the warps' dscale rows [kWarps][D], then (read in rank 0 only) the
  // cluster's block rows [cluster][D]
  extern __shared__ __align__(16) float s_ds[];
  __shared__ float4 s_phase[chana_ln::kThreads];
  __shared__ __align__(8) unsigned long long s_bar;  // one arrival a block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * chana_ln::kWarps + warp;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(&s_bar)), "r"(csize));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive_relaxed();  // waited for after the rows
  float sc[CHUNKS][8];
  uint4 rx[CHUNKS], rd[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    rx[c] = rd[c] = make_uint4(0u, 0u, 0u, 0u);  // rows past R: zero
    if (col < D) {
      chana_ln::load_scale8(scale, col, sc[c]);
      if (row < R) {
        const size_t off = (size_t)row * D + col;
        rx[c] = *reinterpret_cast<const uint4*>(x + off);
        rd[c] = *reinterpret_cast<const uint4*>(dy + off);
      }
    }
  }
  // x stays packed (bf16 pairs) in registers and is unpacked where it is
  // used, which keeps the widest rows (4 chunks) from spilling
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if ((c * 32 + lane) * 8 < D) {
      float xv[8];
      chana_ln::unpack8(rx[c], xv);
#pragma unroll
      for (int k = 0; k < 4; ++k) sum += xv[2 * k] + xv[2 * k + 1];
    }
  }
  const float mu = chana_ln::warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if ((c * 32 + lane) * 8 < D) {
      float xv[8];
      chana_ln::unpack8(rx[c], xv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = xv[k] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(chana_ln::warp_sum(sq) / (float)D + eps);
  float sgs[2] = {0.f, 0.f};  // the row's sum of g, and of g * xhat
  float ds[CHUNKS][8];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
    for (int k = 0; k < 8; ++k) ds[c][k] = 0.f;
    if ((c * 32 + lane) * 8 < D) {
      float xv[8], dv[8];
      chana_ln::unpack8(rx[c], xv);
      chana_ln::unpack8(rd[c], dv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float xh = (xv[k] - mu) * rstd;
        ds[c][k] = dv[k] * xh;
        const float g = dv[k] * sc[c][k];
        sgs[0] += g;
        sgs[1] += g * xh;
      }
    }
  }
  chana_ln::warp_sums(sgs);
  if (row < R) {
    const float mg = sgs[0] / (float)D;
    const float mgx = sgs[1] / (float)D;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int col = (c * 32 + lane) * 8;
      if (col < D) {
        float xv[8], dv[8], o[8];
        chana_ln::unpack8(rx[c], xv);
        chana_ln::unpack8(rd[c], dv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh = (xv[k] - mu) * rstd;
          const float g = dv[k] * sc[c][k];
          o[k] = rstd * (g - mg - xh * mgx);
        }
        *reinterpret_cast<uint4*>(dx + (size_t)row * D + col) =
            chana_ln::pack8(o);
      }
    }
  }

  // the block's dscale row: the warps' rows, added in warp order
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < D) {
      float4* dst = reinterpret_cast<float4*>(s_ds + warp * D + col);
      dst[0] = make_float4(ds[c][0], ds[c][1], ds[c][2], ds[c][3]);
      dst[1] = make_float4(ds[c][4], ds[c][5], ds[c][6], ds[c][7]);
    }
  }
  __syncthreads();
  // the block's row, added in warp order, goes straight into rank 0's
  // shared memory (row `rank` of its cluster rows); rank 0 waits for one
  // arrival a block on its mbarrier, and the other blocks are done
  cluster_wait();  // rank 0's mbarrier is initialised, every block started
  float* const cluster_rows = s_ds + chana_ln::kWarps * D;
  float* const mine = cluster.map_shared_rank(cluster_rows, 0) + rank * D;
  for (int col = threadIdx.x; col < D; col += chana_ln::kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < chana_ln::kWarps; ++w) s += s_ds[w * D + col];
    mine[col] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) mbar_arrive_remote(smem_addr(&s_bar), 0);
  if (rank != 0) return;
  mbar_wait(smem_addr(&s_bar), 0);

  // rank 0: the cluster's row, its blocks' rows added in rank order, to
  // dscale itself with one cluster, else to the cluster's partial row
  const int n_clusters = (int)gridDim.x / csize;
  float* const row_out =
      n_clusters == 1 ? dscale : partial + (size_t)(blockIdx.x / csize) * D;
  for (int col = threadIdx.x; col < D; col += chana_ln::kThreads) {
    float s = 0.f;
    for (int b = 0; b < csize; ++b) s += cluster_rows[b * D + col];
    row_out[col] = s;
  }
  if (n_clusters == 1 || !last_of(counter, (unsigned)n_clusters)) return;

  // the last rank 0 to finish: the clusters' rows, in float4 column
  // groups; phase p adds rows p, p + phases, ... and the phases are added
  // in order
  const int groups = D / 4;
  const int phases = max(1, chana_ln::kThreads / groups);
  const int p = threadIdx.x / groups;
  if (p < phases) {
    for (int gcol = threadIdx.x % groups; gcol < groups;
         gcol += chana_ln::kThreads) {
      const float4* src = reinterpret_cast<const float4*>(partial) + gcol;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r0 = p; r0 < n_clusters; r0 += 8 * phases) {
        float4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // independent loads first
          const int r = r0 + j * phases;
          v[j] = r < n_clusters ? __ldcg(src + (size_t)r * groups)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (r0 + j * phases < n_clusters) {
            s.x += v[j].x;
            s.y += v[j].y;
            s.z += v[j].z;
            s.w += v[j].w;
          }
        }
      }
      if (phases == 1) {
        reinterpret_cast<float4*>(dscale)[gcol] = s;
      } else {
        s_phase[p * groups + gcol] = s;
      }
    }
  }
  if (phases > 1) {
    __syncthreads();
    if ((int)threadIdx.x < groups) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < phases; ++q) {
        const float4 v = s_phase[q * groups + threadIdx.x];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      reinterpret_cast<float4*>(dscale)[threadIdx.x] = s;
    }
  }
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
}

using LayerNormBwdFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                                const float*, __nv_bfloat16*, float*, float*,
                                unsigned int*, int, int, float);

// The instance for a geometry's chunks (1-4).
LayerNormBwdFn layernorm_bwd_fn(int chunks) {
  switch (chunks) {
    case 1: return layernorm_bwd_kernel<1>;
    case 2: return layernorm_bwd_kernel<2>;
    case 3: return layernorm_bwd_kernel<3>;
    case 4: return layernorm_bwd_kernel<4>;
    default: return nullptr;
  }
}

// -- causal attention backward ----------------------------------------------
//
// qkv [B, T, 3D] and dout [B, T, H HDV] -> dqkv [B, T, 3D], the cotangent of
// the fused qkv product (dq | dk | dv, head h at columns h * HD of each
// third; HDV = HD but for latent attention's values). For query rows i it
// recomputes the forward's softmax (logit = float(bf16(q_i . k_j)) /
// sqrt(HD), float32 softmax y over j <= i) from each row's max and sum of
// exponentials, which the forward keeps in the first two planes of `stats`
// [3][B H rows] when it runs for training, then
//   dW_j  = bf16(dout_i . v_j)                 (the second einsum's cotangent)
//   dl_j  = y_j * dW_j - y_j * R_i       (softmax's jvp rule, transposed: it
//           differentiates through the float32 y; R_i = sum_j y_j dW_j)
//   dlog  = bf16(dl_j / sqrt(HD))   (the cotangent of the logits' bf16 cast)
// and, with W = bf16(y):
//   dq_i = bf16(sum_j<=i dlog_ij k_j),  dk_j = bf16(sum_i>=j dlog_ij q_i),
//   dv_j = bf16(sum_i>=j W_ij dout_i).
//
// Two designs, two launches a call either way, no float atomics (a call
// repeats bit for bit), O(T^2 HD) work in all. The wrapper takes the one
// the forward takes at the shape (kernels/forecaster.py's
// attention_warpgroup_geometry, one rule for both directions):
//
// - Up to windows of 127 rows (the service's default window 64, run_node's
//   compact model at its window), and at head widths the warpgroup forward
//   does not take: the 16-row pair on mma.sync below, R_i summed as
//   sum_j u_j, u = y dW, the reference's own sum. At T = 64 a call is
//   bound by its launches and by how few blocks the window makes; 64-row
//   blocks would leave most of the card idle.
// - From T = 128 at the warpgroup forward's widths (multiples of 16 up to
//   128, and latent attention's q and k 192 with v 128): the warpgroup pair
//   further below, 64-row blocks on wgmma over TMA rings, a query-major
//   kernel for dq and a key-major one for dk and dv. The 16-row pair spends
//   its time there re-reading the prefix (its row pass streams every query
//   tile's whole key prefix only for R_i) and rebuilding every 16 x 16
//   tile, once for each 64 output columns. The warpgroup pair takes R_i as
//   FlashAttention-2's D_i = sum_c dout_ic out_ic over the forward's bf16
//   output: su_i in exact arithmetic, rounded elsewhere (through out, not
//   through y), and one pass over two rows in place of the row pass; it is
//   bound by the tensor cores' and the softmax's work (its note is below).
//
// The 16-row pair:
// - the row pass (causal_attention_bwd_stats_kernel) makes the one
//   statistic the forward cannot: one block of four warps per (b, h,
//   query tile) streams the tile's key prefix (k and v) through the ring
//   once and writes each row's sum_j u_j, float32, summed in the forward's
//   order, into the third plane of `stats`;
// - the main kernel (causal_attention_bwd_kernel), one block of eight (or
//   four) warps per (b, h, tile t), rebuilds any 16 x 16 tile of y, dlog
//   and W from those statistics alone. Warps 0-3 make dk and dv of key
//   tile t: they keep k_t and v_t and stream the query tiles i >= t (q
//   and dout) through the ring; warps 4-7 make dq of query tile t: they
//   keep q_t and dout_t and stream the key tiles j <= t (k and v). With
//   four warps, each warp takes part in both. A half's warp w
//   builds the dlog (and W) tile of the slot's tile w into shared memory as
//   bf16 (rounded already, so exact); then it adds every tile of the slot,
//   in order, into its 16 output columns (ldmatrix.trans for the
//   transposed operands), 64 columns a pass over the stream. Where both
//   streams fit one slot each (every block at T <= 64), everything is
//   staged at once and all tiles of both halves are built before one
//   barrier; else the halves stream one after the other.

// A 16 x 16 tile's y = e / sum, in place of its e = exp(logit - max) in s,
// and its dW = bf16(dout . v^T), two to a word (it is rounded already, so
// packing it is exact).
__device__ __forceinline__ void tile_y_dw(float (&s)[8], uint32_t (&dw)[4],
                                          const __nv_bfloat16* do_rows,
                                          const __nv_bfloat16* v_rows,
                                          int ld, int hdp, float l0,
                                          float l1) {
  using namespace chana_att;
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = divide(s[e], ((e >> 1) & 1) ? l1 : l0);
  float d[8];
  tile_product(d, do_rows, v_rows, ld, hdp);
#pragma unroll
  for (int e = 0; e < 4; ++e) dw[e] = pack_bf16(d[2 * e], d[2 * e + 1]);
}

__global__ void __launch_bounds__(chana_att::kWarps * 32, 4)
    causal_attention_bwd_stats_kernel(const __nv_bfloat16* __restrict__ qkv,
                                      const __nv_bfloat16* __restrict__ dout,
                                      float* __restrict__ stats, int T,
                                      int H, int HD, int HDP, int ld,
                                      int tiles, int bytes, int stage,
                                      int slots, float scale_div) {
  using namespace chana_att;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_su = reinterpret_cast<float*>(smem_raw);  // [kWarps][16]
  __nv_bfloat16* s_q =
      reinterpret_cast<__nv_bfloat16*>(s_su + kWarps * kTile);
  __nv_bfloat16* s_do = s_q + kTile * ld;
  const int slot = stage * kTile * ld;
  __nv_bfloat16* ring_k = s_do + kTile * ld;  // [slots][stage * 16][ld]
  __nv_bfloat16* ring_v = ring_k + slots * slot;
  const int bh = blockIdx.x / tiles;
  const int tile = tiles - 1 - (blockIdx.x - bh * tiles);
  const int h = bh % H;
  const int b = bh / H;
  const int D = H * HD;
  const Head head{(size_t)3 * D, T, HD, HDP, ld, bytes};
  Head dhead = head;
  dhead.stride = D;
  const __nv_bfloat16* src = qkv + (size_t)b * T * head.stride + h * HD;
  const int row0 = tile * kTile;
  const int nkt = tile + 1;
  const bool staged = nkt <= stage;
  const Divisor scale = divisor(scale_div);
  stage_rows(s_q, src, head, row0, kTile);
  stage_rows(s_do, dout + (size_t)b * T * D + h * HD, dhead, row0, kTile);
  if (staged) {
    stage_rows(ring_k, src + D, head, 0, nkt * kTile);
    stage_rows(ring_v, src + 2 * D, head, 0, nkt * kTile);
  }
  cp_async_commit();
  // the forward's max and sum of this lane's rows g and g + 8
  const size_t plane = (size_t)gridDim.x * kTile;  // B H rows
  const int g = (threadIdx.x & 31) >> 2;
  float* row = stats + (size_t)bh * tiles * kTile + row0;
  const float m0 = row[g], m1 = row[g + 8];
  const float l0 = row[plane + g], l1 = row[plane + g + 8];
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  float su0 = 0.f, su1 = 0.f;  // sum_j y_j dW_j
  for_each_slot(ring_k, ring_v, src + D, src + 2 * D, head, head, stage, 0,
                nkt, staged,
                [&](const __nv_bfloat16* k_slot,
                    const __nv_bfloat16* v_slot, int j0, int n) {
                  const int i = slot_tile(warp, j0, n);
                  if (i < 0) return;
                  float s[8];
                  tile_logits(s, s_q, k_slot + i * kTile * ld, ld, HDP,
                              row0, (j0 + i) * kTile, T, scale);
                  tile_exp(s, m0, m1);
                  uint32_t dw[4];
                  tile_y_dw(s, dw, s_do, v_slot + i * kTile * ld, ld, HDP,
                            l0, l1);
#pragma unroll
                  for (int e = 0; e < 8; e += 2) {
                    const float2 d = unpack_bf16(dw[e / 2]);
                    const float u = s[e] * d.x + s[e + 1] * d.y;
                    if ((e >> 1) & 1) {
                      su1 += u;
                    } else {
                      su0 += u;
                    }
                  }
                });
  su0 = quad_sum(su0);
  su1 = quad_sum(su1);
  combine_rows(s_su, su0, su1, [](float x, float y) { return x + y; });
  if (threadIdx.x < 32 && (threadIdx.x & 3) == 0) {
    row[2 * plane + g] = su0;
    row[2 * plane + g + 8] = su1;
  }
}

// One lane's rows' statistics from the row pass: rows g and g + 8 of a
// tile.
struct RowStats {
  float m0, m1, l0, l1, su0, su1;
};

template <int NW>
__global__ void __launch_bounds__(NW * 32, NW == 4 ? 4 : 2)
    causal_attention_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ dout,
                                const float* __restrict__ stats,
                                __nv_bfloat16* __restrict__ dqkv, int T,
                                int H, int HD, int HDP, int ld, int tiles,
                                int bytes, int stage, int slots,
                                float scale_div) {
  using namespace chana_att;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slot = stage * kTile * ld;
  // tile t's own rows of q, k, dout and v, [16][ld] each
  __nv_bfloat16* s_qt = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_kt = s_qt + kTile * ld;
  __nv_bfloat16* s_dot = s_kt + kTile * ld;
  __nv_bfloat16* s_vt = s_dot + kTile * ld;
  // the rings, [2][stage * 16][ld] each, after them; with one slot (a
  // window of one tile, slots of one tile) the own tiles are the rings'
  // two slots, since the streams hold just tile t: q_t and k_t are ring_a,
  // dout_t and v_t ring_b
  const bool own_ring = slots == 1;
  __nv_bfloat16* ring_a = own_ring ? s_qt : s_vt + kTile * ld;
  __nv_bfloat16* ring_b = own_ring ? s_dot : ring_a + 2 * slot;
  // [stage][16][kTileLd] each: dlog and W tiles of the dk, dv half, dlog
  // tiles of the dq half
  __nv_bfloat16* s_dl = own_ring ? s_vt + kTile * ld : ring_b + 2 * slot;
  __nv_bfloat16* s_w = s_dl + stage * kTile * kTileLd;
  __nv_bfloat16* s_dlq = s_w + stage * kTile * kTileLd;
  const int bh = blockIdx.x / tiles;
  const int t = blockIdx.x - bh * tiles;
  const int h = bh % H;
  const int b = bh / H;
  const int D = H * HD;
  const Head head{(size_t)3 * D, T, HD, HDP, ld, bytes};
  Head dhead = head;
  dhead.stride = D;
  const __nv_bfloat16* src = qkv + (size_t)b * T * head.stride + h * HD;
  const __nv_bfloat16* dsrc = dout + (size_t)b * T * D + h * HD;
  __nv_bfloat16* dst = dqkv + (size_t)b * T * head.stride + h * HD;
  const size_t plane = (size_t)gridDim.x * kTile;
  const float* st = stats + (size_t)bh * tiles * kTile;  // m | l | su rows
  const int r0 = t * kTile;
  // with eight warps, warps 0-3 take the dk, dv half and warps 4-7 the dq
  // half; with four, every warp takes both. lw is a warp's place in a half
  // (its tile of a slot, its 16 columns of 64).
  static_assert(NW == kWarps || NW == 2 * kWarps, "four or eight warps");
  const int warp = threadIdx.x >> 5;
  const bool kv_half = NW == kWarps || warp < kWarps;
  const bool q_half = NW == kWarps || warp >= kWarps;
  const int lw = warp % kWarps;
  const int g = (threadIdx.x & 31) >> 2;
  const int c = threadIdx.x & 3;
  const Divisor scale = divisor(scale_div);
  auto row_stats = [&](int row0) {
    return RowStats{st[row0 + g], st[row0 + g + 8], st[plane + row0 + g],
                    st[plane + row0 + g + 8], st[2 * plane + row0 + g],
                    st[2 * plane + row0 + g + 8]};
  };

  // dlog (and W) of the tile of query rows row0.. and keys key0..: logits
  // of q_rows . k_rows^T, dW of do_rows . v_rows^T, the rows' statistics
  // from the row pass; zero in rows past T (they add nothing to dk, dv)
  auto build = [&](const __nv_bfloat16* q_rows, const __nv_bfloat16* k_rows,
                   const __nv_bfloat16* do_rows, const __nv_bfloat16* v_rows,
                   int row0, int key0, const RowStats& rs,
                   __nv_bfloat16* dl_tile, __nv_bfloat16* w_tile) {
    float s[8];
    uint32_t dw[4];
    tile_logits(s, q_rows, k_rows, ld, HDP, row0, key0, T, scale);
    tile_exp(s, rs.m0, rs.m1);
    tile_y_dw(s, dw, do_rows, v_rows, ld, HDP, rs.l0, rs.l1);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int row = frag_row(e);
      const bool real = row0 + row < T;
      const float su = ((e >> 1) & 1) ? rs.su1 : rs.su0;
      const float y0 = s[e], y1 = s[e + 1];
      const float2 d = unpack_bf16(dw[e / 2]);
      const int off = row * kTileLd + frag_col(e);
      *reinterpret_cast<uint32_t*>(dl_tile + off) =
          real ? pack_bf16(divide(y0 * d.x - y0 * su, scale),
                           divide(y1 * d.y - y1 * su, scale))
               : 0u;
      if (w_tile != nullptr) {
        *reinterpret_cast<uint32_t*>(w_tile + off) =
            real ? pack_bf16(y0, y1) : 0u;
      }
    }
  };
  // 16 output columns of tile t (rows r0..), which = 0 / 1 / 2 for dq /
  // dk / dv, from a warp's two n8 accumulators
  auto store = [&](const float (&acc)[2][4], int which, int col0) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = col0 + n * 8 + 2 * c;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (col < HD && row < T) {
          *reinterpret_cast<uint32_t*>(dst + (size_t)row * head.stride +
                                       which * D + col) =
              pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
        }
      }
    }
  };

  // the steps of both halves, a slot's worth of tiles at a time:
  // dk and dv of key tile t from query tiles i0.. (q, dout in the slot;
  // k_t, v_t kept), dq of query tile t from key tiles j0.. (k, v in the
  // slot; q_t, dout_t kept). A half's warp lw builds the dlog (and W) tile
  // of the slot's tile lw, then, after a barrier, adds every tile of the
  // slot in order into its 16 output columns.
  auto build_kv = [&](const __nv_bfloat16* q_slot,
                      const __nv_bfloat16* do_slot, int i0, int n,
                      const RowStats* pre) {
    if (kv_half && lw < n) {
      const int row0 = (i0 + lw) * kTile;
      build(q_slot + lw * kTile * ld, s_kt, do_slot + lw * kTile * ld, s_vt,
            row0, r0, pre != nullptr ? *pre : row_stats(row0),
            s_dl + lw * kTile * kTileLd, s_w + lw * kTile * kTileLd);
    }
  };
  auto add_kv = [&](const __nv_bfloat16* q_slot,
                    const __nv_bfloat16* do_slot, int n, int cols,
                    float (&dk)[2][4], float (&dv)[2][4]) {
    for (int j = 0; j < n; ++j) {
      uint32_t a[4], bq[4];
      load_a_trans(a, s_dl + j * kTile * kTileLd, kTileLd);
      load_b_kn(bq, q_slot + j * kTile * ld + cols, ld);
      mma_bf16(dk[0], a, bq[0], bq[1]);
      mma_bf16(dk[1], a, bq[2], bq[3]);
      load_a_trans(a, s_w + j * kTile * kTileLd, kTileLd);
      load_b_kn(bq, do_slot + j * kTile * ld + cols, ld);
      mma_bf16(dv[0], a, bq[0], bq[1]);
      mma_bf16(dv[1], a, bq[2], bq[3]);
    }
  };
  auto build_q = [&](const __nv_bfloat16* k_slot,
                     const __nv_bfloat16* v_slot, int j0, int n,
                     const RowStats& own) {
    if (q_half && lw < n) {
      build(s_qt, k_slot + lw * kTile * ld, s_dot, v_slot + lw * kTile * ld,
            r0, (j0 + lw) * kTile, own, s_dlq + lw * kTile * kTileLd,
            nullptr);
    }
  };
  auto add_q = [&](const __nv_bfloat16* k_slot, int n, int cols,
                   float (&dq)[2][4]) {
    for (int j = 0; j < n; ++j) {
      uint32_t a[4], bk[4];
      load_a(a, s_dlq + j * kTile * kTileLd, kTileLd);
      load_b_kn(bk, k_slot + j * kTile * ld + cols, ld);
      mma_bf16(dq[0], a, bk[0], bk[1]);
      mma_bf16(dq[1], a, bk[2], bk[3]);
    }
  };

  // The block's own tiles, and whatever of the two streams fits in one
  // slot, staged at once: the query tiles i >= t (q, dout) in slot 0, and
  // the key tiles j <= t (k, v) in slot 1 when both fit. The rows'
  // statistics that are known now load meanwhile.
  const int nq = tiles - t;  // query tiles i >= t
  const int nk = t + 1;      // key tiles j <= t
  const bool kv_staged = nq <= stage;
  const bool both = kv_staged && nk <= stage;
  stage_rows(s_kt, src + D, head, r0, kTile);
  stage_rows(s_vt, src + 2 * D, head, r0, kTile);
  stage_rows(s_qt, src, head, r0, kTile);
  stage_rows(s_dot, dsrc, dhead, r0, kTile);
  if (kv_staged && !own_ring) {
    stage_rows(ring_a, src, head, r0, nq * kTile);
    stage_rows(ring_b, dsrc, dhead, r0, nq * kTile);
  }
  if (both && !own_ring) {
    stage_rows(ring_a + slot, src + D, head, 0, nk * kTile);
    stage_rows(ring_b + slot, src + 2 * D, head, 0, nk * kTile);
  }
  cp_async_commit();
  const RowStats own = row_stats(r0);
  RowStats kv_rows{};
  if (kv_staged && kv_half && lw < nq) kv_rows = row_stats(r0 + lw * kTile);
  cp_async_wait<0>();
  __syncthreads();

  if (both) {
    // every tile of both halves is staged (a window of 64 always is): the
    // two halves build their tiles side by side, then add them, 64
    // columns at a time
    build_kv(ring_a, ring_b, t, nq, &kv_rows);
    build_q(ring_a + slot, ring_b + slot, 0, nk, own);
    __syncthreads();
    for (int col0 = 0; col0 < HDP; col0 += kColChunk) {
      const int cols = col0 + lw * 16;  // this warp's 16 columns
      if (cols >= HDP) continue;
      if (kv_half) {
        float dk[2][4] = {}, dv[2][4] = {};
        add_kv(ring_a, ring_b, nq, cols, dk, dv);
        store(dk, 1, cols);
        store(dv, 2, cols);
      }
      if (q_half) {
        float dq[2][4] = {};
        add_q(ring_a + slot, nk, cols, dq);
        store(dq, 0, cols);
      }
    }
    return;
  }
  // else each half streams its slots in turn (the dk, dv half from slot 0
  // when its tiles fit there), rebuilding its tiles for every 64 columns;
  // the other half's warps help stage and wait at the barriers
  for (int col0 = 0; col0 < HDP; col0 += kColChunk) {
    const int cols = col0 + lw * 16;
    float dk[2][4] = {}, dv[2][4] = {};
    for_each_slot(ring_a, ring_b, src, dsrc, head, dhead, stage, t, nq,
                  kv_staged,
                  [&](const __nv_bfloat16* q_slot,
                      const __nv_bfloat16* do_slot, int i0, int n) {
                    build_kv(q_slot, do_slot, i0, n,
                             kv_staged ? &kv_rows : nullptr);
                    __syncthreads();
                    if (kv_half && cols < HDP) {
                      add_kv(q_slot, do_slot, n, cols, dk, dv);
                    }
                  });
    if (kv_half && cols < HDP) {
      store(dk, 1, cols);
      store(dv, 2, cols);
    }
  }
  for (int col0 = 0; col0 < HDP; col0 += kColChunk) {
    const int cols = col0 + lw * 16;
    float dq[2][4] = {};
    for_each_slot(ring_a, ring_b, src + D, src + 2 * D, head, head, stage, 0,
                  nk, false,
                  [&](const __nv_bfloat16* k_slot,
                      const __nv_bfloat16* v_slot, int j0, int n) {
                    build_q(k_slot, v_slot, j0, n, own);
                    __syncthreads();
                    if (q_half && cols < HDP) add_q(k_slot, n, cols, dq);
                  });
    if (q_half && cols < HDP) store(dq, 0, cols);
  }
}

// -- causal attention backward for long windows: a warpgroup pair ----------
//
// The same function as the 16-row pair above, from T = 128 at the widths
// the warpgroup forward takes, with R_i = D_i = sum_c dout_ic out_ic.
//
// What bounds it. Seven bf16 products over the causal pairs (q . k^T and
// dout . v^T in each kernel, then dq, dk and dv): 8 HD + 6 HDV operations
// a pair, where the 16-row pair rebuilds far more. The flagship's training
// call (B = 16, T = 2,048, 4 heads of 64) is 1.2e11 operations, 0.12 ms at
// 989 TFLOP/s, and 64 x 64 tiles take the diagonal whole; above width 64
// the key-major kernel forms q . k^T once more (its two passes). Besides,
// each kernel's softmax work: an exponential and a reciprocal on the
// special function unit and some thirty float32 instructions a pair. Each
// kernel reads q, k, v and dout about T / 128 times from L2 (a 64-row
// block streams the other side's tiles), ~1.1 GB a call at the flagship's
// shape, and writes its outputs once.
//
// The design:
// - Both kernels take 64 rows of one (b, h) a block on one consumer
//   warpgroup (wgmma's m64), plus one producer warp that fills a ring of
//   kStages stages through the tensor memory accelerator (full and empty
//   mbarriers); blocks go longest first. Boxes and maps are the forward's
//   (attention_warpgroup.cuh): 64 rows of one head, 64 columns, 128-byte
//   swizzle, zeros past HD, HDV and T.
// - The query-major kernel (causal_attention_bwd_dq_kernel): first D of
//   its 64 rows from dout and out in float32 (two threads a row), into the
//   third plane of `stats`; then, keeping q and dout, it streams the key
//   prefix's k and v tiles: S = Q K^T and dP = dout V^T on wgmma (both
//   operands from shared memory), the logits, y and dlog in registers
//   (the 16-row pair's bits for y: expf of the rounded difference, the
//   division as quotient_rn from each row's 1 / l), and dQ += dlog . K
//   with dlog packed in registers as the A operand. dq is rounded once.
// - The key-major kernel (causal_attention_bwd_dkv_kernel): keeping k and
//   v, it streams the query tiles at and below its rows (q, dout and those
//   rows' m, l and D) and forms the transposes, S^T = K Q^T and dP^T =
//   V dout^T, so that W^T and dlog^T are the register A operands of
//   dV += W^T . dout and dK += dlog^T . Q; each query column's statistics
//   come from the stage in shared memory. Up to width 64 one pass makes
//   both; wider, the registers of dk and dv together do not fit a thread,
//   and the query tiles stream twice (dv from S^T alone, then dk).
// - The tensor cores' work overlaps the softmax's: a tile's S and dP are
//   issued with the last tile's output products, and its softmax work runs
//   while those products do. No wgmma is in flight across a loop's back
//   edge, sits in a branch, or has its accumulator read before the wait
//   that retires it; otherwise the compiler serializes every wgmma.
// - Every output element is written once, by one block, its sums in a
//   fixed order: no atomics, and a call repeats bit for bit.

namespace wg_bwd {

using wg_att::kAtomBytes;
using wg_att::kKeys;
using wg_att::kRows;

// q and k heads of up to 64 kAtoms, values of up to 64 kVAtoms.
template <int kAtoms, int kVAtoms>
struct Shape {
  static constexpr int kThreads = 128 + 32;  // consumers, the producer
  static constexpr bool kNarrow = kAtoms == 1 && kVAtoms == 1;
  // the key-major kernel's two passes over the query tiles (dv, then dk)
  // above width 64, whose dk and dv registers would not fit together
  static constexpr bool kTwoPass = !kNarrow;
  // blocks an SM as the compiler's bound on registers: two of the
  // query-major kernel up to width 64 (168 registers a thread; 30% faster
  // at the flagship's shape than at the 200 it takes unbound), one of the
  // key-major kernel, which keeps dk, dv, S, dP and both A operands in
  // registers (226 a thread up to width 64; bound to two blocks it spills)
  static constexpr int kDqBlocksPerSM = kNarrow ? 2 : 1;
  static constexpr int kDkvBlocksPerSM = 1;
  // ring stages: a stage is released a tile late (once the output product
  // that reads it has run), so the next tile's loads fly meanwhile
  static constexpr int kStages = kNarrow ? 4 : 3;
  static constexpr int kQBytes = kAtoms * kAtomBytes;   // a q or k tile
  static constexpr int kVBytes = kVAtoms * kAtomBytes;  // a v or dout tile
  // m, l and D of a stage's 64 rows (768 bytes), padded so that the next
  // stage's boxes stay aligned for the swizzle
  static constexpr int kStatBytes = 1024;
  static constexpr int kStatTx = 3 * kRows * 4;
  static constexpr int kDqStage = kQBytes + kVBytes;  // k and v tiles
  static constexpr int kDkvStage = kQBytes + kVBytes + kStatBytes;
  // the block's own tiles, the ring, + 1024 bytes to align the boxes
  static constexpr int kDqSmem = kQBytes + kVBytes + kStages * kDqStage + 1024;
  static constexpr int kDkvSmem =
      kQBytes + kVBytes + kStages * kDkvStage + 1024;
};

// Which outputs a pass of the key-major kernel makes.
template <bool kV, bool kK>
struct Outputs {
  static constexpr bool kDV = kV;
  static constexpr bool kDK = kK;
};

// S to logits over sc in place: float(bf16(S)), divided by sqrt(HD) where
// that is not a power of two, with the 16-row pair's bits (quotient, or
// the division where the tile holds a logit under 2^-100).
__device__ __forceinline__ void to_logits(float (&x)[32], int pow2,
                                          float scale_div, float inv_scale) {
  using chana_att::pack_bf16;
  using chana_att::unpack_bf16;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {  // one conversion a pair
    const float2 p = unpack_bf16(pack_bf16(x[e], x[e + 1]));
    x[e] = p.x;
    x[e + 1] = p.y;
  }
  if (!pow2) {
    int tiny = 0;
#pragma unroll
    for (int e = 0; e < 32; ++e) tiny |= fabsf(x[e]) < 0x1p-100f && x[e] != 0.f;
    if (tiny) {
#pragma unroll
      for (int e = 0; e < 32; ++e) x[e] = chana_att::divide(x[e], scale_div);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        x[e] = wg_att::quotient(x[e], scale_div, inv_scale);
      }
    }
  }
}

// dlog (before its rounding) of dl = y dW - y R in place over sqrt(HD):
// the multiply by 1 / sqrt(HD) where that is exact, else the division's
// bits (quotient, or the division where a value is under 2^-100).
__device__ __forceinline__ void over_scale(float (&x)[32], int pow2,
                                           float scale_div, float inv_scale) {
  if (pow2) {
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] *= inv_scale;
    return;
  }
  int tiny = 0;
#pragma unroll
  for (int e = 0; e < 32; ++e) tiny |= fabsf(x[e]) < 0x1p-100f && x[e] != 0.f;
  if (tiny) {
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] = chana_att::divide(x[e], scale_div);
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      x[e] = wg_att::quotient(x[e], scale_div, inv_scale);
    }
  }
}

// A 64 x 64 accumulator's k16 slices, rounded to bf16, as the A operands
// of the next product (tma_wgmma.cuh's wgmma_m64n64k16_rs).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      a[kk][p] = chana_att::pack_bf16(x[8 * kk + 2 * p], x[8 * kk + 2 * p + 1]);
    }
  }
}

}  // namespace wg_bwd

template <int kAtoms, int kVAtoms>
__global__ void __launch_bounds__(
    wg_bwd::Shape<kAtoms, kVAtoms>::kThreads,
    wg_bwd::Shape<kAtoms, kVAtoms>::kDqBlocksPerSM)
    causal_attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap qkv_map,
                                   const __grid_constant__ CUtensorMap dout_map,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const __nv_bfloat16* __restrict__ out,
                                   float* __restrict__ stats,
                                   __nv_bfloat16* __restrict__ dqkv, int T,
                                   int H, int HD, int HDV, int BH,
                                   int stat_rows, float scale_div) {
  using namespace chana_tma;
  using namespace wg_att;
  using S = wg_bwd::Shape<kAtoms, kVAtoms>;
  using chana_att::neg_inf;
  using chana_att::pack_bf16;
  using chana_att::unpack_bf16;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full[S::kStages];
  __shared__ __align__(8) uint64_t empty[S::kStages];
  __shared__ __align__(8) uint64_t own_full;
  __shared__ float s_d[kRows];
  uint8_t* const q_smem =
      wg_smem + ((1024u - (smem_u32(wg_smem) & 1023u)) & 1023u);
  uint8_t* const do_smem = q_smem + S::kQBytes;
  uint8_t* const ring = do_smem + S::kVBytes;

  const int qb = (int)gridDim.x / BH - 1 - (int)blockIdx.x / BH;
  const int bh = (int)blockIdx.x % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int r0 = qb * kRows;
  const int n = (min(r0 + kRows, T) + kKeys - 1) / kKeys;  // key tiles
  const int warp = (int)threadIdx.x >> 5;
  const int lane = (int)threadIdx.x & 31;
  const size_t plane = (size_t)BH * stat_rows;

  if (threadIdx.x == 128) {
    tma_prefetch(&qkv_map);
    tma_prefetch(&dout_map);
    for (int s = 0; s < S::kStages; ++s) {
      chana_tma::mbar_init(&full[s], 1);
      chana_tma::mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    chana_tma::mbar_init(&own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      chana_tma::mbar_expect_tx(&own_full, S::kQBytes + S::kVBytes);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(q_smem + a * kAtomBytes, &qkv_map, &own_full, 64 * a, h,
                    r0, b);
      }
      for (int a = 0; a < kVAtoms; ++a) {
        tma_load_4d(do_smem + a * kAtomBytes, &dout_map, &own_full, 64 * a,
                    h, r0, b);
      }
      // stage i: key tile i and its value tile (the first kVAtoms boxes)
      for (int i = 0; i < n; ++i) {
        const int slot = i % S::kStages;
        if (i >= S::kStages) {
          chana_tma::mbar_wait(&empty[slot], ((i / S::kStages) - 1) & 1);
        }
        uint8_t* const st = ring + slot * S::kDqStage;
        chana_tma::mbar_expect_tx(&full[slot], S::kDqStage);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_4d(st + a * kAtomBytes, &qkv_map, &full[slot], 64 * a,
                      H + h, i * kKeys, b);
        }
        for (int a = 0; a < kVAtoms; ++a) {
          tma_load_4d(st + S::kQBytes + a * kAtomBytes, &qkv_map, &full[slot],
                      64 * a, 2 * H + h, i * kKeys, b);
        }
      }
    }
    return;
  }

  // D of the block's rows while the first tiles load: thread t sums half
  // t % 2 of row t / 2's dout . out in float32, the halves then added
  {
    const int t = (int)threadIdx.x;
    const int row = r0 + (t >> 1);
    const int per = HDV / 2;  // a multiple of 8
    float d = 0.f;
    if (row < T) {
      const size_t at = ((size_t)b * T + row) * H * HDV + (size_t)h * HDV +
                        (size_t)(t & 1) * per;
      for (int col = 0; col < per; col += 8) {
        const uint4 x = *reinterpret_cast<const uint4*>(dout + at + col);
        const uint4 y = *reinterpret_cast<const uint4*>(out + at + col);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 u = unpack_bf16(xs[k]);
          const float2 v = unpack_bf16(ys[k]);
          d = fmaf(u.x, v.x, d);
          d = fmaf(u.y, v.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if ((t & 1) == 0) {
      s_d[t >> 1] = d;
      if (row < stat_rows) stats[2 * plane + (size_t)bh * stat_rows + row] = d;
    }
  }
  named_barrier(1, 128);

  // the consumer warpgroup: lane l of warp w holds rows
  // row_a = r0 + 16 w + l / 4 and row_a + 8, and their statistics
  const int row_a = r0 + 16 * warp + (lane >> 2);
  const int c = lane & 3;
  float mr[2], lr[2], rl[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool kept = row < stat_rows;
    mr[r] = kept ? stats[(size_t)bh * stat_rows + row] : 0.f;
    lr[r] = kept ? stats[plane + (size_t)bh * stat_rows + row] : 1.f;
    rl[r] = __frcp_rn(lr[r]);
    dr[r] = s_d[row - r0];
  }
  // 1 / sqrt(HD), correctly rounded; where sqrt(HD) is a power of two the
  // logits are kept as float(bf16(S)) and the exact scale sc rides in the
  // exponent's argument (the forward's pass 2), elsewhere each logit is
  // divided and sc is 1
  const float inv_scale = __frcp_rn(scale_div);
  const int pow2 = (__float_as_uint(scale_div) & 0x007fffffu) == 0u;
  const float sc = pow2 ? inv_scale : 1.f;
  const uint32_t q_base = smem_u32(q_smem);
  const uint32_t do_base = smem_u32(do_smem);
  chana_tma::mbar_wait(&own_full, 0);

  float s[32], dp[32];
  float dq[kAtoms][32];
  uint32_t ds[4][4];  // dlog's k16 slices: the A operands of dQ += dlog . K
  // stage i's S = Q K^T and dP = dout V^T
  auto issue_sdp = [&](int i) {
    const int slot = i % S::kStages;
    chana_tma::mbar_wait(&full[slot], (i / S::kStages) & 1);
    const uint32_t base = smem_u32(ring + slot * S::kDqStage);
    fence_acc(s);
    fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kAtoms; ++kk) {
      const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
      wgmma_m64n64k16<0, 0>(s, sw128_desc(q_base + off),
                            sw128_desc(base + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * kVAtoms; ++kk) {
      const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
      wgmma_m64n64k16<0, 0>(dp, sw128_desc(do_base + off),
                            sw128_desc(base + S::kQBytes + off), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dlog . K_i (K from shared memory, N-major)
  auto issue_dq = [&](int i) {
    const uint32_t k_base = smem_u32(ring + (i % S::kStages) * S::kDqStage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        wgmma_m64n64k16_rs<1>(
            dq[a], ds[kk],
            sw128_desc(k_base + a * kAtomBytes + kk * 16 * 128));
      }
    }
    wgmma_commit();
  };
  // the tile of keys key0..: dlog = bf16((y dW - y D) / sqrt(HD)) into s
  // (before its rounding), y = exp(logit - m) / l, -inf logits past the
  // row or past T (only a tile that reaches past its first row or past T
  // is masked key by key)
  auto grads = [&](int key0) {
    int p2 = pow2;
    asm volatile("" : "+r"(p2));  // branches here, not copies of the loop
    wg_bwd::to_logits(s, p2, scale_div, inv_scale);
    if (key0 + kKeys - 1 > r0 || key0 + kKeys > T) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = key0 + 8 * (e >> 2) + 2 * c + (e & 1);
        if (key > row_a + 8 * ((e >> 1) & 1) || key >= T) s[e] = neg_inf();
      }
    }
    int slow = 0;  // an exponential too small for quotient_rn
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int r = (e >> 1) & 1;
      s[e] = expf(fmaf(s[e], sc, -mr[r]));
      slow |= s[e] != 0.f && s[e] < kQuotientLeast;
    }
    if (slow) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        s[e] = chana_att::divide(s[e], lr[(e >> 1) & 1]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        s[e] = quotient_rn(s[e], lr[r], rl[r]);
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float dw = chana_att::round_bf16(dp[e]);
      s[e] = s[e] * dw - s[e] * dr[(e >> 1) & 1];
    }
    wg_bwd::over_scale(s, p2, scale_div, inv_scale);
  };

  // Stage i's S and dP are issued with stage i - 1's dQ product; stage
  // i's dlog is worked out while that product runs, and packed once it
  // has finished (its A operand is the last tile's dlog).
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[a][e] = 0.f;
  }
  issue_sdp(0);
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dp);
  grads(0);
  wg_bwd::pack_a(ds, s);
  for (int i = 1; i < n; ++i) {
    issue_sdp(i);
    issue_dq(i - 1);
    wgmma_wait<1>();
    fence_acc(s);
    fence_acc(dp);
    grads(i * kKeys);
    wgmma_wait<0>();
    // stage i - 1's key and value tiles are read
    if (lane == 0) chana_tma::mbar_arrive(&empty[(i - 1) % S::kStages]);
    wg_bwd::pack_a(ds, s);
  }
  issue_dq(n - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < kAtoms; ++a) fence_acc(dq[a]);

  const size_t ld = (size_t)3 * H * HD;  // dqkv's row
  __nv_bfloat16* const dst = dqkv + (size_t)b * T * ld + (size_t)h * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * a + 8 * j + 2 * c;
        if (col < HD) {
          *reinterpret_cast<uint32_t*>(dst + (size_t)row * ld + col) =
              pack_bf16(dq[a][4 * j + 2 * r], dq[a][4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

template <int kAtoms, int kVAtoms>
__global__ void __launch_bounds__(
    wg_bwd::Shape<kAtoms, kVAtoms>::kThreads,
    wg_bwd::Shape<kAtoms, kVAtoms>::kDkvBlocksPerSM)
    causal_attention_bwd_dkv_kernel(
        const __grid_constant__ CUtensorMap qkv_map,
        const __grid_constant__ CUtensorMap dout_map,
        const __grid_constant__ CUtensorMap stats_map,
        __nv_bfloat16* __restrict__ dqkv, int T, int H, int HD, int HDV,
        int BH, float scale_div) {
  using namespace chana_tma;
  using namespace wg_att;
  using S = wg_bwd::Shape<kAtoms, kVAtoms>;
  using chana_att::neg_inf;
  using chana_att::pack_bf16;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full[S::kStages];
  __shared__ __align__(8) uint64_t empty[S::kStages];
  __shared__ __align__(8) uint64_t own_full;
  uint8_t* const k_smem =
      wg_smem + ((1024u - (smem_u32(wg_smem) & 1023u)) & 1023u);
  uint8_t* const v_smem = k_smem + S::kQBytes;
  uint8_t* const ring = v_smem + S::kVBytes;

  const int nq = (int)gridDim.x / BH;  // 64-row tiles of the window
  const int kb = (int)blockIdx.x / BH;  // the most query tiles first
  const int bh = (int)blockIdx.x % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = kb * kRows;
  const int tiles = nq - kb;  // query tiles kb .. nq - 1
  constexpr int kPasses = S::kTwoPass ? 2 : 1;
  const int warp = (int)threadIdx.x >> 5;
  const int lane = (int)threadIdx.x & 31;

  if (threadIdx.x == 128) {
    tma_prefetch(&qkv_map);
    tma_prefetch(&dout_map);
    tma_prefetch(&stats_map);
    for (int s = 0; s < S::kStages; ++s) {
      chana_tma::mbar_init(&full[s], 1);
      chana_tma::mbar_init(&empty[s], 4);  // one arrival a consumer warp
    }
    chana_tma::mbar_init(&own_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer
    if (lane == 0) {
      chana_tma::mbar_expect_tx(&own_full, S::kQBytes + S::kVBytes);
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(k_smem + a * kAtomBytes, &qkv_map, &own_full, 64 * a,
                    H + h, k0, b);
      }
      for (int a = 0; a < kVAtoms; ++a) {
        tma_load_4d(v_smem + a * kAtomBytes, &qkv_map, &own_full, 64 * a,
                    2 * H + h, k0, b);
      }
      // stage idx: query tile kb + idx % tiles (every pass streams them
      // all): its q and dout rows and their m, l and D
      for (int idx = 0; idx < kPasses * tiles; ++idx) {
        const int q0 = (kb + idx % tiles) * kRows;
        const int slot = idx % S::kStages;
        if (idx >= S::kStages) {
          chana_tma::mbar_wait(&empty[slot], ((idx / S::kStages) - 1) & 1);
        }
        uint8_t* const st = ring + slot * S::kDkvStage;
        chana_tma::mbar_expect_tx(&full[slot], S::kQBytes + S::kVBytes + S::kStatTx);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load_4d(st + a * kAtomBytes, &qkv_map, &full[slot], 64 * a, h,
                      q0, b);
        }
        for (int a = 0; a < kVAtoms; ++a) {
          tma_load_4d(st + S::kQBytes + a * kAtomBytes, &dout_map,
                      &full[slot], 64 * a, h, q0, b);
        }
        tma_load_3d(st + S::kQBytes + S::kVBytes, &stats_map, &full[slot], q0,
                    bh, 0);
      }
    }
    return;
  }

  // the consumer warpgroup: lane l of warp w holds keys
  // key_a = k0 + 16 w + l / 4 and key_a + 8 (rows of S^T), and of each
  // query tile the columns 8 j + 2 (l % 4) + {0, 1}
  const int key_a = k0 + 16 * warp + (lane >> 2);
  const int c = lane & 3;
  const float inv_scale = __frcp_rn(scale_div);
  const int pow2 = (__float_as_uint(scale_div) & 0x007fffffu) == 0u;
  const float sc = pow2 ? inv_scale : 1.f;
  const uint32_t k_base = smem_u32(k_smem);
  const uint32_t v_base = smem_u32(v_smem);
  chana_tma::mbar_wait(&own_full, 0);

  float s[32], dp[32];
  float dk[kAtoms][32], dv[kVAtoms][32];
  uint32_t pw[4][4], pd[4][4];  // W^T's and dlog^T's k16 slices
  // stage idx's S^T = K Q^T (and dP^T = V dout^T when the pass makes dk)
  auto issue_s = [&](auto o, int idx) {
    constexpr bool kDK = decltype(o)::kDK;
    const int slot = idx % S::kStages;
    chana_tma::mbar_wait(&full[slot], (idx / S::kStages) & 1);
    const uint32_t base = smem_u32(ring + slot * S::kDkvStage);
    fence_acc(s);
    if constexpr (kDK) fence_acc(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * kAtoms; ++kk) {
      const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
      wgmma_m64n64k16<0, 0>(s, sw128_desc(k_base + off),
                            sw128_desc(base + off), kk > 0);
    }
    if constexpr (kDK) {
#pragma unroll
      for (int kk = 0; kk < 4 * kVAtoms; ++kk) {
        const uint32_t off = (kk >> 2) * kAtomBytes + (kk & 3) * 32;
        wgmma_m64n64k16<0, 0>(dp, sw128_desc(v_base + off),
                              sw128_desc(base + S::kQBytes + off), kk > 0);
      }
    }
    wgmma_commit();
  };
  // dV += W^T . dout and dK += dlog^T . Q over stage idx (dout and Q from
  // shared memory, N-major)
  auto issue_out = [&](auto o, int idx) {
    constexpr bool kDV = decltype(o)::kDV;
    constexpr bool kDK = decltype(o)::kDK;
    const uint32_t base = smem_u32(ring + (idx % S::kStages) * S::kDkvStage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (kDV) {
#pragma unroll
        for (int a = 0; a < kVAtoms; ++a) {
          wgmma_m64n64k16_rs<1>(
              dv[a], pw[kk],
              sw128_desc(base + S::kQBytes + a * kAtomBytes + kk * 16 * 128));
        }
      }
      if constexpr (kDK) {
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
          wgmma_m64n64k16_rs<1>(
              dk[a], pd[kk],
              sw128_desc(base + a * kAtomBytes + kk * 16 * 128));
        }
      }
    }
    wgmma_commit();
  };
  // stage idx's y into s and (for dk) dlog, before its rounding, into dp,
  // column by column from the stage's m, l and D of each query; zero where
  // the key is past the query or the query past T (only the diagonal tile
  // and one past T are masked value by value)
  auto grads = [&](auto o, int idx) {
    constexpr bool kDK = decltype(o)::kDK;
    const float* const sm = reinterpret_cast<const float*>(
        ring + (idx % S::kStages) * S::kDkvStage + S::kQBytes + S::kVBytes);
    const int q0 = (kb + idx % tiles) * kRows;
    const bool edge = q0 == k0 || q0 + kRows > T;
    int p2 = pow2;
    asm volatile("" : "+r"(p2));  // branches here, not copies of the loop
    wg_bwd::to_logits(s, p2, scale_div, inv_scale);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int query = q0 + 8 * (e >> 2) + 2 * c + (e & 1);
        if (key_a + 8 * ((e >> 1) & 1) > query || query >= T) {
          s[e] = neg_inf();
        }
      }
    }
    // value e = 4 j + 2 r + cc: key row r, query column 8 j + 2 c + cc
    int slow = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float m = sm[8 * j + 2 * c + cc];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 4 * j + 2 * r + cc;
          s[e] = expf(fmaf(s[e], sc, -m));
          slow |= s[e] != 0.f && s[e] < kQuotientLeast;
        }
      }
    }
    if (slow) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float l = sm[kRows + 8 * j + 2 * c + cc];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + cc;
            s[e] = chana_att::divide(s[e], l);
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float l = sm[kRows + 8 * j + 2 * c + cc];
          const float rl = __frcp_rn(l);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + cc;
            s[e] = quotient_rn(s[e], l, rl);
          }
        }
      }
    }
    if constexpr (kDK) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float d = sm[2 * kRows + 8 * j + 2 * c + cc];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 4 * j + 2 * r + cc;
            const float dw = chana_att::round_bf16(dp[e]);
            dp[e] = s[e] * dw - s[e] * d;
          }
        }
      }
      wg_bwd::over_scale(dp, p2, scale_div, inv_scale);
    }
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int query = q0 + 8 * (e >> 2) + 2 * c + (e & 1);
        if (key_a + 8 * ((e >> 1) & 1) > query || query >= T) {
          s[e] = 0.f;
          if constexpr (kDK) dp[e] = 0.f;
        }
      }
    }
  };
  auto pack = [&](auto o) {
    if constexpr (decltype(o)::kDV) wg_bwd::pack_a(pw, s);
    if constexpr (decltype(o)::kDK) wg_bwd::pack_a(pd, dp);
  };

  const size_t ld = (size_t)3 * H * HD;  // dqkv's row
  const int D = H * HD;
  __nv_bfloat16* const dst = dqkv + (size_t)b * T * ld + (size_t)h * HD;
  // One pass over the query tiles (stages first .. first + tiles - 1):
  // a stage's S^T (and dP^T) is issued with the last stage's output
  // products, its softmax work runs while those do, and it is packed once
  // they have finished; then the pass's outputs, rounded once.
  auto pass = [&](auto o, int first) {
    constexpr bool kDV = decltype(o)::kDV;
    constexpr bool kDK = decltype(o)::kDK;
    if constexpr (kDV) {
#pragma unroll
      for (int a = 0; a < kVAtoms; ++a) {
#pragma unroll
        for (int e = 0; e < 32; ++e) dv[a][e] = 0.f;
      }
    }
    if constexpr (kDK) {
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[a][e] = 0.f;
      }
    }
    issue_s(o, first);
    wgmma_wait<0>();
    fence_acc(s);
    if constexpr (kDK) fence_acc(dp);
    grads(o, first);
    pack(o);
    for (int t = 1; t < tiles; ++t) {
      issue_s(o, first + t);
      issue_out(o, first + t - 1);
      wgmma_wait<1>();
      fence_acc(s);
      if constexpr (kDK) fence_acc(dp);
      grads(o, first + t);
      wgmma_wait<0>();
      // the last stage's q and dout tiles are read
      if (lane == 0) chana_tma::mbar_arrive(&empty[(first + t - 1) % S::kStages]);
      pack(o);
    }
    issue_out(o, first + tiles - 1);
    wgmma_wait<0>();
    if (lane == 0) chana_tma::mbar_arrive(&empty[(first + tiles - 1) % S::kStages]);
    if constexpr (kDV) {
#pragma unroll
      for (int a = 0; a < kVAtoms; ++a) fence_acc(dv[a]);
    }
    if constexpr (kDK) {
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) fence_acc(dk[a]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_a + 8 * r;
      if (key >= T) continue;
      __nv_bfloat16* const row = dst + (size_t)key * ld;
      if constexpr (kDV) {
#pragma unroll
        for (int a = 0; a < kVAtoms; ++a) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * a + 8 * j + 2 * c;
            if (col < HDV) {
              *reinterpret_cast<uint32_t*>(row + 2 * D + col) =
                  pack_bf16(dv[a][4 * j + 2 * r], dv[a][4 * j + 2 * r + 1]);
            }
          }
        }
        // a v head wider than its values (latent attention's): zeros
        for (int col = HDV + 2 * c; col < HD; col += 8) {
          *reinterpret_cast<uint32_t*>(row + 2 * D + col) = 0u;
        }
      }
      if constexpr (kDK) {
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * a + 8 * j + 2 * c;
            if (col < HD) {
              *reinterpret_cast<uint32_t*>(row + D + col) =
                  pack_bf16(dk[a][4 * j + 2 * r], dk[a][4 * j + 2 * r + 1]);
            }
          }
        }
      }
    }
  };
  if constexpr (S::kTwoPass) {
    pass(wg_bwd::Outputs<true, false>{}, 0);
    pass(wg_bwd::Outputs<false, true>{}, tiles);
  } else {
    pass(wg_bwd::Outputs<true, true>{}, 0);
  }
}

// -- host side of the long-window backward ------------------------------------

// Shared memory of the query-major kernel (dkv false) or the key-major one
// (dkv true) for q and k heads of width HD and v heads of width HDV; 0
// where the pair takes no such widths (the warpgroup forward's: one width,
// a multiple of 16 up to 128, or latent attention's 192 and 128).
size_t bwd_warpgroup_smem(int HD, int HDV, bool dkv) {
  using wg_bwd::Shape;
  if (HD == 192 && HDV == 128) {
    return dkv ? Shape<3, 2>::kDkvSmem : Shape<3, 2>::kDqSmem;
  }
  if (HDV != HD || HD < 16 || HD > 128 || HD % 16 != 0) return 0;
  if (HD > 64) return dkv ? Shape<2, 2>::kDkvSmem : Shape<2, 2>::kDqSmem;
  return dkv ? Shape<1, 1>::kDkvSmem : Shape<1, 1>::kDqSmem;
}

// The map of stats, float32 [3][BH][stat_rows] (the planes m, l and the
// backward's D): boxes of 64 rows of one (b, h) in all three planes, zeros
// past stat_rows.
cudaError_t encode_stats(CUtensorMap* map, const void* stats, int BH,
                         int stat_rows) {
  const chana_tma::EncodeTiled fn = chana_tma::encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)stat_rows, (cuuint64_t)BH, 3};
  const cuuint64_t strides[2] = {(cuuint64_t)stat_rows * 4,
                                 (cuuint64_t)BH * stat_rows * 4};
  const cuuint32_t box[3] = {(cuuint32_t)wg_att::kRows, 1, 3};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<void*>(stats), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct BwdCall {
  CUtensorMap qkv, dout, stats;
  const __nv_bfloat16* dout_p;
  const __nv_bfloat16* out_p;
  float* stats_p;
  __nv_bfloat16* dqkv;
  int T, H, HD, HDV, BH, stat_rows, blocks;
  size_t smem;
  float scale_div;
  cudaStream_t stream;
};

// What both launchers check and bind: the shape, the shared memory the
// wrapper passes (this file's, or refused), and the tensor maps (stats'
// for the key-major kernel alone).
cudaError_t bwd_call(BwdCall* c, const void* qkv, const void* dout,
                     void* stats, void* dqkv, int B, int T, int H, int HD,
                     int HDV, int stat_rows, size_t smem, bool dkv,
                     float scale_div, void* stream) {
  const size_t need = bwd_warpgroup_smem(HD, HDV, dkv);
  const int rows = wg_att::kRows;
  if (B <= 0 || T <= 0 || H <= 0 || need == 0 || smem != need ||
      stat_rows != (T + chana_att::kTile - 1) / chana_att::kTile *
                       chana_att::kTile ||
      (long long)B * H * ((T + rows - 1) / rows) > 0x7fffffffLL ||
      (long long)B * H * stat_rows * 4 >= (1ll << 40) ||
      (long long)T * 3 * H * HD * 2 >= (1ll << 40)) {  // TMA's strides
    return cudaErrorInvalidValue;
  }
  memset(c, 0, sizeof(*c));
  cudaError_t err = wg_att::encode_heads(&c->qkv, qkv, B, T, 3 * H, HD);
  if (err == cudaSuccess) {
    err = wg_att::encode_heads(&c->dout, dout, B, T, H, HDV);
  }
  if (err == cudaSuccess && dkv) {
    err = encode_stats(&c->stats, stats, B * H, stat_rows);
  }
  if (err != cudaSuccess) return err;
  c->dout_p = (const __nv_bfloat16*)dout;
  c->stats_p = (float*)stats;
  c->dqkv = (__nv_bfloat16*)dqkv;
  c->T = T;
  c->H = H;
  c->HD = HD;
  c->HDV = HDV;
  c->BH = B * H;
  c->stat_rows = stat_rows;
  c->blocks = B * H * ((T + rows - 1) / rows);
  c->smem = smem;
  c->scale_div = scale_div;
  c->stream = (cudaStream_t)stream;
  return cudaSuccess;
}

template <int kAtoms, int kVAtoms>
cudaError_t launch_bwd_dq(const BwdCall& c) {
  using S = wg_bwd::Shape<kAtoms, kVAtoms>;
  static size_t allowed[chana_att::kMaxDevices] = {};
  const cudaError_t err = chana_att::allow_smem(
      (const void*)causal_attention_bwd_dq_kernel<kAtoms, kVAtoms>, c.smem,
      allowed);
  if (err != cudaSuccess) return err;
  causal_attention_bwd_dq_kernel<kAtoms, kVAtoms>
      <<<c.blocks, S::kThreads, c.smem, c.stream>>>(
          c.qkv, c.dout, c.dout_p, c.out_p, c.stats_p, c.dqkv, c.T, c.H,
          c.HD, c.HDV, c.BH, c.stat_rows, c.scale_div);
  return cudaSuccess;
}

template <int kAtoms, int kVAtoms>
cudaError_t launch_bwd_dkv(const BwdCall& c) {
  using S = wg_bwd::Shape<kAtoms, kVAtoms>;
  static size_t allowed[chana_att::kMaxDevices] = {};
  const cudaError_t err = chana_att::allow_smem(
      (const void*)causal_attention_bwd_dkv_kernel<kAtoms, kVAtoms>, c.smem,
      allowed);
  if (err != cudaSuccess) return err;
  causal_attention_bwd_dkv_kernel<kAtoms, kVAtoms>
      <<<c.blocks, S::kThreads, c.smem, c.stream>>>(
          c.qkv, c.dout, c.stats, c.dqkv, c.T, c.H, c.HD, c.HDV, c.BH,
          c.scale_div);
  return cudaSuccess;
}

// -- tanh-GELU backward -----------------------------------------------------
//
// dx = bf16(dy * (0.5 (1 + tanh u) + 0.5 x (1 - tanh^2 u) k (1 + 3 a x^2))),
// u = k (x + a x^3), k = sqrt(2/pi), a = 0.044715, in float32: the
// derivative of jax.nn.gelu's tanh form, rounded once. 8 values a thread
// from one 16-byte load of each input; the tail one value at a time.

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float a = 0.044715f;  // 3 a = 0.134145
  const float x2 = x * x;
  const float t = tanhf(k * (x + a * (x2 * x)));
  return 0.5f * (1.0f + t) +
         0.5f * x * (1.0f - t * t) * k * (1.0f + 0.134145f * x2);
}

__global__ void __launch_bounds__(CHANA_GELU_THREADS) gelu_tanh_bwd_kernel(
    const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ x,
    __nv_bfloat16* __restrict__ dx, long long N) {
  const long long base =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (base + 8 <= N) {
    const uint4 rx = *reinterpret_cast<const uint4*>(x + base);
    const uint4 rd = *reinterpret_cast<const uint4*>(dy + base);
    const uint32_t wx[4] = {rx.x, rx.y, rx.z, rx.w};
    const uint32_t wd[4] = {rd.x, rd.y, rd.z, rd.w};
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 fx = pair_to_float2(wx[k]);
      const float2 fd = pair_to_float2(wd[k]);
      o[k] = float2_to_pair(fd.x * gelu_tanh_grad(fx.x),
                            fd.y * gelu_tanh_grad(fx.y));
    }
    *reinterpret_cast<uint4*>(dx + base) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    for (long long n = base; n < N; ++n) {
      dx[n] = __float2bfloat16_rn(__bfloat162float(dy[n]) *
                                  gelu_tanh_grad(__bfloat162float(x[n])));
    }
  }
}

// -- clip + momentum + SGD --------------------------------------------------
//
// Over every parameter tensor t (float32 p, m, g of n[t] values):
//   sq = sum over all tensors of sum g^2                 (launch 1)
//   s  = min(1, clip * rsqrt(sq + 1e-12))     (no clip: s = 1; launch 2 ...)
//   m  = 0.9 m + g * s,  p = p - lr * m      (... in place, each op rounded
//        as written: __fmul_rn / __fadd_rn keep nvcc from fusing them)
// The tensors come as a table of pointers and sizes passed by value; block
// k takes 4096 values of the tensor whose block range holds k. Launch 1
// writes one partial sum a block and its last block sums them in block
// order into sq; launch 2 reads sq on the device, so the step needs no host
// sync, and block 0 also writes s. The two launches take any tables: a
// sharded step sums its sharded and its replicated gradients apart, adds
// the first over its tensor-parallel ranks, and gives launch 2 the total.

struct TensorTable {
  float* p[CHANA_UPD_MAX_TENSORS];
  float* m[CHANA_UPD_MAX_TENSORS];
  const float* g[CHANA_UPD_MAX_TENSORS];
  long long n[CHANA_UPD_MAX_TENSORS];
  int first_block[CHANA_UPD_MAX_TENSORS + 1];
  int count;
};

__device__ __forceinline__ int tensor_of_block(const TensorTable& tab,
                                               int blk) {
  int t = 0;
  while (t + 1 < tab.count && tab.first_block[t + 1] <= blk) ++t;
  return t;
}

__global__ void __launch_bounds__(CHANA_UPD_THREADS) sumsq_kernel(
    const TensorTable tab, float* __restrict__ partial,
    float* __restrict__ sq, unsigned int* __restrict__ counter) {
  __shared__ float scratch[CHANA_UPD_THREADS / 32];
  const int t = tensor_of_block(tab, blockIdx.x);
  const long long base =
      (long long)(blockIdx.x - tab.first_block[t]) * CHANA_UPD_CHUNK;
  const float* g = tab.g[t];
  const long long n = tab.n[t];
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < CHANA_UPD_PER_THREAD; ++k) {
    const long long idx = base + (long long)k * CHANA_UPD_THREADS + threadIdx.x;
    if (idx < n) {
      const float v = g[idx];
      acc = fmaf(v, v, acc);
    }
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
  if (last_of(counter, gridDim.x)) {
    float s = 0.f;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
      s += __ldcg(partial + b);
    }
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) {
      sq[0] = s;
      *counter = 0u;  // ready for the next launch
    }
  }
}

__global__ void __launch_bounds__(CHANA_UPD_THREADS) momentum_sgd_kernel(
    const TensorTable tab, const float* __restrict__ sq,
    float* __restrict__ scale_out, float clip, int has_clip, float lr,
    float beta) {
  float s = 1.0f;
  if (has_clip) {
    s = fminf(1.0f, __fmul_rn(clip, __frsqrt_rn(__fadd_rn(sq[0], 1e-12f))));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[0] = s;
  const int t = tensor_of_block(tab, blockIdx.x);
  const long long base =
      (long long)(blockIdx.x - tab.first_block[t]) * CHANA_UPD_CHUNK;
  float* p = tab.p[t];
  float* m = tab.m[t];
  const float* g = tab.g[t];
  const long long n = tab.n[t];
#pragma unroll 4
  for (int k = 0; k < CHANA_UPD_PER_THREAD; ++k) {
    const long long idx = base + (long long)k * CHANA_UPD_THREADS + threadIdx.x;
    if (idx < n) {
      const float gs = __fmul_rn(g[idx], s);
      const float mm = __fadd_rn(__fmul_rn(beta, m[idx]), gs);
      m[idx] = mm;
      p[idx] = __fsub_rn(p[idx], __fmul_rn(lr, mm));
    }
  }
}

bool fill_table(TensorTable* tab, void* const* p, void* const* m,
                const void* const* g, const long long* n, int count,
                int* blocks) {
  if (count <= 0 || count > CHANA_UPD_MAX_TENSORS) return false;
  long long total = 0;
  for (int t = 0; t < count; ++t) {
    if (n[t] <= 0 || !p[t] || !m[t] || !g[t]) return false;
    tab->p[t] = (float*)p[t];
    tab->m[t] = (float*)m[t];
    tab->g[t] = (const float*)g[t];
    tab->n[t] = n[t];
    tab->first_block[t] = (int)total;
    total += (n[t] + CHANA_UPD_CHUNK - 1) / CHANA_UPD_CHUNK;
    if (total > 0x7fffffffLL) return false;
  }
  tab->first_block[count] = (int)total;
  tab->count = count;
  *blocks = (int)total;
  return true;
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// (0 = launched). The Python wrapper checks dtypes, shapes, contiguity and
// 16-byte alignment, and allocates the outputs and the scratch (partial
// sums and a zeroed counter, which the kernels leave zero); the checks
// here refuse what the kernels cannot take.

// The layernorm geometry for R rows of width D (layernorm_rows.cuh) as
// five ints; 0 when the shape is refused.
int chana_layernorm_geometry(int R, int D, int* out) {
  return chana_ln::geometry_ints(R, D, out);
}

// grid blocks of kWarps warps in clusters of cluster blocks, one row a
// warp. The wrapper passes the geometry (kernels/forecaster.py's
// layernorm_geometry); a mismatch with this file's is refused. partial
// holds a row of D floats for each cluster (unused with one cluster);
// counter is zero before the launch and is left zero after it.
int chana_layernorm_bwd(const void* dy, const void* x, const void* scale,
                        void* dx, void* partial, void* dscale, void* counter,
                        int R, int D, float eps, int blocks, int cluster,
                        int grid, int smem, void* stream) {
  chana_ln::Geometry g;
  if (!chana_ln::geometry(R, D, &g) || blocks != g.blocks ||
      cluster != g.cluster || grid != g.grid || smem != g.smem) {
    return (int)cudaErrorInvalidValue;
  }
  const LayerNormBwdFn fn = layernorm_bwd_fn(g.chunks);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (g.smem > chana_ln::kSmemNoOptIn) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.grid);
  cfg.blockDim = dim3(chana_ln::kThreads);
  cfg.dynamicSmemBytes = (size_t)g.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fn, (const __nv_bfloat16*)dy, (const __nv_bfloat16*)x,
      (const float*)scale, (__nv_bfloat16*)dx, (float*)partial,
      (float*)dscale, (unsigned int*)counter, R, D, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Dynamic shared memory the attention backward's main kernel needs for T
// rows of head width HD (0 when the shape is refused).
size_t chana_causal_attention_bwd_smem(int T, int HD) {
  chana_att::Geometry g;
  return chana_att::geometry(T, HD, &g) ? g.bwd_smem : 0;
}

// ... and its row pass.
size_t chana_causal_attention_bwd_stats_smem(int T, int HD) {
  chana_att::Geometry g;
  return chana_att::geometry(T, HD, &g) ? g.stats_smem : 0;
}

// The 16-row backward (under T = 128, or at widths the long-window pair
// does not take) is two launches of B * H * tiles blocks of kWarps warps:
// the row pass (chana_causal_attention_bwd_stats), which reads each row's
// max and sum from `stats` (float32 [3][B * H * tiles * 16], the first
// two planes written by the forward, chana_causal_attention, for this
// qkv) and writes its sum_j u_j into the third, then the main kernel
// (chana_causal_attention_bwd), which reads all three. The wrapper passes
// the geometry (kernels/forecaster.py's attention_geometry); a mismatch
// with this file's is refused.
static bool bwd_geometry_ok(int B, int T, int H, int HD, int HDP, int ld,
                            int tiles, int bytes, int stage, int slots,
                            size_t smem, bool stats_pass) {
  chana_att::Geometry g;
  return B > 0 && H > 0 && chana_att::geometry(T, HD, &g) &&
         chana_att::geometry_matches(g, HDP, ld, tiles, bytes, stage,
                                     slots) &&
         smem == (stats_pass ? g.stats_smem : g.bwd_smem) &&
         smem <= chana_att::kSmemLimit &&
         (long long)B * H * tiles * chana_att::kTile <= 0x7fffffffLL;
}

int chana_causal_attention_bwd_stats(const void* qkv, const void* dout,
                                     void* stats, int B, int T, int H,
                                     int HD, int HDP, int ld, int tiles,
                                     int bytes, int stage, int slots,
                                     size_t smem, float scale_div,
                                     void* stream) {
  if (!bwd_geometry_ok(B, T, H, HD, HDP, ld, tiles, bytes, stage, slots,
                       smem, true)) {
    return (int)cudaErrorInvalidValue;
  }
  static size_t allowed[chana_att::kMaxDevices] = {};
  const cudaError_t err = chana_att::allow_smem(
      (const void*)causal_attention_bwd_stats_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  causal_attention_bwd_stats_kernel<<<B * H * tiles, chana_att::kWarps * 32,
                                      smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (const __nv_bfloat16*)dout, (float*)stats,
      T, H, HD, HDP, ld, tiles, bytes, stage, slots, scale_div);
  return (int)cudaGetLastError();
}

// warps: 8 (each half of the kernel on its own four warps; two blocks an
// SM) or 4 (every warp on both halves; four blocks an SM). The wrapper
// takes 8 when the grid fits two blocks an SM at once.
int chana_causal_attention_bwd(const void* qkv, const void* dout,
                               const void* stats, void* dqkv, int B, int T,
                               int H, int HD, int HDP, int ld, int tiles,
                               int bytes, int stage, int slots, size_t smem,
                               int warps, float scale_div, void* stream) {
  if (!bwd_geometry_ok(B, T, H, HD, HDP, ld, tiles, bytes, stage, slots,
                       smem, false)) {
    return (int)cudaErrorInvalidValue;
  }
  if (warps != chana_att::kWarps && warps != 2 * chana_att::kWarps) {
    return (int)cudaErrorInvalidValue;
  }
  static size_t allowed[2][chana_att::kMaxDevices] = {};
  const auto kernel = warps == chana_att::kWarps
                          ? causal_attention_bwd_kernel<chana_att::kWarps>
                          : causal_attention_bwd_kernel<2 * chana_att::kWarps>;
  const cudaError_t err = chana_att::allow_smem(
      (const void*)kernel, smem, allowed[warps == chana_att::kWarps ? 0 : 1]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H * tiles, warps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (const __nv_bfloat16*)dout,
      (const float*)stats, (__nv_bfloat16*)dqkv, T, H, HD, HDP, ld, tiles,
      bytes, stage, slots, scale_div);
  return (int)cudaGetLastError();
}

// The long-window pair (from T = 128 at the warpgroup forward's widths;
// kernels/forecaster.py's attention_warpgroup_geometry): shared memory of
// the query-major kernel (dkv = 0) or the key-major one (dkv = 1) for q
// and k heads of width HD and v heads of width HDV, 0 where refused.
size_t chana_causal_attention_bwd_warpgroup_smem(int HD, int HDV, int dkv) {
  return bwd_warpgroup_smem(HD, HDV, dkv != 0);
}

// The query-major kernel, B * H * ceil(T / 64) blocks of 64 query rows:
// D = dout . out of every row into the third plane of `stats` (whose first
// two the forward wrote, as for chana_causal_attention_bwd_stats;
// stat_rows = T rounded up to 16), then dq into dqkv. dout and out are
// [B, T, H HDV]; q and k are H heads HD wide in qkv, v H heads HD wide of
// which the kernels read the first HDV columns (HDV = HD, or 128 at HD =
// 192). The wrapper passes shared memory from its geometry; a value that
// differs from this file's is refused.
int chana_causal_attention_bwd_dq(const void* qkv, const void* dout,
                                  const void* out, void* stats, void* dqkv,
                                  int B, int T, int H, int HD, int HDV,
                                  int stat_rows, size_t smem,
                                  float scale_div, void* stream) {
  BwdCall call;
  cudaError_t err = bwd_call(&call, qkv, dout, stats, dqkv, B, T, H, HD, HDV,
                             stat_rows, smem, false, scale_div, stream);
  if (err != cudaSuccess) return (int)err;
  call.out_p = (const __nv_bfloat16*)out;
  err = HDV != HD  ? launch_bwd_dq<3, 2>(call)
        : HD > 64 ? launch_bwd_dq<2, 2>(call)
                  : launch_bwd_dq<1, 1>(call);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The key-major kernel, launched after the query-major one on the same
// stream (it reads D): B * H * ceil(T / 64) blocks of 64 key rows, dk and
// dv into dqkv (a v head's columns from HDV to HD zero).
int chana_causal_attention_bwd_dkv(const void* qkv, const void* dout,
                                   const void* stats, void* dqkv, int B,
                                   int T, int H, int HD, int HDV,
                                   int stat_rows, size_t smem,
                                   float scale_div, void* stream) {
  BwdCall call;
  cudaError_t err = bwd_call(&call, qkv, dout, const_cast<void*>(stats),
                             dqkv, B, T, H, HD, HDV, stat_rows, smem, true,
                             scale_div, stream);
  if (err != cudaSuccess) return (int)err;
  err = HDV != HD  ? launch_bwd_dkv<3, 2>(call)
        : HD > 64 ? launch_bwd_dkv<2, 2>(call)
                  : launch_bwd_dkv<1, 1>(call);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int chana_gelu_tanh_bwd(const void* dy, const void* x, void* dx, long long N,
                        void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const long long threads = (N + 7) / 8;
  const long long blocks =
      (threads + CHANA_GELU_THREADS - 1) / CHANA_GELU_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gelu_tanh_bwd_kernel<<<(unsigned)blocks, CHANA_GELU_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)dy, (const __nv_bfloat16*)x, (__nv_bfloat16*)dx,
      N);
  return (int)cudaGetLastError();
}

int chana_update_max_tensors(void) { return CHANA_UPD_MAX_TENSORS; }

// Blocks the update takes (one partial sum each) for these tensor sizes;
// 0 when the table is refused.
int chana_update_blocks(const long long* n, int count) {
  if (count <= 0 || count > CHANA_UPD_MAX_TENSORS) return 0;
  long long total = 0;
  for (int t = 0; t < count; ++t) {
    if (n[t] <= 0) return 0;
    total += (n[t] + CHANA_UPD_CHUNK - 1) / CHANA_UPD_CHUNK;
  }
  return total > 0x7fffffffLL ? 0 : (int)total;
}

// Launch 1: sq[0] = the sum of every g^2 (partial: one float a block,
// counter: one unsigned int, zero before the first launch; the last
// block sets it back to zero).
int chana_sumsq(const void* const* g, const long long* n, int count,
                void* partial, void* sq, void* counter, void* stream) {
  TensorTable tab;
  int blocks = 0;
  // p and m are not read here: g stands in so the table checks pass
  if (!fill_table(&tab, (void* const*)g, (void* const*)g, g, n, count,
                  &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  sumsq_kernel<<<blocks, CHANA_UPD_THREADS, 0, (cudaStream_t)stream>>>(
      tab, (float*)partial, (float*)sq, (unsigned int*)counter);
  return (int)cudaGetLastError();
}

// Launch 2: the clipped momentum SGD update in place; scale_out[0] = s.
int chana_momentum_sgd(void* const* p, void* const* m, const void* const* g,
                       const long long* n, int count, const void* sq,
                       void* scale_out, float clip, int has_clip, float lr,
                       float beta, void* stream) {
  TensorTable tab;
  int blocks = 0;
  if (!fill_table(&tab, p, m, g, n, count, &blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  momentum_sgd_kernel<<<blocks, CHANA_UPD_THREADS, 0, (cudaStream_t)stream>>>(
      tab, (const float*)sq, (float*)scale_out, clip, has_clip, lr, beta);
  return (int)cudaGetLastError();
}

const char* chana_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
