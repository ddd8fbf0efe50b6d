// The forecaster's matrix products for Hopper (sm_90a), forward and
// gradients: kernel 1 the bf16 products on the tensor cores (wgmma), with
// the GELU and residual adds in their epilogue, kernel 2 the float32 head
// on the CUDA cores.
//
// What they replace. chanamq_tpu/models/forecaster.py's einsums, which the
// reference leaves to XLA inside its jitted forward and step: the embed
// (forecaster.py:106), each layer's qkv (:88) and proj (:100) with the
// residual add after it (:112), w1 (:115) with jax.nn.gelu after it
// (:116), w2 (:117) with its residual add (:118), the float32 head
// (:120), and the gradients of each that jax.value_and_grad takes in the
// train step (:141): dX = dY W^T and dW = X^T dY.
//
// What each computes, at the reference's rounding points. Kernel 1: C = A B
// from bf16 operands, every product exact in float32 and summed in
// float32, rounded to bf16 once; then the epilogue: none; GELU (the tanh
// form of gelu.cuh on the rounded value, rounded again; in training the
// rounded value is also written out for the backward); or a residual add
// (the rounded value plus a bf16 residual, added in float32 and rounded
// again), as the reference's bf16 einsum and `h +` round. Kernel 2: the
// same product in float32 on float32 operands with fused multiply-adds, no
// TF32 (the reference's head is a float32 product).
//
// Layouts. The forward is (A, B): A [M][K], B [K][N] (the weights' [in,
// out] layout). dX = dY W^T is (A, B^T): B stored [N][K]. dW = X^T dY is
// (A^T, B): A stored [K][M], the sum over the rows of the batch. Each is a
// template instance of one kernel, the layout a pair of flags.
//
// What bounds them on this card. At the forecaster's shapes (T = 64,
// d_model 256, d_ff 1024, batch 1 to 32) every site is bound by bytes:
// 0.01 to 3 us of reads and writes at 3.35 TB/s, under or near the
// 1.846 us of an empty launch at batch 1 (chip_smoke.py's [floor]). A
// first version (mma.sync on 64 x 64 tiles, one block walking all of K
// through two cp.async slots 32 deep) took about 2.6 us plus 0.33 us for
// every 32-deep step, whatever the grid: each step waited for one round
// trip to L2 or device memory with one tile in flight, and most SMs were
// idle (4 blocks for w2 at batch 1, 48 to 64 for the weight gradients,
// whose K is the batch's B * T rows). The head's forward gave each of its
// B * 8 outputs to one thread: a chain of 256 dependent loads and FMAs.
//
// What this design does about it. Kernel 1 keeps several K tiles in
// flight and spreads K over the card:
// - The tile product is wgmma.mma_async.m64n64k16.f32.bf16.bf16 with both
//   operands in shared memory: one consumer warpgroup takes a 64 x 64
//   output tile, or two take a 128 x 128 tile (kWG; the wrapper's
//   tile_rows takes the larger only where its tiles alone nearly fill the
//   card, for the reuse of each loaded stage). The layouts are wgmma's
//   operand-major bits: A stored [K][M] is M-major (transpose-A), B stored
//   [K][N] is N-major (transpose-B), the others K-major.
// - K arrives 64 deep (128 bytes: one swizzle row) through a ring of
//   kStages stages, each stage's A and B loaded by the tensor memory
//   accelerator (cp.async.bulk.tensor.2d, 128-byte swizzle, zeros past
//   every edge of M, N and K, the embed's K = 8 included) onto the stage's
//   full mbarrier (expect_tx). One producer warp sets up the barriers and
//   issues the first stages before the block barrier, then refills a slot
//   once the consumers release it on its empty mbarrier; the consumers run
//   wgmma on each stage as it lands, leaving one wgmma group in flight.
//   TMA needs rows whose length is a multiple of 16 bytes: an operand
//   stored in rows of a length that is not a multiple of 8 (the embed's K,
//   or its dW's M, at 10 features) is written into the same swizzled
//   layout a value at a time by the producer warp (stage_panel).
// - Split-K over a thread-block cluster. Where the output tiles alone
//   leave the card idle, the S blocks of one tile (S = 2, 4 or 8, chosen
//   by the wrapper's split_k from the shape) form a cluster, each taking a
//   contiguous 1/S of K. Their float32 partial tiles meet in distributed
//   shared memory: rank r owns rows [r T / S, (r + 1) T / S) of the tile,
//   every rank stores those rows of its partial into rank r's receive area
//   (beside the ring, so no rank waits for another's main loop to end
//   before storing), and after one cluster barrier rank r adds the S
//   slices in rank order 0..S-1 and runs the epilogue. No float atomics
//   and no workspace: the same inputs give the same bits. The embed's dW
//   (M = the feature count, 8) takes the same route: its time is in reading
//   B * T rows of dY, not in the tensor cores' work on the padded rows, and
//   split-K spreads those reads over 32 blocks.
// - The epilogue takes 8 columns a thread from the receive area (the whole
//   tile's with S = 1) and stores 16 bytes at a time; an unsplit 64 x 64
//   tile without GELU stores straight from the accumulators instead, a
//   pair at a time, which measured faster there.
// Kernel 2 gives each output of the head's forward (K = d_model) a warp, or
// a group of 8 or 16 lanes at K under 256: lane l sums terms l, l + G, ...
// with fmaf, then a fixed butterfly of __shfl_xor_sync adds the group; the
// gradients' K (8, and the batch) stays one short chain a thread.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "attention_tiles.cuh"
#include "gelu.cuh"
#include "tma_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace chana_tma;
using chana_att::pack_bf16;
using chana_att::round_bf16;
using chana_att::unpack_bf16;

constexpr int kBK = 64;        // depth of a ring stage: one 128-byte row
constexpr int kAtom = 64;      // rows (or columns) of a swizzle atom
constexpr int kAtomBytes = kAtom * kBK * 2;  // 8 KB: 64 rows of 128 bytes
constexpr int kMaxSplits = 8;  // blocks in a cluster (the portable limit)
constexpr int kChunk = 8;      // bf16 values in 16 bytes

// the operands' layouts, as the Python wrapper names them
enum Layout { kNN = 0, kNT = 1, kTN = 2 };
enum Epilogue { kNone = 0, kGelu = 1, kResidual = 2 };

// A block's tile with kWG consumer warpgroups: (64 kWG) x (64 kWG) outputs,
// one producer warp after the consumers.
template <int kWG>
struct Tile {
  static constexpr int kM = 64 * kWG;
  static constexpr int kN = 64 * kWG;
  static constexpr int kNB = kN / 64;  // n64 wgmma column blocks
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kStages = kWG == 1 ? 5 : 4;
  static constexpr int kABytes = kM * kBK * 2;
  static constexpr int kBBytes = kN * kBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kLd = kN + 8;  // floats a row of a partial slice
  // S slices of up to ceil(kM / S) rows each
  static constexpr int kRecvBytes = (kM + kMaxSplits) * kLd * 4;
  // + 1024 bytes to align the ring: two small blocks an SM, one large
  static constexpr int kSmem = kRingBytes + kRecvBytes + 1024;
  // (each block also holds 1 KB of static and 1 KB of reserved memory)
  static_assert(kSmem + 2048 <= (kWG == 1 ? 233472 / 2 : 232448),
                "the blocks an SM takes fit its shared memory");
};

// Rows [r0, r0 + rows) and columns [c0, c0 + 64) of a row-major
// [src_rows][src_cols] matrix into dst in the layout TMA's 128-byte
// swizzle writes (16-byte chunk c of row r at r * 128 + (c ^ r % 8) * 16),
// zeros past the matrix's edges. For a matrix whose rows are not a
// multiple of 16 bytes long, which TMA cannot describe: each value is
// loaded alone. The producer warp's 32 lanes take a chunk each in turn.
__device__ __forceinline__ void stage_panel(uint8_t* dst,
                                            const __nv_bfloat16* src,
                                            int src_rows, int src_cols, int r0,
                                            int c0, int rows, int lane) {
  const auto* s16 = reinterpret_cast<const unsigned short*>(src);
  for (int idx = lane; idx < rows * 8; idx += 32) {
    const int r = idx >> 3;
    const int ch = idx & 7;
    const int row = r0 + r;
    const int col = c0 + ch * kChunk;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < src_rows && col < src_cols) {
      const unsigned short* from = s16 + (size_t)row * src_cols;
#pragma unroll
      for (int e = 0; e < kChunk; e += 2) {
        const uint32_t lo = col + e < src_cols ? from[col + e] : 0u;
        const uint32_t hi = col + e + 1 < src_cols ? from[col + e + 1] : 0u;
        w[e >> 1] = lo | (hi << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The cluster barrier in two halves: arrive (relaxed) early, wait
// (acquire) where the peers are needed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// -- kernel 1: the bf16 product ----------------------------------------------

// The epilogue on kV (2 or 8) neighbouring float32 sums of row-major
// output [.][N] at element o (2 kV bytes aligned): rounded to bf16; then
// GELU (the rounded values also to `preact` when it is not null) or the
// residual added and rounded again (kEpi); one store of 2 kV bytes each.
template <int kW>
__device__ __forceinline__ void load_words(uint32_t (&w)[kW],
                                           const __nv_bfloat16* from) {
  if constexpr (kW == 4) {
    const uint4 q = *reinterpret_cast<const uint4*>(from);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(from);
  }
}

template <int kW>
__device__ __forceinline__ void store_words(__nv_bfloat16* to,
                                            const uint32_t (&w)[kW]) {
  if constexpr (kW == 4) {
    *reinterpret_cast<uint4*>(to) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint32_t*>(to) = w[0];
  }
}

template <int kEpi, int kV>
__device__ __forceinline__ void epilogue(const float (&v)[kV], size_t o,
                                         __nv_bfloat16* __restrict__ out,
                                         const __nv_bfloat16* __restrict__ res,
                                         __nv_bfloat16* __restrict__ preact) {
  constexpr int kW = kV / 2;
  static_assert(kW == 1 || kW == 4, "pairs or 8 values");
  uint32_t h[kW], w[kW], p[kW];
  if (kEpi == kResidual) load_words<kW>(h, res + o);
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const float r0 = round_bf16(v[2 * i]);
    const float r1 = round_bf16(v[2 * i + 1]);
    if (kEpi == kGelu) {
      p[i] = pack_bf16(r0, r1);
      w[i] = pack_bf16(chana_gelu::gelu_tanh_f(r0),
                       chana_gelu::gelu_tanh_f(r1));
    } else if (kEpi == kResidual) {
      const float2 x = unpack_bf16(h[i]);
      w[i] = pack_bf16(x.x + r0, x.y + r1);
    } else {
      w[i] = pack_bf16(r0, r1);
    }
  }
  store_words<kW>(out + o, w);
  if (kEpi == kGelu && preact != nullptr) store_words<kW>(preact + o, p);
}

// C [M][N] = op(A) op(B), bf16 out, with the epilogue kEpi (kNN only):
// kGelu writes gelu(bf16(C)) and, when `preact` is not null, bf16(C) to
// it; kResidual writes bf16(residual + bf16(C)). Grid: x over M tiles
// times `splits` (the blocks of one tile adjacent, a cluster when splits >
// 1), y over N tiles. tma_a / tma_b: the operand comes by TMA through its
// map, else through stage_panel.
template <bool kTransA, bool kTransB, int kEpi, int kWG>
__global__ void __launch_bounds__(Tile<kWG>::kThreads, 1)
    bf16_product_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b,
                        __nv_bfloat16* __restrict__ out,
                        const __nv_bfloat16* __restrict__ residual,
                        __nv_bfloat16* __restrict__ preact, int M, int N,
                        int K, int splits, int tma_a, int tma_b) {
  using T = Tile<kWG>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[T::kStages];
  __shared__ __align__(8) uint64_t empty[T::kStages];
  uint8_t* const ring =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const int split = (int)blockIdx.x % splits;
  const int m0 = ((int)blockIdx.x / splits) * T::kM;
  const int n0 = (int)blockIdx.y * T::kN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int t0 = split * k_tiles / splits;
  const int count = (split + 1) * k_tiles / splits - t0;
  const int warp = (int)threadIdx.x >> 5;
  const int lane = (int)threadIdx.x & 31;
  const bool producer = warp == 4 * kWG;

  // stage i of this block's K range into slot i % kStages (the producer
  // warp; for i >= kStages once the consumers have released the slot)
  auto produce = [&](int i) {
    const int slot = i % T::kStages;
    uint8_t* const sa = ring + slot * T::kStageBytes;
    uint8_t* const sb = sa + T::kABytes;
    const int k0 = (t0 + i) * kBK;
    if (!tma_a || !tma_b) {
      if (!tma_a) {
        if (kTransA) {  // [K][M]: a 64-column atom a warpgroup
          for (int w = 0; w < kWG; ++w) {
            stage_panel(sa + w * kAtomBytes, a, K, M, k0, m0 + kAtom * w,
                        kAtom, lane);
          }
        } else {  // [M][K]
          stage_panel(sa, a, M, K, m0, k0, T::kM, lane);
        }
      }
      if (!tma_b) {
        if (kTransB) {  // [N][K]
          stage_panel(sb, b, N, K, n0, k0, T::kN, lane);
        } else {  // [K][N]: a 64-column atom a column block
          for (int nb = 0; nb < T::kNB; ++nb) {
            stage_panel(sb + nb * kAtomBytes, b, K, N, k0, n0 + kAtom * nb,
                        kAtom, lane);
          }
        }
      }
      // the generic proxy's writes, visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
    }
    if (lane == 0) {
      const uint32_t tx =
          (tma_a ? T::kABytes : 0) + (tma_b ? T::kBBytes : 0);
      if (tx == 0) {
        mbar_arrive(&full[slot]);
      } else {
        mbar_expect_tx(&full[slot], tx);
      }
      if (tma_a) {
        if (kTransA) {
          for (int w = 0; w < kWG; ++w) {
            tma_load(sa + w * kAtomBytes, &map_a, &full[slot],
                     m0 + kAtom * w, k0);
          }
        } else {
          tma_load(sa, &map_a, &full[slot], k0, m0);
        }
      }
      if (tma_b) {
        if (kTransB) {
          tma_load(sb, &map_b, &full[slot], k0, n0);
        } else {
          for (int nb = 0; nb < T::kNB; ++nb) {
            tma_load(sb + nb * kAtomBytes, &map_b, &full[slot],
                     n0 + kAtom * nb, k0);
          }
        }
      }
    }
    __syncwarp();
  };

  if (splits > 1) cluster_arrive_relaxed();  // waited for before the sums

  // the producer sets up the barriers and fills the ring's first stages
  // while the consumers wait at the block barrier
  const int first = count < T::kStages ? count : T::kStages;
  if (producer) {
    if (lane == 0) {
      if (tma_a) tma_prefetch(&map_a);
      if (tma_b) tma_prefetch(&map_b);
      for (int s = 0; s < T::kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4 * kWG);  // one arrival a consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
    for (int i = 0; i < first; ++i) produce(i);
  }
  __syncthreads();

  float acc[T::kNB][32];
#pragma unroll
  for (int nb = 0; nb < T::kNB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  if (producer) {
    for (int i = first; i < count; ++i) {
      mbar_wait(&empty[i % T::kStages], ((i / T::kStages) - 1) & 1);
      produce(i);
    }
  } else {
    // a consumer warpgroup: rows [64 wg, 64 wg + 64) of the tile
    const int wg = warp >> 2;
    for (int i = 0; i < count; ++i) {
      const int slot = i % T::kStages;
      mbar_wait(&full[slot], (i / T::kStages) & 1);
      __syncwarp();
      const uint32_t sa = smem_u32(ring + slot * T::kStageBytes);
      const uint32_t sb = sa + T::kABytes;
#pragma unroll
      for (int nb = 0; nb < T::kNB; ++nb) fence_acc(acc[nb]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // a k16 slice: 32 bytes along a K-major row, 16 rows down an M- or
        // N-major atom (past K the stage holds zeros)
        const uint64_t da = sw128_desc(sa + wg * kAtomBytes +
                                       kk * (kTransA ? 16 * 128 : 32));
#pragma unroll
        for (int nb = 0; nb < T::kNB; ++nb) {
          const uint64_t db = sw128_desc(sb + nb * kAtomBytes +
                                         kk * (kTransB ? 32 : 16 * 128));
          wgmma_m64n64k16<kTransA ? 1 : 0, kTransB ? 0 : 1>(acc[nb], da, db);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int nb = 0; nb < T::kNB; ++nb) fence_acc(acc[nb]);
      wgmma_wait<1>();  // the stage before is read: release its slot
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % T::kStages]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < T::kNB; ++nb) fence_acc(acc[nb]);
  }

  // lane l of warp w holds rows 16 w + l / 4 (+ 8) of the tile, columns
  // 64 nb + 8 j + 2 (l % 4) (+ 1)
  const int row0 = 16 * warp + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  if (kWG == 1 && kEpi != kGelu && splits == 1) {
    // a 64 x 64 tile whole in its block, no GELU: the epilogue straight
    // from the accumulators, a pair a store (measured faster there than
    // through shared memory; with GELU, or 128 x 128, slower)
    if (!producer) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + row0 + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + 8 * j + col0;
          if (col >= N) continue;
          const float v[2] = {acc[0][4 * j + 2 * h],
                              acc[0][4 * j + 2 * h + 1]};
          epilogue<kEpi, 2>(v, (size_t)row * N + col, out, residual, preact);
        }
      }
    }
    return;
  }

  // The partial tiles meet in the receive area after the ring: rank q of
  // S owns tile rows [q kM / S, (q + 1) kM / S), and each rank stores the
  // rows of its partial that rank q owns into q's receive area (slice
  // `split` of its [S][rows][kLd] floats; with S = 1 the whole tile into
  // its own). After a barrier (the cluster's, with S > 1) each rank adds
  // the S slices of its rows in rank order 0..S-1 and runs the epilogue, 8
  // columns a thread at a time (N is a multiple of 8, so 8 columns are
  // wholly in or out).
  cg::cluster_group cluster = cg::this_cluster();
  const int rows = (T::kM + splits - 1) / splits;  // a slice's row stride
  float* const recv = reinterpret_cast<float*>(ring + T::kRingBytes);
  if (splits > 1) cluster_wait();  // every rank has started: recv exists
  if (!producer) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const int owner = ((r + 1) * splits - 1) / T::kM;
      const int local = r - owner * T::kM / splits;
      float* const to =
          (splits > 1 ? cluster.map_shared_rank(recv, owner) : recv) +
          (split * rows + local) * T::kLd;
#pragma unroll
      for (int nb = 0; nb < T::kNB; ++nb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float2*>(to + 64 * nb + 8 * j + col0) =
              make_float2(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
        }
    }
  }
  if (splits > 1) {
    cluster.sync();  // every slice written; no rank reads another's after
  } else {
    __syncthreads();
  }
  const int r0 = split * T::kM / splits;
  const int r1 = (split + 1) * T::kM / splits;
  constexpr int kGroups = T::kN / 8;
  for (int g = (int)threadIdx.x; g < (r1 - r0) * kGroups;
       g += T::kThreads) {
    const int local = g / kGroups;
    const int c = (g % kGroups) * 8;
    const int row = m0 + r0 + local;
    const int col = n0 + c;
    if (row >= M || col >= N) continue;
    const float* from = recv + local * T::kLd + c;
    float4 lo = *reinterpret_cast<const float4*>(from);
    float4 hi = *reinterpret_cast<const float4*>(from + 4);
    for (int q = 1; q < splits; ++q) {
      const float* slice = from + q * rows * T::kLd;
      const float4 x = *reinterpret_cast<const float4*>(slice);
      const float4 y = *reinterpret_cast<const float4*>(slice + 4);
      lo.x += x.x;
      lo.y += x.y;
      lo.z += x.z;
      lo.w += x.w;
      hi.x += y.x;
      hi.y += y.y;
      hi.z += y.z;
      hi.w += y.w;
    }
    const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    epilogue<kEpi, 8>(v, (size_t)row * N + col, out, residual, preact);
  }
}

// -- kernel 2: the float32 product -------------------------------------------

// C [M][N] = op(A) op(B) in float32: kLanes lanes an output (a power of
// two up to 32, chosen from K); lane l of a group sums terms l, l + kLanes,
// ... with fmaf, and a butterfly of shuffles adds the group in a fixed
// order.
constexpr int kF32Threads = 256;

template <bool kTransA, bool kTransB, int kLanes>
__global__ void __launch_bounds__(kF32Threads) f32_product_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int M, int N, int K) {
  const int sub = (int)threadIdx.x & (kLanes - 1);
  const long long idx =
      ((long long)blockIdx.x * kF32Threads + threadIdx.x) / kLanes;
  const bool live = idx < (long long)M * N;
  float acc = 0.f;
  if (live) {
    const int m = (int)(idx / N);
    const int n = (int)(idx - (long long)m * N);
    auto term = [&](int k) {
      const float x = kTransA ? a[(size_t)k * M + m] : a[(size_t)m * K + k];
      const float y = kTransB ? b[(size_t)n * K + k] : b[(size_t)k * N + n];
      acc = fmaf(x, y, acc);
    };
    if (kLanes == 1) {
      for (int k = 0; k < K; ++k) term(k);
    } else {
#pragma unroll 8
      for (int k = sub; k < K; k += kLanes) term(k);
    }
  }
#pragma unroll
  for (int o = kLanes >> 1; o > 0; o >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  }
  if (live && sub == 0) out[idx] = acc;
}

template <int kLanes>
void launch_f32(const float* a, const float* b, float* out, int M, int N,
                int K, int layout, unsigned blocks, cudaStream_t s) {
  if (layout == kNT) {
    f32_product_kernel<false, true, kLanes>
        <<<blocks, kF32Threads, 0, s>>>(a, b, out, M, N, K);
  } else if (layout == kTN) {
    f32_product_kernel<true, false, kLanes>
        <<<blocks, kF32Threads, 0, s>>>(a, b, out, M, N, K);
  } else {
    f32_product_kernel<false, false, kLanes>
        <<<blocks, kF32Threads, 0, s>>>(a, b, out, M, N, K);
  }
}

// -- host side ---------------------------------------------------------------

// TMA takes a matrix whose rows are a multiple of 16 bytes apart.
bool tma_ok(int cols) { return cols % kChunk == 0; }

// The map of a row-major [rows][cols] bf16 matrix at base, boxes of
// box_rows rows of 64 values, 128-byte swizzled, zeros past its edges.
cudaError_t encode(CUtensorMap* map, const void* base, int rows, int cols,
                   int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Call {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  __nv_bfloat16* out;
  const __nv_bfloat16* residual;
  __nv_bfloat16* preact;
  int M, N, K, splits;
  cudaStream_t stream;
};

template <bool kTransA, bool kTransB, int kEpi, int kWG>
cudaError_t launch(const Call& c) {
  using T = Tile<kWG>;
  // A's rows: K values ([M][K]) or M ([K][M]); B's: N ([K][N]) or K
  const int a_cols = kTransA ? c.M : c.K;
  const int b_cols = kTransB ? c.K : c.N;
  const bool tma_a = tma_ok(a_cols);
  const bool tma_b = tma_ok(b_cols);
  CUtensorMap map_a, map_b;
  memset(&map_a, 0, sizeof(map_a));
  memset(&map_b, 0, sizeof(map_b));
  cudaError_t err = cudaSuccess;
  if (tma_a) {
    err = kTransA ? encode(&map_a, c.a, c.K, c.M, kAtom)
                  : encode(&map_a, c.a, c.M, c.K, T::kM);
    if (err != cudaSuccess) return err;
  }
  if (tma_b) {
    err = kTransB ? encode(&map_b, c.b, c.N, c.K, T::kN)
                  : encode(&map_b, c.b, c.K, c.N, kAtom);
    if (err != cudaSuccess) return err;
  }
  auto* fn = bf16_product_kernel<kTransA, kTransB, kEpi, kWG>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return err;
  const long long m_tiles = ((long long)c.M + T::kM - 1) / T::kM;
  const long long n_tiles = ((long long)c.N + T::kN - 1) / T::kN;
  if (m_tiles * c.splits > 0x7fffffffLL || n_tiles > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(m_tiles * c.splits), (unsigned)n_tiles);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = (size_t)T::kSmem;
  cfg.stream = c.stream;
  cfg.attrs = attr;
  cfg.numAttrs = c.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fn, map_a, map_b, c.a, c.b, c.out,
                            c.residual, c.preact, c.M, c.N, c.K, c.splits,
                            (int)tma_a, (int)tma_b);
}

template <int kWG>
cudaError_t launch_layout(const Call& c, int layout, int epilogue) {
  if (layout == kNT) return launch<false, true, kNone, kWG>(c);
  if (layout == kTN) return launch<true, false, kNone, kWG>(c);
  if (epilogue == kGelu) return launch<false, false, kGelu, kWG>(c);
  if (epilogue == kResidual) return launch<false, false, kResidual, kWG>(c);
  return launch<false, false, kNone, kWG>(c);
}

// The shapes both kernels take: M, N, K positive; the bf16 kernel also
// needs N a multiple of 8, so that 4 outputs of a row are wholly in or out
// and one 8-byte store.
bool bf16_shape_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % kChunk == 0;
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// (0 = launched). The Python wrapper (kernels/products.py) checks dtypes,
// shapes, contiguity and 16-byte alignment, and chooses the tile and the
// split; the checks here refuse what the kernels cannot take.

// out = op(a) op(b) (layout 0: a [M][K], b [K][N]; 1: a [M][K], b [N][K];
// 2: a [K][M], b [K][N]), bf16; epilogue 0 none, 1 GELU (preact, or null,
// gets the product), 2 the residual [M][N] added. Epilogues only with
// layout 0. tile: 64 (64 x 64 outputs a block, one warpgroup) or 128 (128 x
// 128, two); splits: the blocks (1 to 8, a cluster) that share K.
int chana_bf16_product(const void* a, const void* b, void* out,
                       const void* residual, void* preact, int M, int N,
                       int K, int layout, int epilogue, int tile, int splits,
                       void* stream) {
  if (!bf16_shape_ok(M, N, K) || layout < kNN || layout > kTN ||
      epilogue < kNone || epilogue > kResidual ||
      (epilogue != kNone && layout != kNN) ||
      (epilogue == kResidual) != (residual != nullptr) ||
      (preact != nullptr && epilogue != kGelu) ||
      (tile != 64 && tile != 128) || splits < 1 || splits > kMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  const Call c = {(const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
                  (__nv_bfloat16*)out,     (const __nv_bfloat16*)residual,
                  (__nv_bfloat16*)preact,  M,
                  N,                       K,
                  splits,                  (cudaStream_t)stream};
  const cudaError_t err = tile == 64 ? launch_layout<1>(c, layout, epilogue)
                                     : launch_layout<2>(c, layout, epilogue);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out = op(a) op(b) in float32, the same layouts.
int chana_f32_product(const void* a, const void* b, void* out, int M, int N,
                      int K, int layout, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || layout < kNN || layout > kTN) {
    return (int)cudaErrorInvalidValue;
  }
  // lanes an output: one under K = 64 (the gradients' K, 8 and the
  // batch: one short chain a thread), else 8 to 32, 8 terms a lane or more
  const int lanes = K < 64 ? 1 : K < 128 ? 8 : K < 256 ? 16 : 32;
  const long long blocks =
      ((long long)M * N * lanes + kF32Threads - 1) / kF32Threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const float*)a;
  const auto* pb = (const float*)b;
  auto* po = (float*)out;
  const unsigned g = (unsigned)blocks;
  if (lanes == 1) {
    launch_f32<1>(pa, pb, po, M, N, K, layout, g, s);
  } else if (lanes == 8) {
    launch_f32<8>(pa, pb, po, M, N, K, layout, g, s);
  } else if (lanes == 16) {
    launch_f32<16>(pa, pb, po, M, N, K, layout, g, s);
  } else {
    launch_f32<32>(pa, pb, po, M, N, K, layout, g, s);
  }
  return (int)cudaGetLastError();
}

const char* chana_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
