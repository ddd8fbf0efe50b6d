// The forecaster's matrix products for Hopper (sm_90a), forward and
// gradients: kernel 1 the bf16 products on the tensor cores, with the
// GELU and residual adds in their epilogue, kernel 2 the float32 head on
// the CUDA cores.
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
// same product in float32 on float32 operands, one fused multiply-add a
// term in k order, no TF32 (the reference's head is a float32 product).
//
// Layouts. The forward is (A, B): A [M][K], B [K][N] (the weights' [in,
// out] layout). dX = dY W^T is (A, B^T): B stored [N][K]. dW = X^T dY is
// (A^T, B): A stored [K][M], the sum over the rows of the batch. Each is a
// template instance of one kernel, the layout a pair of flags.
//
// What bounds them on this card. At the forecaster's shapes (T = 64,
// d_model 256, d_ff 1024, batch 1 to 32) a product does 2 K multiply-adds
// an output from at most K + N loads a row: 64 to 512 operations a byte
// at batch 32, around the ~295 at which the tensor cores and not the
// memory become the limit; at batch 1 (M = 64 rows) every product's bound
// (0.16 us for qkv, by bytes) lies under the ~1.7 us of an empty launch,
// so launch latency and parallelism set the time. The head is a
// [B, 256] x [256, 8] float32 product: a few hundred nanoseconds of work.
//
// What the design does about it. Kernel 1 fuses what the forward did in
// separate launches after the product (GELU, the two residual adds), so a
// forward makes 12 launches fewer and writes no unactivated or unsummed
// product to device memory. One block of four warps takes a 64 x 64
// output tile, each warp 32 x 32 as 2 x 4 mma.sync.m16n8k16 tiles; the K
// tiles (32 deep) are staged through a two-slot cp.async ring (16-byte
// copies, or a value at a time where a stored row's length is not a
// multiple of 8; zeros past the edges of M, N and K), so the next tile's
// copies are in flight while the tensor cores work on this one; the fragments
// are loaded with ldmatrix (.trans for an operand stored the other way),
// rows padded by 16 bytes so that its eight rows fall in distinct bank
// groups. mma.sync, not wgmma: 64-row tiles at M = 64 already leave most
// SMs idle, and right and simple comes first (attention_tiles.cuh's
// building blocks: cp_async, the fragment loaders, mma_bf16, round_bf16,
// pack_bf16). Kernel 2 is one output a thread, a plain FMA loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "gelu.cuh"

namespace {

using chana_att::cp_async;
using chana_att::cp_async_commit;
using chana_att::cp_async_wait;
using chana_att::load_a;
using chana_att::load_a_trans;
using chana_att::load_b_kn;
using chana_att::load_b_nk;
using chana_att::mma_bf16;
using chana_att::pack_bf16;
using chana_att::round_bf16;
using chana_att::unpack_bf16;

constexpr int kBM = 64;        // output rows a block
constexpr int kBN = 64;        // output columns a block
constexpr int kBK = 32;        // depth of a ring slot
constexpr int kWarpM = 32;     // output rows a warp (2 m16 tiles)
constexpr int kWarpN = 32;     // output columns a warp (4 n8 tiles)
constexpr int kThreads = 128;  // four warps, 2 x 2 over the block's tile
constexpr int kPad = 8;        // bf16 padding a shared-memory row (16 B)
constexpr int kChunk = 8;      // bf16 values a 16-byte copy

// the operands' layouts, as the Python wrapper names them
enum Layout { kNN = 0, kNT = 1, kTN = 2 };
enum Epilogue { kNone = 0, kGelu = 1, kResidual = 2 };

// A slot of one operand: `rows` x `cols` bf16 at `ld` apart. A is [kBM][kBK]
// as stored [M][K], [kBK][kBM] as stored [K][M]; B is [kBK][kBN] as stored
// [K][N], [kBN][kBK] as stored [N][K].
template <int kRows, int kCols>
struct Slot {
  static constexpr int rows = kRows;
  static constexpr int cols = kCols;
  static constexpr int ld = kCols + kPad;
  static constexpr int elems = kRows * ld;
};

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of a row-major
// [src_rows][src_cols] matrix into dst (ld apart), zeros where the tile
// passes the matrix's last row or column. When src_cols is a multiple of
// 8, each run of 8 values is one 16-byte cp.async, wholly in or wholly
// out. Otherwise (a ragged row: the embed's K, or its dW's M, is the
// feature count, 8 + 2 per tracked queue) the rows do not start on 16
// bytes, and each value is loaded alone and stored with its run. Every
// thread of the block takes part; the caller commits.
template <class S>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src,
                                      int src_rows, int src_cols, int r0,
                                      int c0) {
  constexpr int kPerRow = S::cols / kChunk;
  constexpr int kCopies = S::rows * kPerRow;
  static_assert(kCopies % kThreads == 0, "a slot is whole copies a thread");
  const bool whole = src_cols % kChunk == 0;
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kPerRow;
    const int c = (idx - r * kPerRow) * kChunk;
    const int row = r0 + r;
    const int col = c0 + c;
    __nv_bfloat16* d = dst + r * S::ld + c;
    if (whole && row < src_rows && col < src_cols) {
      cp_async(d, src + (size_t)row * src_cols + col, 16);
    } else if (whole || row >= src_rows) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else {
      const auto* from = reinterpret_cast<const unsigned short*>(src) +
                         (size_t)row * src_cols;
      uint32_t w[kChunk / 2];
#pragma unroll
      for (int e = 0; e < kChunk; e += 2) {
        const uint32_t lo = col + e < src_cols ? from[col + e] : 0u;
        const uint32_t hi = col + e + 1 < src_cols ? from[col + e + 1] : 0u;
        w[e / 2] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// C [M][N] = op(A) op(B), bf16 out, with the epilogue kEpi (kNN only):
// kGelu writes gelu(bf16(C)) and, when `preact` is not null, bf16(C) to
// it; kResidual writes bf16(residual + bf16(C)). One block a 64 x 64 tile:
// blockIdx.x over M, blockIdx.y over N.
template <bool kTransA, bool kTransB, int kEpi>
__global__ void __launch_bounds__(kThreads) bf16_product_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ residual,
    __nv_bfloat16* __restrict__ preact, int M, int N, int K) {
  using SA = Slot<kTransA ? kBK : kBM, kTransA ? kBM : kBK>;
  using SB = Slot<kTransB ? kBN : kBK, kTransB ? kBK : kBN>;
  __shared__ __align__(16) __nv_bfloat16 s_a[2][SA::elems];
  __shared__ __align__(16) __nv_bfloat16 s_b[2][SB::elems];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * kWarpM;  // the warp's rows in the tile
  const int wn = (warp & 1) * kWarpN;   // and its columns

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // K tile t into slot s: A's rows m0.. (or its rows t * kBK.. when it is
  // stored [K][M]), B's columns n0.. (or its rows n0.. when stored [N][K])
  auto issue = [&](int t, int s) {
    const int k0 = t * kBK;
    if (kTransA) {
      stage<SA>(s_a[s], a, K, M, k0, m0);
    } else {
      stage<SA>(s_a[s], a, M, K, m0, k0);
    }
    if (kTransB) {
      stage<SB>(s_b[s], b, N, K, n0, k0);
    } else {
      stage<SB>(s_b[s], b, K, N, k0, n0);
    }
    cp_async_commit();
  };

  const int tiles = (K + kBK - 1) / kBK;
  issue(0, 0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      issue(t + 1, (t + 1) & 1);  // into the slot the last tile is done with
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sa = s_a[t & 1];
    const __nv_bfloat16* sb = s_b[t & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[2][4], fb[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + 16 * i;
        if (kTransA) {
          load_a_trans(fa[i], sa + kk * SA::ld + r, SA::ld);
        } else {
          load_a(fa[i], sa + r * SA::ld + kk, SA::ld);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = wn + 16 * j;
        if (kTransB) {
          load_b_nk(fb[j], sb + c * SB::ld + kk, SB::ld);
        } else {
          load_b_kn(fb[j], sb + kk * SB::ld + c, SB::ld);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
          mma_bf16(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
        }
    }
    __syncthreads();  // the slot is refilled two tiles on
  }

  // the epilogue, straight from the C fragments: lane 4 g + c holds rows
  // g and g + 8 of each m16n8 tile at columns 2c and 2c + 1, a pair that
  // is one 4-byte store (N is a multiple of 8, so a pair is wholly in)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + 8 * j + c2;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + 16 * i + g + 8 * h;
        if (row >= M) continue;
        const size_t at = (size_t)row * N + col;
        const float v0 = round_bf16(acc[i][j][2 * h]);
        const float v1 = round_bf16(acc[i][j][2 * h + 1]);
        uint32_t word;
        if (kEpi == kGelu) {
          if (preact != nullptr) {
            *reinterpret_cast<uint32_t*>(preact + at) = pack_bf16(v0, v1);
          }
          word = pack_bf16(chana_gelu::gelu_tanh_f(v0),
                           chana_gelu::gelu_tanh_f(v1));
        } else if (kEpi == kResidual) {
          const float2 r =
              unpack_bf16(*reinterpret_cast<const uint32_t*>(residual + at));
          word = pack_bf16(r.x + v0, r.y + v1);
        } else {
          word = pack_bf16(v0, v1);
        }
        *reinterpret_cast<uint32_t*>(out + at) = word;
      }
    }
}

// C [M][N] = op(A) op(B) in float32: one output a thread, its K terms
// fused multiply-added in k order.
constexpr int kF32Threads = 256;

template <bool kTransA, bool kTransB>
__global__ void __launch_bounds__(kF32Threads) f32_product_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int M, int N, int K) {
  const long long idx = (long long)blockIdx.x * kF32Threads + threadIdx.x;
  if (idx >= (long long)M * N) return;
  const int m = (int)(idx / N);
  const int n = (int)(idx - (long long)m * N);
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    const float x = kTransA ? a[(size_t)k * M + m] : a[(size_t)m * K + k];
    const float y = kTransB ? b[(size_t)n * K + k] : b[(size_t)k * N + n];
    acc = fmaf(x, y, acc);
  }
  out[idx] = acc;
}

// The shapes both kernels take: M, N, K positive; the bf16 kernel also
// needs N a multiple of 8, so that each output pair is one 4-byte store
// and B's rows, stored [K][N], are whole 16-byte copies.
bool bf16_shape_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % kChunk == 0;
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// (0 = launched). The Python wrapper (kernels/products.py) checks dtypes,
// shapes, contiguity and 16-byte alignment; the checks here refuse what
// the kernels cannot take.

// out = op(a) op(b) (layout 0: a [M][K], b [K][N]; 1: a [M][K], b [N][K];
// 2: a [K][M], b [K][N]), bf16; epilogue 0 none, 1 GELU (preact, or null,
// gets the product), 2 the residual [M][N] added. Epilogues only with
// layout 0.
int chana_bf16_product(const void* a, const void* b, void* out,
                       const void* residual, void* preact, int M, int N,
                       int K, int layout, int epilogue, void* stream) {
  if (!bf16_shape_ok(M, N, K) || layout < kNN || layout > kTN ||
      epilogue < kNone || epilogue > kResidual ||
      (epilogue != kNone && layout != kNN) ||
      (epilogue == kResidual) != (residual != nullptr) ||
      (preact != nullptr && epilogue != kGelu)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long m_tiles = ((long long)M + kBM - 1) / kBM;
  const long long n_tiles = ((long long)N + kBN - 1) / kBN;
  if (m_tiles > 0x7fffffffLL || n_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)m_tiles, (unsigned)n_tiles);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const __nv_bfloat16*)a;
  const auto* pb = (const __nv_bfloat16*)b;
  auto* po = (__nv_bfloat16*)out;
  const auto* pr = (const __nv_bfloat16*)residual;
  auto* pp = (__nv_bfloat16*)preact;
  if (layout == kNT) {
    bf16_product_kernel<false, true, kNone>
        <<<grid, kThreads, 0, s>>>(pa, pb, po, pr, pp, M, N, K);
  } else if (layout == kTN) {
    bf16_product_kernel<true, false, kNone>
        <<<grid, kThreads, 0, s>>>(pa, pb, po, pr, pp, M, N, K);
  } else if (epilogue == kGelu) {
    bf16_product_kernel<false, false, kGelu>
        <<<grid, kThreads, 0, s>>>(pa, pb, po, pr, pp, M, N, K);
  } else if (epilogue == kResidual) {
    bf16_product_kernel<false, false, kResidual>
        <<<grid, kThreads, 0, s>>>(pa, pb, po, pr, pp, M, N, K);
  } else {
    bf16_product_kernel<false, false, kNone>
        <<<grid, kThreads, 0, s>>>(pa, pb, po, pr, pp, M, N, K);
  }
  return (int)cudaGetLastError();
}

// out = op(a) op(b) in float32, the same layouts.
int chana_f32_product(const void* a, const void* b, void* out, int M, int N,
                      int K, int layout, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || layout < kNN || layout > kTN) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks =
      ((long long)M * N + kF32Threads - 1) / kF32Threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* pa = (const float*)a;
  const auto* pb = (const float*)b;
  auto* po = (float*)out;
  if (layout == kNT) {
    f32_product_kernel<false, true>
        <<<(unsigned)blocks, kF32Threads, 0, s>>>(pa, pb, po, M, N, K);
  } else if (layout == kTN) {
    f32_product_kernel<true, false>
        <<<(unsigned)blocks, kF32Threads, 0, s>>>(pa, pb, po, M, N, K);
  } else {
    f32_product_kernel<false, false>
        <<<(unsigned)blocks, kF32Threads, 0, s>>>(pa, pb, po, M, N, K);
  }
  return (int)cudaGetLastError();
}

const char* chana_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
